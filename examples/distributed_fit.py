"""Distributed exact-GP fitting over a device mesh — 1-D, 2-D, and hybrid
multi-slice layouts on 8 devices (real chips or XLA's virtual CPU devices).

The Gram/Cholesky never materialize on one chip: rows (1-D), P(i, j) tiles
(2-D, auto-selected on 2-D meshes), or modes x tiles (hybrid 3-axis) —
see docs/architecture.md and gpras_tpu/parallel/.

Run: ``python examples/distributed_fit.py`` (forces 8 virtual CPU devices
when fewer than 8 real devices exist).
"""

from __future__ import annotations


def main(verbose: bool = True, b: int = 16, steps: int = 5):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from gpras_tpu.gp import exact
    from gpras_tpu.parallel import make_mesh
    from gpras_tpu.parallel.hybrid import make_hybrid_fit_step
    from gpras_tpu.parallel.pexact import make_dist_fit_step, resolve_layout

    n = 8 * b * 2  # divides every mesh axis used below
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.1)

    # 2-D P(i, j) model-parallel fit (layout="auto" picks 2-D on this mesh)
    mesh2 = make_mesh((4, 2), ("i", "j"))
    assert resolve_layout(mesh2) == "2d"
    init, step = make_dist_fit_step(mesh2, "Matern52", b=b, learning_rate=0.05)
    opt = init(params)
    p2 = params
    for i in range(steps):
        p2, opt, loss = step(p2, opt, x, y)
    if verbose:
        print(f"2-D P(i,j) mesh (4,2): loss after {steps} steps = "
              f"{float(loss):.3f}")

    # hybrid: 4 independent EOF-mode GPs sharded over "dp", each mode's Gram
    # 2-D tiled within its host group — the multi-host layout
    mesh3 = make_mesh((2, 2, 2), ("dp", "i", "j"))
    p_modes = 4
    y_modes = jnp.asarray(
        np.stack([np.sin(np.asarray(x)[:, 0] * (i + 1))
                  for i in range(p_modes)], axis=1), jnp.float32)
    params_b = jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (p_modes,) + leaf.shape), params)
    init_h, step_h = make_hybrid_fit_step(mesh3, "Matern52", b=b, probes=8,
                                          learning_rate=0.05)
    opt_h = init_h(params_b)
    key = jax.random.PRNGKey(0)
    for i in range(steps):
        params_b, opt_h, losses, key = step_h(params_b, opt_h, x, y_modes,
                                              key)
    if verbose:
        print(f"hybrid (dp,i,j)=(2,2,2): per-mode losses after {steps} "
              "steps =", np.round(np.asarray(losses), 2))
    return float(loss), np.asarray(losses)


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))  # repo root, when not pip-installed
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    import jax

    if not os.environ.get("GPRAS_EXAMPLE_REAL_DEVICES"):
        jax.config.update("jax_platforms", "cpu")
    main()

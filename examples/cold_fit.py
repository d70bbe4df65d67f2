"""Cold exact-GP fit from standard init: `gp.coldfit.fit_exact`.

When no converged target exists to warm-start into (a new basin, a new
kernel, a new feature set), zoom-linesearch L-BFGS is the faster cold
protocol than fixed-lr Adam: at N=49,152 it enters the 600-step Adam
convergence band in 23 iterations. The engine is picked by size —
Hutchinson stochastic-trace while the (N, N) Gram fits the device,
matrix-free BBMM CG+SLQ above, run HONESTLY (preconditioned 256-iteration
budget with bit-identical early exit, solver-validity gate, projection
gate-abort, and the ``stop_decrease`` noise-plateau stop).

This example runs the same call at a toy size so it finishes in seconds
anywhere, then predicts with the fitted hyperparameters.

Run: ``python examples/cold_fit.py`` (CPU or GPU).
"""

from __future__ import annotations

import time


def main(n: int = 2048, d: int = 4, max_iter: int = 24, chunk: int = 8,
         verbose: bool = True):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpras_tpu.gp import exact
    from gpras_tpu.gp.coldfit import fit_exact

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(k1, (n, d), dtype=jnp.float32)
    f = jnp.sin(2.0 * x[:, 0]) + 0.5 * jnp.cos(x[:, 1])
    y = f + 0.05 * jax.random.normal(k2, (n,), dtype=jnp.float32)

    t0 = time.perf_counter()
    params, info = fit_exact(
        "Matern52", x, y, max_iter=max_iter, chunk=chunk,
        progress=(lambda done, best:
                  print(f"  iter {done:3d}  best loss {best:.2f}"))
        if verbose else None)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"engine={info['engine']}  stopped_by={info['stopped_by']}  "
              f"iterations={int(info['iterations'])}  {dt:.1f}s")
        print(f"fitted noise std: "
              f"{float(jnp.exp(0.5 * params['log_noise_variance'])):.4f} "
              f"(generating: 0.05)")

    # posterior at held-out points with the fitted hyperparameters
    xq = jax.random.normal(k3, (512, d), dtype=jnp.float32)
    fq = jnp.sin(2.0 * xq[:, 0]) + 0.5 * jnp.cos(xq[:, 1])
    mean, var = exact.predict("Matern52", params, x, y, xq)
    rmse = float(jnp.sqrt(jnp.mean((mean - fq) ** 2)))
    inside = np.mean(np.abs(np.asarray(mean - fq))
                     <= 2.0 * np.sqrt(np.asarray(var)))
    if verbose:
        print(f"held-out RMSE {rmse:.4f}; 2-sigma coverage {inside:.3f}")
    return rmse, float(inside), info


if __name__ == "__main__":
    main()

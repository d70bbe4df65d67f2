"""Data-parallel SVGP minibatch training over a device mesh.

The SVGP bound (gp/svgp.py) decomposes over data points, so scaling the
minibatch across chips is pure data parallelism: shard the global batch over
a mesh axis, replicate the O(M^2) params, and let the SPMD partitioner insert
the one ``psum`` behind the batch-reduction — no hand-written collectives
(the scaling-book recipe: annotate shardings, let XLA place the
collectives). Each step's communication is just the gradient reduction of the
O(M^2 + M D) parameter pytree, so the efficiency floor is set by
``global_batch / n_devices`` keeping the per-device (M, B_local) matmuls
large.

This is the multi-chip answer for datasets too large even for the
matrix-free CG engine's single-chip ceiling: SVGP never materializes
anything N-shaped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpras_tpu.gp import svgp

Array = jax.Array


def shard_batch(mesh: Mesh, xb: Array, yb: Array, axis: str = "dp"):
    """Place a global batch on the mesh, rows sharded over ``axis``.

    The global batch size must divide by the axis size (static shapes)."""
    ndev = mesh.shape[axis]
    if xb.shape[0] % ndev:
        raise ValueError(
            f"global batch {xb.shape[0]} not divisible by mesh axis "
            f"{axis!r} size {ndev}")
    xs = jax.device_put(xb, NamedSharding(mesh, P(axis)))
    ys = jax.device_put(yb, NamedSharding(mesh, P(axis)))
    return xs, ys


def make_dp_minibatch_step(mesh: Mesh, kernel: str, n_total: int,
                           learning_rate: float = 0.01, optimizer=None,
                           axis: str = "dp"):
    """(init, step) for one data-parallel SVGP Adam step.

    ``step(params, opt_state, x_batch, y_batch) -> (params, opt_state, loss)``
    with the batch sharded over ``axis`` (see :func:`shard_batch`) and params
    replicated. The loss/gradient are computed as ONE global program —
    jit over the mesh with sharding constraints, identical math to the
    single-device :func:`gpras_tpu.gp.svgp.training_loss` (tested to agree),
    with the batch reduction's psum inserted by the partitioner.
    """
    import optax

    opt = optax.adam(learning_rate) if optimizer is None else optimizer
    repl = NamedSharding(mesh, P())

    def init(params):
        params = jax.device_put(params, jax.tree.map(lambda _: repl, params))
        return opt.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        loss, g = jax.value_and_grad(
            lambda p: svgp.training_loss(kernel, p, xb, yb, n_total))(params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = jax.lax.with_sharding_constraint(
            params, jax.tree.map(lambda _: repl, params))
        return params, opt_state, loss

    return init, step


def dp_minibatch_fit(mesh: Mesh, kernel: str, params: dict[str, Array],
                     x: np.ndarray, y: np.ndarray, *, batch_size: int,
                     epochs: int, learning_rate: float = 0.01,
                     axis: str = "dp", seed: int = 0):
    """Host-orchestrated data-parallel SVGP fit over full arrays.

    Shuffles on the host each epoch (the dataset may be far larger than any
    chip), streams global batches onto the mesh, and applies
    :func:`make_dp_minibatch_step`. Returns ``(params, epoch_mean_losses)``.

    For single-chip or data-fits-on-device cases prefer the fully-fused
    :func:`gpras_tpu.gp.svgp.make_minibatch_fit` (one dispatch total).
    """
    n = x.shape[0]
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    init, step = make_dp_minibatch_step(
        mesh, kernel, n_total=n, learning_rate=learning_rate, axis=axis)
    opt_state = init(params)
    rng = np.random.default_rng(seed)
    hist = []
    for _ in range(epochs):
        perm = rng.permutation(n)[: nb * batch_size]
        losses = []
        for i in range(nb):
            sl = perm[i * batch_size:(i + 1) * batch_size]
            xb, yb = shard_batch(mesh, jnp.asarray(x[sl]), jnp.asarray(y[sl]),
                                 axis)
            params, opt_state, loss = step(params, opt_state, xb, yb)
            losses.append(loss)
        hist.append(float(jnp.mean(jnp.stack(losses))))
    return params, np.asarray(hist)

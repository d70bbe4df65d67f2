"""Event-sharded batched posterior prediction over a device mesh.

The serving surface (gp/serving.py) batches thousands of storm-event
timesteps through the cached-factor posterior on one device; this module
shards the QUERY axis across the mesh — each device evaluates the full
multi-mode posterior for its slice of events against replicated factors.
Zero collectives (the computation is embarrassingly event-parallel), so
throughput scales linearly with the mesh.

Reference capability anchor: the per-mode, per-event serial predict loop
(gpras/gpr.py:336-339); SURVEY.md §2.2's "event-batched posterior
prediction" checklist item.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def sharded_predict(mesh: Mesh, model, x_query, axis: str = "i"):
    """Multi-mode posterior (means, variances), query rows sharded over
    ``axis``; ``model`` is a fitted GPRAS (factors replicated on every
    device). Returns (S, P) arrays like ``GPRAS.predict``.

    The query count must be divisible by the mesh axis size (pad with
    arbitrary rows and slice, as gp/serving.py's bucketing does).
    """
    from gpras_tpu.gp.model import (_exact_predict_from_cache,
                                    _sgpr_predict_from_cache)

    model._ensure_cache()
    xq = jnp.asarray(x_query, dtype=model.dtype)
    s = xq.shape[0]
    d = mesh.shape[axis]
    if s % d != 0:
        raise ValueError(f"query count {s} not divisible by mesh axis {d}")
    kernel = model.kernel_str
    params, cache = model.params, model._cache

    if model.model_type == "sgpr":
        def local(xq_local):
            return jax.vmap(
                lambda p, c: _sgpr_predict_from_cache(kernel, p, c, xq_local)
            )(params, cache)
    elif model._matrix_free:
        # alpha-only cache: each device runs the matrix-free posterior
        # (streamed cross-Gram mean + chunked CG variance) on its slice
        from gpras_tpu.gp.exact_cg import cg_predict

        x_train, y_train = model.x, model.y
        alphas, l_pcs = cache

        def local(xq_local):
            m, v = jax.vmap(
                lambda p, a, l_pc, y_i: cg_predict(kernel, p, x_train, y_i,
                                                   xq_local, alpha=a, l_pc=l_pc),
                in_axes=(0, 0, 0, 1),
            )(params, alphas, l_pcs, y_train)
            return m, v
    else:
        x_train = model.x

        def local(xq_local):
            return jax.vmap(
                lambda p, c: _exact_predict_from_cache(kernel, p, c, x_train,
                                                       xq_local)
            )(params, cache)

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(axis),
                       out_specs=(P(None, axis), P(None, axis)))
    xq = jax.device_put(xq, NamedSharding(mesh, P(axis)))
    mean, var = fn(xq)
    return mean.T, var.T

"""Sharded Gram-matrix builds over a device mesh.

Two layouts:
- ``pgram_rows``: K sharded by row blocks over a 1-D mesh ("i") — the layout the
  distributed Cholesky consumes. Zero communication: each device evaluates
  k(x_rows, x) for its row strip (x itself is small, (N, D), and replicated).
- ``pgram_2d``: K sharded (i, j) over a 2-D mesh — the fully 2-D sharded
  Gram of BASELINE.json configs[4]; each device computes its (N/di, N/dj) tile
  from its row and column slices of x.

Kernel params are passed as explicit shard_map operands (replicated specs), so
these compose with jit/grad without closure-capture restrictions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gpras_tpu.ops import kernels as K

Array = jax.Array


def _replicated_like(tree):
    return jax.tree.map(lambda _: P(), tree)


def pgram_rows(mesh: Mesh, kernel: str, params: dict[str, Array], x: Array,
               noise: Array | None = None, axis: str = "i") -> Array:
    """K(x, x) (+ noise * I) sharded by rows over ``axis``; communication-free."""
    n = x.shape[0]
    d = mesh.shape[axis]
    if n % d != 0:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={d}")
    nr = n // d
    noise_arr = jnp.zeros(()) if noise is None else jnp.asarray(noise)

    def body(p, x_rows, x_full, nz):
        k_local = K.gram(kernel, p, x_rows, x_full)  # (nr, N)
        me = jax.lax.axis_index(axis)
        cols = me * nr + jnp.arange(nr)
        k_local = k_local.at[jnp.arange(nr), cols].add(
            jnp.asarray(nz, k_local.dtype))
        return k_local

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(_replicated_like(params), P(axis, None), P(None, None), P()),
        out_specs=P(axis, None))
    return fn(params, x, x, noise_arr)


def pgram_2d(mesh: Mesh, kernel: str, params: dict[str, Array], x: Array,
             noise: Array | None = None,
             axes: tuple[str, str] = ("i", "j")) -> Array:
    """K(x, x) (+ noise * I) sharded over a 2-D mesh: device (a, b) computes
    the tile k(x_rows_a, x_cols_b). Communication-free given replicated x;
    the noise diagonal is added inside whichever tiles the global diagonal
    crosses."""
    ai, aj = axes
    n = x.shape[0]
    di, dj = mesh.shape[ai], mesh.shape[aj]
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by both mesh axes ({di}, {dj})")
    nr, nc = n // di, n // dj
    noise_arr = jnp.zeros(()) if noise is None else jnp.asarray(noise)

    def body(p, x_rows, x_cols, nz):
        k_local = K.gram(kernel, p, x_rows, x_cols)  # (nr, nc)
        gr = jax.lax.axis_index(ai) * nr + jnp.arange(nr)[:, None]
        gc = jax.lax.axis_index(aj) * nc + jnp.arange(nc)[None, :]
        return jnp.where(gr == gc, k_local + jnp.asarray(nz, k_local.dtype),
                         k_local)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(_replicated_like(params), P(ai, None), P(aj, None), P()),
        out_specs=P(ai, aj))
    return fn(params, x, x, noise_arr)

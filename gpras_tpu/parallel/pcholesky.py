"""Distributed blocked Cholesky + triangular solves over a device mesh.

The scalability story for exact GPs at N >= 100k (BASELINE.json
configs[4]); the reference's only scalability lever is the sparse inducing-point
approximation (SGPR, gpras/gpr.py:299). No reference counterpart exists — this is
a greenfield component (SURVEY.md section 2.2).

Design (right-looking, row-block layout, ``shard_map`` over mesh axis "i"):

- K is sharded by contiguous **row blocks**: each of d devices owns an
  (N/d, N) strip. The Gram build is then embarrassingly parallel: a device
  computes k(x_rows, x) for its rows only (``pgram_rows``) — no communication.
- Panel step kb (width b): the owner broadcasts its b panel rows via a masked
  ``psum`` (zeros elsewhere — a broadcast without a dedicated primitive); every
  device redundantly factorizes the b x b diagonal block; each device forms its
  rows of the panel column with one TRSM; one ``all_gather`` of the (N/d, b)
  column blocks gives the full (N, b) panel; the trailing update is a single
  full-width masked matmul per device.
- Static shapes throughout: the trailing region is selected by index masks, not
  dynamic widths, so each step runs the same (N/d, b) @ (b, N) matmul. This
  costs ~3x the minimal trailing-update FLOPs in exchange for one fused,
  compiler-friendly kernel per step; per-device compute is O(N^3 / d).
- Communication per factorization: nb * (b*N psum + N*b gather) = O(N^2) words
  between devices, fully overlappable with the trailing matmuls by XLA's scheduler.

All functions are differentiable (fori_loop with static trip count + collective
ops with defined transposes), so the distributed NLML can be used directly under
``jax.grad`` for multi-chip hyperparameter training.

Why 1-D (row-strip) rather than 2-D block-cyclic: at the mesh sizes this
framework targets (one host's devices, or a few hosts) the trailing update — the only
O(N^3) term — is already perfectly parallel under row sharding
(O(N^3 / (3 d)) per device), and the per-step panel all_gather is O(N b)
regardless of layout. A 2-D block-cyclic layout only starts to pay when the
panel broadcast dominates (hundreds of devices); for the N >= 100k axis the
matrix-free row-sharded CG engine (parallel/pcg.py) is the better algorithm
anyway — no O(N^2/d) residency at all.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gpras_tpu.ops import kernels as K

Array = jax.Array


def _owner(g0: int | Array, nr: int) -> Array:
    return g0 // nr


def _i32(v):
    return jnp.asarray(v, jnp.int32)


def _dslice(arr, starts, sizes):
    return jax.lax.dynamic_slice(arr, tuple(_i32(s) for s in starts), sizes)


def _dupdate(arr, update, starts):
    return jax.lax.dynamic_update_slice(arr, update, tuple(_i32(s) for s in starts))


def dist_cholesky_local(k_local: Array, b: int, axis: str = "i",
                        precision: str | None = None) -> Array:
    """Body run per-device under shard_map: k_local is this device's (nr, N)
    row strip of the SPD matrix; returns its strip of the lower factor.

    The trailing update runs at ``precision`` (None: the package policy,
    f32-equivalent — a 1-pass low-precision product NaNs blocked
    factorizations at cond(K) ~1e4); panel TRSMs use XLA triangular_solve,
    which is backward-stable (~3e-7 residual in f32)."""
    nr, n = k_local.shape
    nb = n // b
    me = jax.lax.axis_index(axis)
    r0 = me * nr
    gidx = r0 + jnp.arange(nr)  # global row ids of local rows

    def step(kb, k_loc):
        g0 = kb * b
        owner = _owner(g0, nr)
        loc_off = jnp.clip(g0 - owner * nr, 0, nr - b)
        # broadcast the owner's panel rows (b, N) to everyone
        panel_rows = _dslice(k_loc, (loc_off, 0), (b, n))
        panel = jax.lax.psum(
            jnp.where(me == owner, panel_rows, jnp.zeros_like(panel_rows)), axis)
        a_kk = _dslice(panel, (0, g0), (b, b))
        l_kk = jnp.linalg.cholesky(a_kk)  # redundant on all devices (b x b)

        # local rows of the panel column: C = K[:, g0:g0+b]; L = C L_kk^-T
        c_local = _dslice(k_loc, (0, g0), (nr, b))
        l_below = jax.scipy.linalg.solve_triangular(
            l_kk, c_local.T, lower=True).T  # (nr, b)
        below = (gidx >= g0 + b)[:, None]
        in_panel = ((gidx >= g0) & (gidx < g0 + b))[:, None]
        # owner's panel rows take L_kk; rows below take the TRSM result
        l_kk_rows = _dupdate(jnp.zeros((nr, b), k_loc.dtype), l_kk, (loc_off, 0))
        new_col = jnp.where(below, l_below,
                            jnp.where(in_panel, l_kk_rows, c_local))
        k_loc = _dupdate(k_loc, new_col, (0, g0))

        # full panel column (N, b), rows at/above the panel zeroed
        col_masked = jnp.where(below, new_col, 0.0)
        col_full = jax.lax.all_gather(col_masked, axis, axis=0, tiled=True)
        # masked full-width trailing update: columns < g0+b see only zeros
        update = jnp.matmul(col_masked, col_full.T, precision=precision,
                            preferred_element_type=k_loc.dtype)
        return k_loc - update

    k_done = jax.lax.fori_loop(0, nb, step, k_local, unroll=False)
    col_ids = jnp.arange(n)[None, :]
    return jnp.where(col_ids <= gidx[:, None], k_done, 0.0)


def dist_solve_lower_local(l_local: Array, rhs: Array, b: int, axis: str = "i") -> Array:
    """Forward substitution L y = rhs with L row-sharded; rhs/result replicated
    (N, m). Solves are O(N^2) — computed redundantly, only the panel rows are
    communicated."""
    nr, n = l_local.shape
    m = rhs.shape[1]
    nb = n // b
    me = jax.lax.axis_index(axis)

    def step(kb, y):
        g0 = kb * b
        owner = _owner(g0, nr)
        loc_off = jnp.clip(g0 - owner * nr, 0, nr - b)
        panel_rows = _dslice(l_local, (loc_off, 0), (b, n))
        panel = jax.lax.psum(
            jnp.where(me == owner, panel_rows, jnp.zeros_like(panel_rows)), axis)
        l_kk = _dslice(panel, (0, g0), (b, b))
        # contribution of already-solved rows (< g0): mask columns
        panel_left = jnp.where(jnp.arange(n)[None, :] < g0, panel, 0.0)
        rhs_panel = _dslice(rhs, (g0, 0), (b, m))
        # (b, m); y rows >= g0 are still zero
        corr = jnp.matmul(panel_left, y, preferred_element_type=y.dtype)
        y_kb = jax.scipy.linalg.solve_triangular(l_kk, rhs_panel - corr, lower=True)
        return _dupdate(y, y_kb, (g0, 0))

    y0 = jnp.zeros_like(rhs)
    return jax.lax.fori_loop(0, nb, step, y0, unroll=False)


def dist_solve_upper_local(l_local: Array, rhs: Array, b: int, axis: str = "i") -> Array:
    """Backward substitution L^T x = rhs with L row-sharded; rhs/result
    replicated (N, m). The panel-column blocks of L (rows below the panel) are
    distributed, so the correction term is a local matmul + psum."""
    nr, n = l_local.shape
    m = rhs.shape[1]
    nb = n // b
    me = jax.lax.axis_index(axis)
    r0 = me * nr
    gidx = r0 + jnp.arange(nr)

    def step(t, x):
        kb = nb - 1 - t
        g0 = kb * b
        owner = _owner(g0, nr)
        loc_off = jnp.clip(g0 - owner * nr, 0, nr - b)
        panel_rows = _dslice(l_local, (loc_off, 0), (b, n))
        panel = jax.lax.psum(
            jnp.where(me == owner, panel_rows, jnp.zeros_like(panel_rows)), axis)
        l_kk = _dslice(panel, (0, g0), (b, b))
        # correction: L[below, panel]^T @ x[below]  (distributed over rows)
        col_local = _dslice(l_local, (0, g0), (nr, b))
        col_below = jnp.where((gidx >= g0 + b)[:, None], col_local, 0.0)
        x_local = _dslice(x, (r0, 0), (nr, m))
        corr = jax.lax.psum(
            jnp.matmul(col_below.T, x_local, preferred_element_type=x.dtype), axis)  # (b, m)
        rhs_panel = _dslice(rhs, (g0, 0), (b, m))
        x_kb = jax.scipy.linalg.solve_triangular(
            l_kk, rhs_panel - corr, lower=True, trans=1)
        return _dupdate(x, x_kb, (g0, 0))

    x0 = jnp.zeros_like(rhs)
    return jax.lax.fori_loop(0, nb, step, x0, unroll=False)


# ---------------------------------------------------------------------------
# mesh-level wrappers
# ---------------------------------------------------------------------------

def dist_cholesky(mesh: Mesh, k: Array, b: int = 128, axis: str = "i") -> Array:
    """Lower Cholesky factor of SPD ``k`` (N, N), computed with K sharded by row
    blocks over ``mesh`` axis ``axis``. N must divide evenly by b and by the
    axis size, and b must divide N/d."""
    n = k.shape[0]
    d = mesh.shape[axis]
    _check_divisible(n, d, b)
    fn = shard_map(
        partial(dist_cholesky_local, b=b, axis=axis),
        mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None))
    return fn(k)


def dist_cho_solve(mesh: Mesh, l: Array, rhs: Array, b: int = 128,
                   axis: str = "i") -> Array:
    """(L L^T)^{-1} rhs with the factor row-sharded and rhs replicated."""
    n = l.shape[0]
    d = mesh.shape[axis]
    _check_divisible(n, d, b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs

    def body(l_local, r):
        y = dist_solve_lower_local(l_local, r, b=b, axis=axis)
        return dist_solve_upper_local(l_local, y, b=b, axis=axis)

    fn = shard_map(body, mesh=mesh, in_specs=(P(axis, None), P(None, None)),
                   out_specs=P(None, None))
    out = fn(l, rhs2)
    return out[:, 0] if rhs.ndim == 1 else out


def dist_logdet_from_chol(mesh: Mesh, l: Array, axis: str = "i") -> Array:
    """log det(K) = 2 sum log diag(L), diag gathered shard-wise with one psum."""

    def body(l_local):
        nr = l_local.shape[0]
        me = jax.lax.axis_index(axis)
        cols = me * nr + jnp.arange(nr)
        diag = l_local[jnp.arange(nr), cols]
        return jax.lax.psum(jnp.sum(jnp.log(diag)), axis)[None]

    fn = shard_map(body, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis))
    return 2.0 * fn(l)[0]


def _check_divisible(n: int, d: int, b: int) -> None:
    if n % d != 0:
        raise ValueError(f"N={n} must be divisible by the mesh axis size {d}")
    nr = n // d
    # b must divide the PER-DEVICE row count: the panel slices are (b, n)
    # windows of the local (nr, n) strip, so b > nr cannot work (it used to
    # slip through via a b % nr escape hatch and crash opaquely at trace)
    if nr % b != 0:
        raise ValueError(f"block size {b} must divide local rows {nr} "
                         f"(N={n} over {d} devices)")

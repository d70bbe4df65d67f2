"""Distributed Cholesky + triangular solves with K sharded 2-D over a mesh.

The fully 2-D layout of BASELINE.json configs[4] ("the Gram matrix shards 2-D
over the interconnect"): device (a, b) of a (di, dj) mesh owns the contiguous
(N/di, N/dj) tile K[a*nr:(a+1)*nr, b*nc:(b+1)*nc], exactly the layout
``pgram.pgram_2d`` produces communication-free. No reference counterpart
exists (greenfield, SURVEY.md section 2.2); the 1-D row-strip engine lives in
``pcholesky.py``.

Right-looking blocked algorithm, one step per b-wide global panel:

1. the owner device *column* broadcasts its (nr, b) slice of the panel along
   mesh axis "j" (masked psum);
2. the owner device *row* broadcasts the (b, b) diagonal block along "i";
   every device factorizes it redundantly (b x b);
3. every device TRSMs its rows of the panel column; the owner column writes
   the result back;
4. one ``all_gather`` along "i" assembles the full (N, b) panel; each device
   takes the contiguous (nc, b) slice matching its global *columns* and
   applies the masked full-width trailing update
   ``tile -= panel_rows @ panel_cols^T`` — a single static-shape matmul.

Per-step communication: the "j" broadcast moves (N/di)*b words, the "i"
gather N*b — vs the 1-D engine's b*N broadcast + N*b gather. The trailing
update is (nr, b) @ (b, nc): identical total FLOPs to 1-D (N^3/d), but the
operands shrink as 1/di and 1/dj separately, so per-device arithmetic
intensity and panel-broadcast volume scale with the mesh's 2-D shape instead
of its flat size. Like the 1-D engine, the masked full-width update trades
~3x the minimal trailing FLOPs for static shapes and flat compile cost.

All functions are differentiable (fori_loop + collectives with defined
transposes) and run under ``shard_map`` with ``P("i", "j")`` tiles.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


Array = jax.Array


def _i32(v):
    return jnp.asarray(v, jnp.int32)


def _dslice(arr, starts, sizes):
    return jax.lax.dynamic_slice(arr, tuple(_i32(s) for s in starts), sizes)


def _dupdate(arr, update, starts):
    return jax.lax.dynamic_update_slice(arr, update, tuple(_i32(s) for s in starts))


def _bcast(value: Array, is_owner: Array, axes) -> Array:
    """Broadcast ``value`` from the device(s) where ``is_owner`` over ``axes``
    — a masked psum (zeros elsewhere)."""
    return jax.lax.psum(jnp.where(is_owner, value, jnp.zeros_like(value)), axes)


def dist_cholesky_2d_local(k_local: Array, b: int,
                           axes: tuple[str, str] = ("i", "j"),
                           precision: str | None = None) -> Array:
    """Per-device body: ``k_local`` is this device's (nr, nc) contiguous tile
    of the SPD matrix; returns its tile of the lower factor (upper zeroed)."""
    ai, aj = axes
    nr, nc = k_local.shape
    di = jax.lax.axis_size(ai)
    dj = jax.lax.axis_size(aj)
    n = nr * di
    assert nc * dj == n, (nr, nc, di, dj)
    nb = n // b
    mi = jax.lax.axis_index(ai)
    mj = jax.lax.axis_index(aj)
    gidx_r = mi * nr + jnp.arange(nr)  # global row ids of local rows

    def step(kb, k_loc):
        g0 = kb * b
        owner_i = g0 // nr
        owner_j = g0 // nc
        loc_r = jnp.clip(g0 - owner_i * nr, 0, nr - b)
        loc_c = jnp.clip(g0 - owner_j * nc, 0, nc - b)

        # 1. panel column strip (nr, b) to every device column
        col_strip = _bcast(_dslice(k_loc, (0, loc_c), (nr, b)),
                           mj == owner_j, aj)
        # 2. diagonal block to every device row; redundant (b, b) factor
        a_kk = _bcast(_dslice(col_strip, (loc_r, 0), (b, b)),
                      mi == owner_i, ai)
        l_kk = jnp.linalg.cholesky(a_kk)
        # 3. local rows of the panel column: L = C L_kk^-T (XLA TRSM is
        # backward-stable; only the trailing matmul needs explicit precision)
        l_col = jax.scipy.linalg.solve_triangular(
            l_kk, col_strip.T, lower=True).T  # (nr, b)
        below = (gidx_r >= g0 + b)[:, None]
        in_panel = ((gidx_r >= g0) & (gidx_r < g0 + b))[:, None]
        l_kk_rows = _dupdate(jnp.zeros((nr, b), k_loc.dtype), l_kk, (loc_r, 0))
        new_col = jnp.where(below, l_col,
                            jnp.where(in_panel, l_kk_rows, col_strip))
        k_loc = jnp.where(mj == owner_j,
                          _dupdate(k_loc, new_col, (0, loc_c)), k_loc)

        # 4. full (N, b) panel; contiguous (nc, b) slice for local columns
        col_masked = jnp.where(below, new_col, 0.0)
        col_full = jax.lax.all_gather(col_masked, ai, axis=0, tiled=True)
        row_piece = _dslice(col_full, (mj * nc, 0), (nc, b))  # (nc, b)
        update = jnp.matmul(col_masked, row_piece.T, precision=precision,
                            preferred_element_type=k_loc.dtype)
        return k_loc - update

    k_done = jax.lax.fori_loop(0, nb, step, k_local, unroll=False)
    gidx_c = mj * nc + jnp.arange(nc)
    return jnp.where(gidx_c[None, :] <= gidx_r[:, None], k_done, 0.0)


def dist_solve_lower_2d_local(l_local: Array, rhs: Array, b: int,
                              axes: tuple[str, str] = ("i", "j")) -> Array:
    """Forward substitution L y = rhs with L 2-D-tiled; rhs/result replicated
    (N, m). The correction against already-solved rows is a local
    (b, nc) @ (nc, m) matmul + one psum over the whole mesh."""
    ai, aj = axes
    nr, nc = l_local.shape
    m = rhs.shape[1]
    n = nr * jax.lax.axis_size(ai)
    nb = n // b
    mi = jax.lax.axis_index(ai)
    mj = jax.lax.axis_index(aj)
    gidx_c = mj * nc + jnp.arange(nc)

    def step(kb, y):
        g0 = kb * b
        owner_i = g0 // nr
        owner_j = g0 // nc
        loc_r = jnp.clip(g0 - owner_i * nr, 0, nr - b)
        loc_c = jnp.clip(g0 - owner_j * nc, 0, nc - b)
        row_strip = _dslice(l_local, (loc_r, 0), (b, nc))  # L[g0:g0+b, my cols]
        row_left = jnp.where(gidx_c[None, :] < g0, row_strip, 0.0)
        y_cols = _dslice(y, (mj * nc, 0), (nc, m))
        partial = jnp.matmul(row_left, y_cols, preferred_element_type=y.dtype)
        corr = _bcast(partial, mi == owner_i, (ai, aj))  # (b, m), summed over j
        l_kk = _bcast(_dslice(l_local, (loc_r, loc_c), (b, b)),
                      (mi == owner_i) & (mj == owner_j), (ai, aj))
        rhs_panel = _dslice(rhs, (g0, 0), (b, m))
        y_kb = jax.scipy.linalg.solve_triangular(l_kk, rhs_panel - corr, lower=True)
        return _dupdate(y, y_kb, (g0, 0))

    return jax.lax.fori_loop(0, nb, step, jnp.zeros_like(rhs), unroll=False)


def dist_solve_upper_2d_local(l_local: Array, rhs: Array, b: int,
                              axes: tuple[str, str] = ("i", "j")) -> Array:
    """Backward substitution L^T x = rhs, same layout/conventions."""
    ai, aj = axes
    nr, nc = l_local.shape
    m = rhs.shape[1]
    n = nr * jax.lax.axis_size(ai)
    nb = n // b
    mi = jax.lax.axis_index(ai)
    mj = jax.lax.axis_index(aj)
    gidx_r = mi * nr + jnp.arange(nr)

    def step(t, x):
        kb = nb - 1 - t
        g0 = kb * b
        owner_i = g0 // nr
        owner_j = g0 // nc
        loc_r = jnp.clip(g0 - owner_i * nr, 0, nr - b)
        loc_c = jnp.clip(g0 - owner_j * nc, 0, nc - b)
        col_strip = _dslice(l_local, (0, loc_c), (nr, b))  # L[my rows, g0:g0+b]
        col_below = jnp.where((gidx_r >= g0 + b)[:, None], col_strip, 0.0)
        x_rows = _dslice(x, (mi * nr, 0), (nr, m))
        partial = jnp.matmul(col_below.T, x_rows, preferred_element_type=x.dtype)
        corr = _bcast(partial, mj == owner_j, (ai, aj))  # (b, m), summed over i
        l_kk = _bcast(_dslice(l_local, (loc_r, loc_c), (b, b)),
                      (mi == owner_i) & (mj == owner_j), (ai, aj))
        rhs_panel = _dslice(rhs, (g0, 0), (b, m))
        x_kb = jax.scipy.linalg.solve_triangular(
            l_kk, rhs_panel - corr, lower=True, trans=1)
        return _dupdate(x, x_kb, (g0, 0))

    return jax.lax.fori_loop(0, nb, step, jnp.zeros_like(rhs), unroll=False)


# ---------------------------------------------------------------------------
# mesh-level wrappers
# ---------------------------------------------------------------------------

def _check_divisible_2d(n: int, di: int, dj: int, b: int) -> None:
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by both mesh axes ({di}, {dj})")
    if (n // di) % b != 0 or (n // dj) % b != 0:
        raise ValueError(
            f"block size {b} must divide both local extents "
            f"({n // di} rows, {n // dj} cols) so panels never straddle a "
            "device boundary")


def dist_cholesky_2d(mesh: Mesh, k: Array, b: int = 128,
                     axes: tuple[str, str] = ("i", "j")) -> Array:
    """Lower Cholesky factor of SPD ``k`` (N, N) tiled P(i, j) over ``mesh``."""
    ai, aj = axes
    _check_divisible_2d(k.shape[0], mesh.shape[ai], mesh.shape[aj], b)
    fn = shard_map(partial(dist_cholesky_2d_local, b=b, axes=axes),
                   mesh=mesh, in_specs=P(ai, aj), out_specs=P(ai, aj))
    return fn(k)


def dist_cho_solve_2d(mesh: Mesh, l: Array, rhs: Array, b: int = 128,
                      axes: tuple[str, str] = ("i", "j")) -> Array:
    """(L L^T)^{-1} rhs with the factor 2-D-tiled and rhs replicated."""
    ai, aj = axes
    _check_divisible_2d(l.shape[0], mesh.shape[ai], mesh.shape[aj], b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs

    def body(l_local, r):
        y = dist_solve_lower_2d_local(l_local, r, b=b, axes=axes)
        return dist_solve_upper_2d_local(l_local, y, b=b, axes=axes)

    fn = shard_map(body, mesh=mesh, in_specs=(P(ai, aj), P(None, None)),
                   out_specs=P(None, None))
    out = fn(l, rhs2)
    return out[:, 0] if rhs.ndim == 1 else out


def dist_logdet_from_chol_2d(mesh: Mesh, l: Array,
                             axes: tuple[str, str] = ("i", "j")) -> Array:
    """log det(K) = 2 sum log diag(L): each device sums the diagonal entries
    that fall inside its tile, one psum over the mesh."""
    ai, aj = axes

    def body(l_local):
        nr, nc = l_local.shape
        mi = jax.lax.axis_index(ai)
        mj = jax.lax.axis_index(aj)
        gidx_r = mi * nr + jnp.arange(nr)
        lc = gidx_r - mj * nc  # local col of each local row's diagonal entry
        inside = (lc >= 0) & (lc < nc)
        vals = l_local[jnp.arange(nr), jnp.clip(lc, 0, nc - 1)]
        s = jnp.sum(jnp.where(inside, jnp.log(vals), 0.0))
        return jax.lax.psum(s, (ai, aj))[None]

    fn = shard_map(body, mesh=mesh, in_specs=P(ai, aj), out_specs=P(ai))
    return 2.0 * fn(l)[0]

"""Fused stationary-kernel matvec and gradient contraction (Pallas, Triton).

The matrix-free engines need two products with the Gram matrix that XLA
cannot fuse: ``K(x1, x2) @ V`` (every CG iteration, gp/exact_cg.py) and
the gradient contraction ``sum_ij Kbar_ij dK_ij/dtheta`` against a low-rank
cotangent (the Hutchinson and CG backwards). As plain XLA each rebuilds a
(panel, N) Gram tile in device memory and reads it back, so the bytes
moved per product grow as O(N^2). Here each program owns a block of rows
and walks the columns inside the kernel: the covariance tile is computed in
registers, contracted at once, and never stored. Device-memory traffic
drops to O(N (D + R)) per product; what is left is the transcendental and
tensor-core work.

Both kernels compute with unit variance and leave ``variance``, the noise
diagonal and the cotangent's scale to the caller (they are scalars on a
linear result), so the kernels take no parameters but the lengthscale-
scaled coordinates. Nothing is carried between programs: the gradient
kernel writes one row of partial sums per program and XLA adds them.

Precision: the squared distance ``|a|^2 + |b|^2 - 2 a.b`` is formed in full
f32 (its cancellation near r = 0 is what sets the accuracy of every entry
near the diagonal; the contraction is only D wide, so exact f32 costs
little); the wide contractions (covariance tile @ V, and the low-rank
cotangent tile) run on the tensor cores as a 3-pass TF32 split, which
keeps f32-grade accuracy at a third of the full-f32 rate. Interpret mode
(CPU tests) uses full f32 throughout: the CPU has no TF32.

``use_fused`` is the one dispatch rule for every caller.
"""

from __future__ import annotations

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from gpras_tpu.ops import kernels as K

Array = jax.Array

#: tensor-core contraction of the wide products (see module docstring)
CONTRACT_PRECISION = lax.DotAlgorithmPreset.TF32_TF32_F32_X3
#: compute capability the kernels are built for (TF32 tensor cores)
MIN_COMPUTE_CAPABILITY = 8.0
#: widest right-hand side the matvec takes in one program; wider V is split
#: into column chunks of this width (each recomputes the covariance tile)
KMV_BLOCK_R = 128
#: widest right-hand side dispatched to the fused matvec. Up to 128 columns
#: it beats XLA's panel loop on an H100 (N=131,072: 64.7 vs 125.6 ms at
#: R=17, 180 vs 198 ms at R=128); wider V re-evaluates the tile per chunk,
#: while XLA's panel loop amortizes one tile over all columns.
FUSED_MAX_RHS = 128

_plain_only = False


@contextlib.contextmanager
def plain_xla():
    """Trace the plain XLA paths even where the fused kernels apply — for
    comparing the two in one process. Affects functions traced inside."""
    global _plain_only
    prev, _plain_only = _plain_only, True
    try:
        yield
    finally:
        _plain_only = prev


def use_fused(kernel: str, dtype, rhs: int = 1) -> bool:
    """Whether the fused kernels serve a product: f32 data, a stationary
    kernel, at most ``FUSED_MAX_RHS`` right-hand-side columns, and a CUDA
    device of compute capability >= 8.0 as the default device. Everywhere
    else (the CPU above all) the plain XLA path is the only one; tests reach
    the kernels through ``interpret=True``."""
    if _plain_only or kernel not in K.STATIONARY_KERNELS \
            or jnp.dtype(dtype) != jnp.float32 or rhs > FUSED_MAX_RHS:
        return False
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return False
    return float(getattr(dev, "compute_capability", 0.0)) \
        >= MIN_COMPUTE_CAPABILITY


def _pow2(n: int, lo: int = 16) -> int:
    return max(lo, pl.next_power_of_2(n))


def _pad(x: Array, rows: int, cols: int) -> Array:
    return jnp.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _out_shape(shape: tuple[int, ...], *inputs: Array) -> jax.ShapeDtypeStruct:
    """f32 output varying over the mesh axes any input varies over, as
    ``shard_map`` (with its default ``check_vma=True``) requires of a
    ``pallas_call`` run inside it (sharded prediction runs ``kmv`` so)."""
    vma = frozenset().union(*(jax.typeof(t).vma for t in inputs))
    return jax.ShapeDtypeStruct(shape, jnp.float32, vma=vma)


def _sqdist(a: Array, a2: Array, b: Array) -> Array:
    """(BM, BN) squared distances of pre-scaled rows; exact-f32 dot."""
    ab = lax.dot_general(a, b, (((1,), (1,)), ((), ())),
                         precision=lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
    b2 = jnp.sum(b * b, axis=1)
    return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * ab, 0.0)


def _dot(x: Array, y: Array, contract: tuple[int, int], precision) -> Array:
    return lax.dot_general(x, y, (((contract[0],), (contract[1],)), ((), ())),
                           precision=precision,
                           preferred_element_type=jnp.float32)


def _f_fp(kernel: str, r2: Array) -> tuple[Array, Array]:
    """(f(u), f'(u)) for K = var * f(u), u the scaled squared distance.

    For the r-singular kernels (Matern12, Exponential: f'(u) ~ 1/r as
    r -> 0) the derivative is zeroed below a distance floor. That matches
    autodiff through ``sqrt(max(r2, floor))``, and it keeps huge 1/r values
    out of the (a - b)^2 = a^2 + b^2 - 2ab expansion below, where they
    would cancel catastrophically in f32."""
    f = K._stationary_from_r2(kernel, 1.0, r2)
    if kernel == "RBF":
        return f, -0.5 * f
    r = jnp.sqrt(jnp.maximum(r2, K._R2_FLOOR))
    # r2 > 1e-12 (r > 1e-6 scaled units): far below any distinct-point
    # separation, far above the f32 cancellation threshold
    inv2r = jnp.where(r2 > 1e-12, 0.5 / r, 0.0)
    if kernel == "Matern12":
        return f, -f * inv2r
    if kernel == "Matern32":
        return f, -1.5 * jnp.exp(-(3.0 ** 0.5) * r)
    if kernel == "Matern52":
        return f, -(5.0 / 6.0) * (1.0 + (5.0 ** 0.5) * r) \
            * jnp.exp(-(5.0 ** 0.5) * r)
    if kernel == "Exponential":
        return f, -0.5 * f * inv2r
    raise ValueError(kernel)


def _kmv_body(a_ref, b_ref, v_ref, o_ref, *, kernel: str, block_n: int,
              n_blocks: int, precision):
    a = a_ref[...]
    a2 = jnp.sum(a * a, axis=1)

    def body(j, acc):
        cols = pl.ds(j * block_n, block_n)
        f = K._stationary_from_r2(kernel, 1.0, _sqdist(a, a2, b_ref[cols, :]))
        return acc + _dot(f, v_ref[cols, :], (1, 0), precision)

    o_ref[...] = lax.fori_loop(0, n_blocks, body,
                               jnp.zeros(o_ref.shape, jnp.float32))


def _scaled(params: dict[str, Array], x: Array, rows: int, cols: int) -> Array:
    ls = jnp.exp(params["log_lengthscales"]).astype(jnp.float32)
    return _pad(x.astype(jnp.float32) / ls, rows, cols)


def kmv(kernel: str, params: dict[str, Array], x1: Array, v: Array,
        x2: Array | None = None, *, interpret: bool = False,
        block_m: int = 128, block_n: int = 64) -> Array:
    """``K(x1, x2) @ v`` (``x2`` defaults to ``x1``), v: (N2, R) -> (N1, R).

    No noise diagonal: the square caller adds ``noise * v`` itself. Rows
    are padded to the block sizes and R, D to powers of two >= 16 (what
    Triton's dot takes); padded rows of ``v`` are zero, so padded columns
    of K contribute nothing, and padded output rows are cropped. The grid
    is (row blocks, R chunks of up to ``KMV_BLOCK_R`` columns).

    Defaults measured on an H100 at N=131,072: (128, 64) blocks with 4
    warps and 2 stages for R <= 32, 8 warps and 3 stages above."""
    if kernel not in K.STATIONARY_KERNELS:
        raise ValueError(f"fused kmv supports stationary kernels, got {kernel}")
    x2 = x1 if x2 is None else x2
    (n1, d), n2, r = x1.shape, x2.shape[0], v.shape[1]
    d_p, r_p = _pow2(d), _pow2(r)
    block_r = min(r_p, KMV_BLOCK_R)
    num_warps, num_stages = (4, 2) if block_r <= 32 else (8, 3)
    m_p, n_p = _round_up(n1, block_m), _round_up(n2, block_n)
    a = _scaled(params, x1, m_p, d_p)
    b = _scaled(params, x2, n_p, d_p)
    v_p = _pad(v.astype(jnp.float32), n_p, r_p)
    precision = lax.Precision.HIGHEST if interpret else CONTRACT_PRECISION
    out = pl.pallas_call(
        partial(_kmv_body, kernel=kernel, block_n=block_n,
                n_blocks=n_p // block_n, precision=precision),
        out_shape=_out_shape((m_p, r_p), a, b, v_p),
        grid=(m_p // block_m, r_p // block_r),
        in_specs=[pl.BlockSpec((block_m, d_p), lambda i, c: (i, 0)),
                  pl.BlockSpec((n_p, d_p), lambda i, c: (0, 0)),
                  pl.BlockSpec((n_p, block_r), lambda i, c: (0, c))],
        out_specs=pl.BlockSpec((block_m, block_r), lambda i, c: (i, c)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="gpras_fused_kmv",
    )(a, b, v_p)
    var = jnp.exp(params["log_variance"]).astype(jnp.float32)
    return var * out[:n1, :r]


def _kgrad_body(a_ref, b_ref, p_ref, q_ref, gls_ref, gv_ref, *, kernel: str,
                block_n: int, n_blocks: int, precision):
    a = a_ref[...]
    a2 = jnp.sum(a * a, axis=1)
    p = p_ref[...]
    bm, d_p = a.shape

    def body(j, carry):
        gv, row_s, t, mb = carry
        cols = pl.ds(j * block_n, block_n)
        b = b_ref[cols, :]
        f, fp = _f_fp(kernel, _sqdist(a, a2, b))
        kb = _dot(p, q_ref[cols, :], (1, 1), precision)    # cotangent tile
        m = kb * fp
        col_t = jnp.sum(m, axis=0)
        return (gv + jnp.sum(kb * f, axis=1),
                row_s + jnp.sum(m, axis=1),
                t + jnp.sum(b * b * col_t[:, None], axis=0),
                mb + _dot(m, b, (1, 0), lax.Precision.HIGHEST))

    zeros = jnp.zeros((bm,), jnp.float32)
    gv, row_s, t, mb = lax.fori_loop(
        0, n_blocks, body,
        (zeros, zeros, jnp.zeros((d_p,), jnp.float32),
         jnp.zeros((bm, d_p), jnp.float32)))
    s = jnp.sum(a * a * row_s[:, None], axis=0)
    c = jnp.sum(a * mb, axis=0)
    gls_ref[...] = (-2.0 * (s + t - 2.0 * c))[None, :]
    gv_ref[...] = jnp.zeros((1, d_p), jnp.float32) + jnp.sum(gv)


def kgrad(kernel: str, params: dict[str, Array], x: Array, w: Array,
          z: Array, alpha: Array, g, inv_m: float, *,
          interpret: bool = False, block_m: int = 64,
          block_n: int = 64) -> dict[str, Array]:
    """dNLML/d(log_variance, log_lengthscales) for the rank-(m+1) cotangent
    ``Kbar = 0.5 g [inv_m W Z^T - alpha alpha^T]`` contracted with dK,
    without forming Kbar or any Gram tile in device memory.

    The cotangent is one low-rank product ``P Q^T`` with P = [inv_m W, -alpha]
    and Q = [Z, alpha]. With K = var f(u), u the scaled squared distance:

        d log_variance   = var sum_ij Kbar_ij f(u_ij)
        d log_lengthscale_d = -2 var sum_ij Kbar_ij f'(u_ij) (a_id - a_jd)^2

    and the second is expanded as row sums, column sums and one bilinear
    term per dimension, each reduced inside the row block's program. The
    noise/jitter diagonal term is O(N m) and stays with the caller.

    Defaults measured on an H100 at N=49,152, m=16: 19.6 ms against 45.7 ms
    for XLA's Gram-vjp panel loop.
    """
    if kernel not in K.STATIONARY_KERNELS:
        raise ValueError(f"fused kgrad supports stationary kernels, "
                         f"got {kernel}")
    n, d = x.shape
    d_p, k_p = _pow2(d), _pow2(w.shape[1] + 1)
    # the block sizes must both divide the padded row count
    n_p = _round_up(n, max(block_m, block_n))
    a = _scaled(params, x, n_p, d_p)
    al = alpha.astype(jnp.float32)[:, None]
    p = _pad(jnp.concatenate([inv_m * w.astype(jnp.float32), -al], axis=1),
             n_p, k_p)
    q = _pad(jnp.concatenate([z.astype(jnp.float32), al], axis=1), n_p, k_p)
    precision = lax.Precision.HIGHEST if interpret else CONTRACT_PRECISION
    nb = n_p // block_m
    gls, gv = pl.pallas_call(
        partial(_kgrad_body, kernel=kernel, block_n=block_n,
                n_blocks=n_p // block_n, precision=precision),
        out_shape=[_out_shape((nb, d_p), a, p, q)] * 2,
        grid=(nb,),
        in_specs=[pl.BlockSpec((block_m, d_p), lambda i: (i, 0)),
                  pl.BlockSpec((n_p, d_p), lambda i: (0, 0)),
                  pl.BlockSpec((block_m, k_p), lambda i: (i, 0)),
                  pl.BlockSpec((n_p, k_p), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((1, d_p), lambda i: (i, 0))] * 2,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="gpras_fused_kgrad",
    )(a, a, p, q)
    scale = 0.5 * jnp.asarray(g, jnp.float32) \
        * jnp.exp(params["log_variance"]).astype(jnp.float32)
    return {"log_variance": scale * jnp.sum(gv[:, 0]),
            "log_lengthscales": scale * jnp.sum(gls[:, :d], axis=0)}

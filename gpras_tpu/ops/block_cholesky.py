"""In-place blocked right-looking Cholesky as a fori_loop (single-device).

Why not ``jnp.linalg.cholesky``? Two reasons at very large N on this stack:

1. **Memory**: XLA's cholesky consumes K and produces L as separate O(N^2)
   buffers; at N = 50k f32 that is 2 x 10 GB before anything else. Here the
   loop carry *is* the matrix — XLA's while-loop carry aliasing updates it in
   place, so the factorization is meant to run in one buffer. (On an H100
   the compiled Hutchinson value-and-gradient program over
   ``super_cholesky`` still holds two (N, N) buffers; the dense memory
   ceiling, exact_stochastic.DENSE_BYTES_PER_ENTRY, counts both.)
2. **Compile time**: the native cholesky lowering's cost grows with N. This
   loop body is O(1) ops regardless of N — compile cost is flat.

Algorithm per panel kb (width b): factorize the b x b diagonal block
(``jnp.linalg.cholesky`` on the small block), TRSM the full panel column, then
one full-width masked rank-b update ``K -= col col^T`` (rows/columns left of the
panel are masked to zero so already-finished entries are untouched). The masked
full-width update costs ~3x the minimal trailing FLOPs in exchange for a single
fused matmul per step — the same static-shape tradeoff as the distributed
version (parallel/pcholesky.py), whose per-device body this mirrors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gpras_tpu.ops import linalg

Array = jax.Array


def _i32(v):
    return jnp.asarray(v, jnp.int32)


@partial(jax.jit, static_argnums=(1, 2))
def blocked_cholesky(k: Array, b: int = 512,
                     precision: str | None = None) -> Array:
    """Lower Cholesky factor of SPD ``k`` (N, N); N must be divisible by b.

    ``precision`` controls the trailing-update matmul (None: the package
    policy, gpras_tpu.MATMUL_PRECISION). A one-pass low-precision product
    there NaNs this factorization at cond(K) ~ 1e4 while XLA's own
    ``cholesky`` survives past 1e6. Panel solves use XLA
    ``triangular_solve``, which is more accurate than f32
    matmul-with-explicit-inverse (residual ~3e-7 vs ~1e-4 — forward
    substitution is backward-stable; applying an inverse is not).
    """
    n = k.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    nb = n // b
    gidx = jnp.arange(n)

    def step(kb, kmat):
        g0 = kb * b
        a_kk = jax.lax.dynamic_slice(kmat, (_i32(g0), _i32(g0)), (b, b))
        # symmetrize=False: callers (super_cholesky) may hold stale values in
        # the upper triangle; only the lower triangle is valid. safe_cholesky
        # escalates jitter on this block instead of NaN-poisoning every
        # trailing panel when f32 round-off turns the Schur complement
        # indefinite.
        l_kk = linalg.safe_cholesky(a_kk, jitter=0.0, symmetrize=False)
        col = jax.lax.dynamic_slice(kmat, (_i32(0), _i32(g0)), (n, b))
        l_col = jax.scipy.linalg.solve_triangular(l_kk, col.T, lower=True).T
        below = (gidx >= g0 + b)[:, None]
        in_panel = ((gidx >= g0) & (gidx < g0 + b))[:, None]
        l_kk_rows = jax.lax.dynamic_update_slice(
            jnp.zeros((n, b), kmat.dtype), l_kk, (_i32(g0), _i32(0)))
        new_col = jnp.where(below, l_col, jnp.where(in_panel, l_kk_rows, col))
        kmat = jax.lax.dynamic_update_slice(kmat, new_col, (_i32(0), _i32(g0)))
        col_masked = jnp.where(below, new_col, 0.0)
        return kmat - jnp.matmul(col_masked, col_masked.T, precision=precision,
                                 preferred_element_type=kmat.dtype)

    k_done = jax.lax.fori_loop(0, nb, step, k)
    return jnp.tril(k_done)


def super_cholesky(k: Array, w: int = 4096, strip: int = 8192,
                   precision: str | bool | None = None,
                   inv_panel: bool = True, zero_upper: bool = True) -> Array:
    """Two-level blocked Cholesky with statically shrinking trailing updates.

    ``blocked_cholesky`` keeps compile time flat by masking a full-width
    rank-b update every panel — 6x the minimal trailing FLOPs. This variant
    unrolls S = N/w super-panels in Python so every trailing slice is a
    static shape that SHRINKS panel by panel: total work is the textbook
    N^3/3 (+ the O(N^2 w) panel solves), while each HLO op stays a plain
    matmul/slice whose compile cost is independent of N.

    Per panel i (offset g = i*w):
      1. factorize the (w, w) diagonal block with the flat-compile inner loop;
      2. panel solve L21 = A21 L11^{-T} — ``inv_panel=True`` multiplies by the
         explicitly inverted, Newton-refined (w, w) triangle (one matmul),
         ``inv_panel=False`` uses the true triangular solve;
      3. trailing update A22 -= L21 L21^T, chunked into ``strip``-column
         blocks so the peak temporary is O((N-g) * strip), and restricted to
         rows >= the strip start (the upper triangle is never referenced).

    ``precision`` sets the panel/trailing matmuls' precision; None follows
    the package policy (``gpras_tpu.MATMUL_PRECISION``, "highest": full
    f32). On an H100 "default" and "high" both lower to TF32 (3e-4 relative
    error on a 4096^2 product), and the Hutchinson loss built on this
    factorization is NaN at N=16,384 and 49,152 on the hard problem;
    "highest" matches float64 to 3e-5 / 7e-5 there (PERF.md). Requires
    N % w == 0.

    Deliberately NOT wrapped in ``jax.jit``: a nested jit boundary makes the
    (N, N) input and the in-place update chain separate live buffers — at
    N=49k that is 2 x 9.7 GB where one would do. Traced inline in the
    caller's jit, XLA's dynamic-update-slice aliasing keeps one buffer.

    ``zero_upper=False`` skips the final ``tril`` and returns the factor with
    STALE values above the diagonal — the ``tril`` is a second (N, N)
    allocation XLA does not fuse away (it OOMed N=49k on its own). Safe for
    every consumer that only reads the lower triangle: the blocked panel
    solves (they mask), XLA ``triangular_solve`` (documented to access only
    the ``lower`` triangle), and the diagonal logdet.
    """
    n = k.shape[0]
    if n % w != 0:
        raise ValueError(f"N={n} must be divisible by super-panel width {w}")
    s = n // w
    if isinstance(precision, bool):  # legacy fast=True/False boolean
        precision = "default" if precision else "highest"
    prec = precision
    inner_b = fit_block(w, 512)
    for i in range(s):
        g0 = i * w
        diag = jax.lax.slice(k, (g0, g0), (g0 + w, g0 + w))
        # symmetrize_input=False: the strip updates only maintain the lower
        # triangle (upper holds stale values), and lax's default symmetrize
        # would average the garbage in.
        l11 = blocked_cholesky(diag, inner_b, prec) if w > inner_b \
            else linalg.safe_cholesky(diag, jitter=0.0, symmetrize=False)
        k = jax.lax.dynamic_update_slice(k, l11, (_i32(g0), _i32(g0)))
        t = n - g0 - w
        if t == 0:
            continue
        a21 = jax.lax.slice(k, (g0 + w, g0), (n, g0 + w))  # (t, w)
        if inv_panel:
            # Explicit inverse-by-matmul (see linalg.tri_inverse): the
            # Newton refinement compensates the ~1e-4 instability of
            # applying an explicit inverse.
            linv = linalg.tri_inverse(l11, precision=prec)
            l21 = jnp.matmul(a21, linv.T, precision=prec,
                             preferred_element_type=k.dtype)
        else:
            l21 = jax.scipy.linalg.solve_triangular(l11, a21.T, lower=True).T
        k = jax.lax.dynamic_update_slice(k, l21, (_i32(g0 + w), _i32(g0)))
        c0 = g0 + w
        for cs in range(c0, n, strip):
            ce = min(cs + strip, n)
            # Only rows >= cs of this column strip are ever read again.
            block = jax.lax.slice(k, (cs, cs), (n, ce))
            lrow = jax.lax.slice(l21, (cs - c0, 0), (t, w))
            lcol = jax.lax.slice(l21, (cs - c0, 0), (ce - c0, w))
            upd = jnp.matmul(lrow, lcol.T, precision=prec,
                             preferred_element_type=k.dtype)
            k = jax.lax.dynamic_update_slice(k, block - upd,
                                             (_i32(cs), _i32(cs)))
    return jnp.tril(k) if zero_upper else k


@partial(jax.jit, static_argnums=(2, 3))
def blocked_solve_lower(l: Array, rhs: Array, b: int = 512,
                        precision: str | None = None) -> Array:
    """Forward substitution L y = rhs with the same flat-compile structure:
    a fori_loop whose body solves one b-row panel and applies one masked
    full-width correction. The correction matmuls run at ``precision``
    (None: the package policy); panel solves use XLA triangular_solve
    (backward-stable, ~3e-7 residual)."""
    n = l.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    nb = n // b
    m = rhs.shape[1]
    cols = jnp.arange(n)

    def step(kb, y):
        g0 = kb * b
        panel = jax.lax.dynamic_slice(l, (_i32(g0), _i32(0)), (b, n))
        l_kk = jax.lax.dynamic_slice(panel, (_i32(0), _i32(g0)), (b, b))
        panel_left = jnp.where(cols[None, :] < g0, panel, 0.0)
        rhs_panel = jax.lax.dynamic_slice(rhs, (_i32(g0), _i32(0)), (b, m))
        corr = jnp.matmul(panel_left, y, precision=precision,
                          preferred_element_type=y.dtype)
        y_kb = jax.scipy.linalg.solve_triangular(l_kk, rhs_panel - corr,
                                                 lower=True)
        return jax.lax.dynamic_update_slice(y, y_kb, (_i32(g0), _i32(0)))

    return jax.lax.fori_loop(0, nb, step, jnp.zeros_like(rhs))


@partial(jax.jit, static_argnums=(2, 3))
def blocked_solve_upper(l: Array, rhs: Array, b: int = 512,
                        precision: str | None = None) -> Array:
    """Backward substitution L^T x = rhs (bottom-up panels)."""
    n = l.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    nb = n // b
    m = rhs.shape[1]
    rows = jnp.arange(n)

    def step(t, x):
        kb = nb - 1 - t
        g0 = kb * b
        col = jax.lax.dynamic_slice(l, (_i32(0), _i32(g0)), (n, b))
        l_kk = jax.lax.dynamic_slice(col, (_i32(g0), _i32(0)), (b, b))
        col_below = jnp.where((rows >= g0 + b)[:, None], col, 0.0)
        corr = jnp.matmul(col_below.T, x, precision=precision,
                          preferred_element_type=x.dtype)
        rhs_panel = jax.lax.dynamic_slice(rhs, (_i32(g0), _i32(0)), (b, m))
        x_kb = jax.scipy.linalg.solve_triangular(l_kk, rhs_panel - corr,
                                                 lower=True, trans=1)
        return jax.lax.dynamic_update_slice(x, x_kb, (_i32(g0), _i32(0)))

    return jax.lax.fori_loop(0, nb, step, jnp.zeros_like(rhs))


def fit_block(n: int, target: int = 512) -> int:
    """Largest block size <= target that divides n."""
    b = min(target, n)
    while n % b != 0:
        b -= 1
    return b


def blocked_cho_solve(l: Array, rhs: Array, b: int = 512,
                      precision: str | None = None) -> Array:
    """(L L^T)^{-1} rhs using the flat-compile panel solves.

    ``b`` is a target: it is shrunk to the largest divisor of N <= b."""
    b = fit_block(l.shape[0], b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    y = blocked_solve_lower(l, rhs2, b, precision)
    x = blocked_solve_upper(l, y, b, precision)
    return x[:, 0] if rhs.ndim == 1 else x

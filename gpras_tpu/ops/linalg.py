"""Dense linear-algebra helpers for the GP core: Cholesky with jitter, solves.

Replaces the TF ops the reference delegated to via GPflow (reference gpras/gpr.py:299,
SGPR internals): Cholesky factorization, triangular solves, and log-determinants.
These lower to XLA's (cuSOLVER/cuBLAS on a GPU) implementations; an in-place
blocked right-looking Cholesky for very large N lives in
``gpras_tpu.ops.block_cholesky``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array

#: Default diagonal jitter, scaled to the working dtype. The reference runs float64
#: with GPflow's 1e-6 default jitter (gpflow default_jitter); in float32 we use a
#: larger floor and adaptive escalation.
DEFAULT_JITTER_F32 = 1e-6
DEFAULT_JITTER_F64 = 1e-9


def default_jitter(dtype) -> float:
    return DEFAULT_JITTER_F64 if jnp.dtype(dtype) == jnp.float64 else DEFAULT_JITTER_F32


def add_jitter(k: Array, jitter: float | Array | None = None) -> Array:
    """K + jitter * mean(diag(K)) * I — relative jitter keeps scale-invariance."""
    if jitter is None:
        jitter = default_jitter(k.dtype)
    scale = jnp.mean(jnp.diag(k))
    return k + (jitter * scale) * jnp.eye(k.shape[-1], dtype=k.dtype)


def cholesky(k: Array, jitter: float | None = None) -> Array:
    """Lower Cholesky factor of K + jitter*I (relative jitter)."""
    return jnp.linalg.cholesky(add_jitter(k, jitter))


def safe_cholesky(
    k: Array,
    max_tries: int = 5,
    jitter: float | None = None,
    *,
    symmetrize: bool = True,
) -> Array:
    """Cholesky with adaptive jitter escalation (x10 per retry), fully jittable
    AND reverse-differentiable.

    A ``lax.while_loop`` retries while the factor contains NaNs (XLA returns
    NaN rather than raising on an indefinite matrix) and tries remain, so the
    escalation compiles to one program whose happy path costs a single
    factorization plus one NaN scan. Because ``while_loop`` has no reverse
    rule, the op carries a ``custom_vjp``: the backward refactorizes once at
    the escalated jitter (treated as a constant) and applies the standard
    Cholesky VJP — differentiated call sites are the small (M, M) SGPR
    factors, where the recompute is free; the large primal-only call sites
    (posterior caches, blocked diagonal panels) never pay it.

    ``jitter`` is the FIRST attempt's relative jitter. Pass ``0.0`` for callers
    whose matrix already carries its own jitter/noise diagonal (SGPR's Kuu, the
    exact GP's K + sigma2 I): the first attempt factors K as given and
    escalation starts from ``default_jitter(dtype)`` only on failure.
    ``symmetrize=False`` skips XLA's input symmetrization — required when the
    upper triangle holds stale values (blocked in-place factorizations).
    """
    if jitter is None:
        jitter = default_jitter(k.dtype)
    return _safe_cholesky(k, int(max_tries), float(jitter), bool(symmetrize))


def _chol_attempt(k: Array, jcoef: Array, symmetrize: bool) -> Array:
    eye = jnp.eye(k.shape[-1], dtype=k.dtype)
    return jax.lax.linalg.cholesky(k + jcoef * eye, symmetrize_input=symmetrize)


def _escalate(k: Array, max_tries: int, jitter: float, symmetrize: bool):
    """(L, final jitter coefficient) after NaN-driven escalation."""
    base = jnp.asarray(default_jitter(k.dtype), dtype=k.dtype)
    scale = jnp.mean(jnp.diagonal(k, axis1=-2, axis2=-1))

    def cond(state):
        i, _, l = state
        return jnp.logical_and(i < max_tries, jnp.any(jnp.isnan(l)))

    def body(state):
        i, j, _ = state
        j = jnp.where(j > 0, j * 10.0, base)
        return i + 1, j, _chol_attempt(k, j * scale, symmetrize)

    j0 = jnp.asarray(jitter, dtype=k.dtype)
    _, j_final, l = jax.lax.while_loop(
        cond, body, (0, j0, _chol_attempt(k, j0 * scale, symmetrize)))
    return l, j_final * scale


@partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _safe_cholesky(k: Array, max_tries: int, jitter: float, symmetrize: bool) -> Array:
    l, _ = _escalate(k, max_tries, jitter, symmetrize)
    return l


def _safe_cholesky_fwd(k, max_tries, jitter, symmetrize):
    l, jcoef = _escalate(k, max_tries, jitter, symmetrize)
    return l, (k, jcoef)


def _safe_cholesky_bwd(max_tries, jitter, symmetrize, res, lbar):
    k, jcoef = res
    _, vjp = jax.vjp(
        lambda kk: _chol_attempt(kk, jax.lax.stop_gradient(jcoef), symmetrize), k)
    return vjp(lbar)


_safe_cholesky.defvjp(_safe_cholesky_fwd, _safe_cholesky_bwd)


def tri_inverse(l: Array, *, precision: str | None = None,
                newton_steps: int = 2) -> Array:
    """Explicit lower-triangular inverse, Newton-refined at ``precision``.

    Used where one (w, w) inverse is applied by matmul to a tall block
    (``super_cholesky``'s panel solve multiplies a (t, w) block by it)
    instead of a triangular solve with many right-hand sides. Numerics: XLA's ``triangular_solve`` itself is
    backward-stable (measured ~3e-7 f32 residual — prefer it when speed is
    equal); inverse-application is not (measured ~1e-4 residual at
    cond ~ 1e5), so the Newton refinement ``X <- X + X(I - L X)`` at
    controlled precision keeps the inverse operator f32-accurate, and the
    factorization quality it feeds was validated against XLA's cholesky to
    the f32 conditioning wall.
    """
    n = l.shape[-1]
    eye = jnp.eye(n, dtype=l.dtype)
    l = jnp.tril(l)  # the refinement matmuls read the full matrix
    x = jax.scipy.linalg.solve_triangular(l, eye, lower=True)
    for _ in range(newton_steps):
        r = eye - jnp.matmul(l, x, precision=precision,
                             preferred_element_type=l.dtype)
        x = x + jnp.matmul(x, r, precision=precision,
                           preferred_element_type=l.dtype)
        # keep strictly-upper roundoff from leaking into later products
        x = jnp.tril(x)
    return x


def solve_triangular(l: Array, b: Array, *, lower: bool = True, trans: bool = False) -> Array:
    """Triangular solve; thin wrapper so call sites read like the math."""
    return jax.scipy.linalg.solve_triangular(l, b, lower=lower, trans=1 if trans else 0)


def cho_solve(l: Array, b: Array) -> Array:
    """Solve (L L^T) x = b given the lower factor L."""
    y = solve_triangular(l, b, lower=True)
    return solve_triangular(l, y, lower=True, trans=True)


def logdet_from_chol(l: Array) -> Array:
    """log det(K) = 2 * sum(log diag(L))."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1)), axis=-1)


def inv_from_chol(l: Array) -> Array:
    """K^{-1} from the lower factor L (used by the custom-VJP NLML backward)."""
    eye = jnp.eye(l.shape[-1], dtype=l.dtype)
    linv = solve_triangular(l, eye, lower=True)
    return linv.T @ linv

"""Sparse GP regression: Titsias (2009) collapsed ELBO, the reference's workhorse.

Re-derivation of GPflow's ``SGPR`` (which the reference constructs per EOF mode,
gpras/gpr.py:293-299, and trains via ``model.training_loss()``, gpras/gpr.py:154)
as pure jittable JAX. With kernel k, inducing inputs Z (M, D), training data
(X (N, D), y (N,)), and Gaussian noise s2:

    Kuu = k(Z, Z) + jitter*I          L  = chol(Kuu)
    A   = L^{-1} k(Z, X) / s          B  = I + A A^T       LB = chol(B)
    c   = LB^{-1} A y / s

    ELBO = -N/2 log(2 pi) - sum(log diag LB) - N/2 log s2
           - ||y||^2 / (2 s2) + ||c||^2 / 2
           - sum(kdiag(X)) / (2 s2) + trace(A A^T) / 2

The last two terms are the Titsias trace correction. Everything is one Cholesky of
an (M, M) matrix plus dense matmuls — an ideal accelerator shape (M = inducing count is 10-300
in the reference's sweeps, cross_validation.py:105-110). Gradients flow by
ordinary AD (cost is dominated by the (M, N) matmuls; no custom VJP needed at
these sizes).

The inducing inputs Z live in the same unconstrained param dict as the kernel
hyperparameters (key ``"z"``, unconstrained already), so the optimizer zoo's
staged freeze/unfreeze schedules (reference two-/three-stage, gpras/gpr.py:112-144)
are plain gradient masks.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from gpras_tpu.gp.priors import log_prior
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg

Array = jax.Array

def kuu_gram(kernel: str, params: dict[str, Array], z: Array) -> Array:
    """Kuu with dtype-scaled diagonal jitter (GPflow uses a fixed 1e-6 in f64;
    we use 1e-6 in f32 and 1e-9 in f64 via linalg.default_jitter so float64
    validation against the exact GP stays tight)."""
    k = K.gram(kernel, params, z)
    variance = jnp.exp(params["log_variance"])
    jitter = linalg.default_jitter(k.dtype)
    return k + (jitter * (1.0 + variance)) * jnp.eye(z.shape[0], dtype=k.dtype)


def _common(kernel: str, params: dict[str, Array], x: Array):
    """Shared factor pipeline for ELBO and prediction."""
    z = params["z"]
    sigma2 = jnp.exp(params["log_noise_variance"])
    sigma = jnp.sqrt(sigma2)
    kuu = kuu_gram(kernel, params, z)
    kuf = K.gram(kernel, params, z, x)  # (M, N)
    # safe_cholesky: Kuu already carries its jitter (kuu_gram), so the first
    # attempt is the plain factorization; near-duplicate inducing points in f32
    # escalate instead of NaN-ing the whole fit (GPflow raises here).
    l = linalg.safe_cholesky(kuu, jitter=0.0)
    a = linalg.solve_triangular(l, kuf, lower=True) / sigma  # (M, N)
    b = a @ a.T + jnp.eye(z.shape[0], dtype=x.dtype)
    lb = linalg.safe_cholesky(b, jitter=0.0)
    return sigma, sigma2, l, a, lb


@partial(jax.jit, static_argnums=(0,))
def elbo(kernel: str, params: dict[str, Array], x: Array, y: Array) -> Array:
    """Collapsed evidence lower bound, summed over output columns of y (N,) or (N, P)."""
    y2 = y[:, None] if y.ndim == 1 else y
    n, p = y2.shape
    sigma, sigma2, l, a, lb = _common(kernel, params, x)
    aerr = a @ y2  # (M, P)
    c = linalg.solve_triangular(lb, aerr, lower=True) / sigma  # (M, P)
    kdiag_sum = jnp.sum(K.kdiag(kernel, params, x))
    out = -0.5 * p * n * math.log(2.0 * math.pi)
    out = out - p * jnp.sum(jnp.log(jnp.diagonal(lb)))
    out = out - 0.5 * p * n * jnp.log(sigma2)
    out = out - 0.5 * jnp.sum(y2 * y2) / sigma2
    out = out + 0.5 * jnp.sum(c * c)
    out = out - 0.5 * p * kdiag_sum / sigma2
    out = out + 0.5 * p * jnp.sum(a * a)  # trace(A A^T)
    return out


def training_loss(kernel: str, params: dict[str, Array], x: Array, y: Array) -> Array:
    """-(ELBO + log prior): the objective all seven reference optimizers minimize
    (gpras/gpr.py:154,187 with priors gpras/gpr.py:303-305)."""
    return -(elbo(kernel, params, x, y) + log_prior(params))


@partial(jax.jit, static_argnums=(0, 5))
def predict(
    kernel: str,
    params: dict[str, Array],
    x_train: Array,
    y_train: Array,
    x_test: Array,
    include_noise: bool = True,
) -> tuple[Array, Array]:
    """Posterior predictive mean/variance at x_test from the collapsed posterior.

    ``include_noise=True`` reproduces the reference's ``predict_y`` call
    (gpras/gpr.py:337): observation-space variance includes the noise term.
    """
    y2 = y_train[:, None] if y_train.ndim == 1 else y_train
    sigma, sigma2, l, a, lb = _common(kernel, params, x_train)
    aerr = a @ y2
    c = linalg.solve_triangular(lb, aerr, lower=True) / sigma
    kus = K.gram(kernel, params, params["z"], x_test)  # (M, S)
    tmp1 = linalg.solve_triangular(l, kus, lower=True)  # (M, S)
    tmp2 = linalg.solve_triangular(lb, tmp1, lower=True)  # (M, S)
    mean = tmp2.T @ c  # (S, P)
    var = (
        K.kdiag(kernel, params, x_test)
        - jnp.sum(tmp1 * tmp1, axis=0)
        + jnp.sum(tmp2 * tmp2, axis=0)
    )
    var = jnp.maximum(var, 0.0)
    if include_noise:
        var = var + sigma2
    var = jnp.broadcast_to(var[:, None], mean.shape)
    if y_train.ndim == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def init_params(
    kernel: str,
    x: Array,
    z: Array,
    noise_variance: float = 1.0,
    variance: float = 1.0,
    lengthscales: float | Array | None = None,
) -> dict[str, Array]:
    """Initial SGPR params: reference heuristics (variance=1, lengthscale=mean|x|,
    gpras/gpr.py:289-298) plus the inducing inputs as a trainable leaf ``"z"``."""
    if lengthscales is None:
        lengthscales = jnp.mean(jnp.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance, lengthscales=lengthscales, dtype=x.dtype)
    p["log_noise_variance"] = jnp.asarray(jnp.log(noise_variance), dtype=x.dtype)
    p["z"] = jnp.asarray(z, dtype=x.dtype)
    return p

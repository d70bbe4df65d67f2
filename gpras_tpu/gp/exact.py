"""Exact Gaussian-process regression with a custom-VJP log-marginal-likelihood.

The reference has no exact GP (it always uses GPflow's sparse SGPR,
gpras/gpr.py:299); BASELINE.json's north star adds one as a first-class target:
"training runs a blocked Cholesky ... with a custom-VJP log-marginal-
likelihood so hyperparameter optimization is fully jitted".

Design:
- ``quad_logdet(K, y)`` is the only custom-VJP boundary. Its forward factorizes K
  once (Cholesky) and its backward **reuses the factor**: the adjoint of
  0.5 y^T K^{-1} y + 0.5 logdet K w.r.t. K is 0.5 (K^{-1} - alpha alpha^T), which
  needs one triangular inverse — no re-factorization, no autodiff through the
  Cholesky decomposition's internal scan.
- Gradients w.r.t. kernel hyperparameters then flow through the (elementwise +
  one-matmul) Gram construction by ordinary reverse-mode AD, so the whole kernel
  zoo is supported without per-kernel adjoint derivations. Wrap the Gram build in
  ``jax.checkpoint`` at large N to trade recompute for O(N^2) residual memory.

All functions are pure and jittable; dtype follows the inputs (float64 works on
CPU for validation; float32 is the device default).
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


@jax.custom_vjp
def quad_logdet(k: Array, y: Array) -> Array:
    """Per-output 0.5 * y_p^T K^{-1} y_p + 0.5 * logdet(K), shape (P,).

    ``k`` is (N, N) SPD (noise already added), ``y`` is (N, P).
    """
    l = jnp.linalg.cholesky(k)
    alpha = linalg.cho_solve(l, y)
    quad = 0.5 * jnp.sum(y * alpha, axis=0)
    return quad + 0.5 * linalg.logdet_from_chol(l)


def _quad_logdet_fwd(k: Array, y: Array):
    l = jnp.linalg.cholesky(k)
    alpha = linalg.cho_solve(l, y)
    quad = 0.5 * jnp.sum(y * alpha, axis=0)
    out = quad + 0.5 * linalg.logdet_from_chol(l)
    return out, (l, alpha)


def _quad_logdet_bwd(res, g):
    l, alpha = res
    kinv = linalg.inv_from_chol(l)
    # d/dK [0.5 y^T K^-1 y + 0.5 logdet K] = 0.5 (K^-1 - alpha alpha^T), per output p,
    # weighted by the incoming cotangent g_p and summed over outputs.
    k_bar = 0.5 * (jnp.sum(g) * kinv - (alpha * g[None, :]) @ alpha.T)
    y_bar = alpha * g[None, :]
    return k_bar, y_bar


quad_logdet.defvjp(_quad_logdet_fwd, _quad_logdet_bwd)


def build_train_gram(
    kernel: str, params: dict[str, Array], x: Array, *, jitter: float | None = None
) -> Array:
    """K(x, x) + (noise_variance + jitter) * I for the training objective."""
    noise = jnp.exp(params["log_noise_variance"])
    k = K.gram(kernel, params, x)
    if jitter is None:
        jitter = linalg.default_jitter(k.dtype)
    variance = jnp.exp(params["log_variance"])
    return k + (noise + jitter * variance) * jnp.eye(x.shape[0], dtype=k.dtype)


@partial(jax.jit, static_argnums=(0,))
def nlml(kernel: str, params: dict[str, Array], x: Array, y: Array) -> Array:
    """Negative log marginal likelihood of an exact GP, summed over output columns.

    ``y`` may be (N,) or (N, P) (shared kernel across outputs).
    """
    y2 = y[:, None] if y.ndim == 1 else y
    n, p = y2.shape
    k = build_train_gram(kernel, params, x)
    core = quad_logdet(k, y2)
    return jnp.sum(core) + 0.5 * p * n * math.log(2.0 * math.pi)


def training_loss(kernel: str, params: dict[str, Array], x: Array, y: Array) -> Array:
    """NLML minus the log prior — the posterior-regularized objective the reference
    optimizes (GPflow ``training_loss`` = -(log marginal + log prior),
    reference gpras/gpr.py:154 with priors from gpras/gpr.py:303-305)."""
    return nlml(kernel, params, x, y) - log_prior(params)


@partial(jax.jit, static_argnums=(0, 5))
def predict(
    kernel: str,
    params: dict[str, Array],
    x_train: Array,
    y_train: Array,
    x_test: Array,
    include_noise: bool = True,
) -> tuple[Array, Array]:
    """Posterior mean and variance at ``x_test``; (S,) or (S, P) following y_train.

    ``include_noise=True`` matches the reference's use of ``predict_y``
    (observation-space variance, gpras/gpr.py:337); False gives latent-f variance.
    """
    y2 = y_train[:, None] if y_train.ndim == 1 else y_train
    k = build_train_gram(kernel, params, x_train)
    l = jnp.linalg.cholesky(k)
    alpha = linalg.cho_solve(l, y2)
    ks = K.gram(kernel, params, x_test, x_train)  # (S, N)
    mean = ks @ alpha
    v = linalg.solve_triangular(l, ks.T, lower=True)  # (N, S)
    var = K.kdiag(kernel, params, x_test) - jnp.sum(v * v, axis=0)
    var = jnp.maximum(var, 0.0)
    if include_noise:
        var = var + jnp.exp(params["log_noise_variance"])
    var = jnp.broadcast_to(var[:, None], mean.shape)
    if y_train.ndim == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def init_params(
    kernel: str,
    x: Array,
    noise_variance: float = 1.0,
    variance: float = 1.0,
    lengthscales: float | Array | None = None,
) -> dict[str, Array]:
    """Initial hyperparameters following the reference's heuristic: variance=1 and
    lengthscale = mean(|x|) (gpras/gpr.py:289-298), noise variance 1 (GPflow default).
    """
    if lengthscales is None:
        lengthscales = jnp.mean(jnp.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance, lengthscales=lengthscales, dtype=x.dtype)
    p["log_noise_variance"] = jnp.asarray(jnp.log(noise_variance), dtype=x.dtype)
    return p

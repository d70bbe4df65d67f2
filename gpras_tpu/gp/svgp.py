"""Stochastic variational GP (SVGP): the minibatch-trainable sparse engine.

Greenfield beyond the reference: the reference's only sparse engine is the
collapsed Titsias SGPR it builds per EOF mode via GPflow (gpras/gpr.py:293-299),
which needs the full (M, N) cross-Gram inside every optimizer step — N is
bounded by memory and every step costs O(N M^2). The uncollapsed bound of
Hensman et al. (2013, "Gaussian Processes for Big Data") makes the posterior
over inducing outputs an explicit variational distribution q(u), so the ELBO
decomposes over data points. That unlocks the accelerator-idiomatic training loop:
fixed-shape minibatch steps under one jit (``make_minibatch_fit`` compiles a
single program that ``lax.scan``s over shuffled on-device batches — no
retraces, no host round trips), unbounded N at O(M^2) memory, and O(M^2)-state
serving (prediction reads only the fitted params, never the training set).

Whitened parameterization (v = L^{-1} u with L = chol(Kuu), so the prior is
p(v) = N(0, I) and the KL never touches Kuu's conditioning):

    A        = L^{-1} k(Z, X)                                   (M, B)
    mean_f   = A^T q_mu
    var_f_i  = kdiag(x_i) - ||a_i||^2 + ||q_sqrt^T a_i||^2
    ELBO     = (N / B) * sum_i [ log N(y_i | mean_f_i, s2) - var_f_i / (2 s2) ]
               - KL(q(v) || N(0, I))
    KL       = 0.5 * ( ||q_mu||^2 + ||q_sqrt||_F^2 - M
                       - 2 sum log diag(q_sqrt) )               per output

The Gaussian likelihood makes the per-point expectation closed-form (the
``- var_f / (2 s2)`` correction), so the bound is exact, not Monte Carlo.

q_sqrt is stored as an unconstrained (..., M, M) leaf ``q_raw`` — strict lower
triangle free, diagonal ``exp``-positive — so ``q_mu = 0, q_raw = 0``
initializes q(v) = N(0, I) with exactly zero KL. The variational leaves live
in the same param dict as the kernel hyperparameters and inducing inputs
``"z"``, so the optimizer zoo's gradient-mask freeze schedules apply
unchanged, and ``gp/priors.log_prior`` (which names only the three
reference-prior hyperparameters) skips them automatically.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from gpras_tpu.gp.priors import log_prior
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg

Array = jax.Array


def q_sqrt_from_raw(q_raw: Array) -> Array:
    """Lower-triangular Cholesky factor of S from the unconstrained leaf.

    Strict lower triangle passes through; the diagonal is ``exp`` of the raw
    diagonal (so raw zeros give S = I). Batched over leading axes.
    """
    tril = jnp.tril(q_raw, k=-1)
    diag = jnp.exp(jnp.diagonal(q_raw, axis1=-2, axis2=-1))
    m = q_raw.shape[-1]
    eye = jnp.eye(m, dtype=q_raw.dtype)
    return tril + eye * diag[..., None, :]


def raw_from_q_sqrt(q_sqrt: Array) -> Array:
    """Inverse of :func:`q_sqrt_from_raw` (strictly positive diagonal)."""
    tril = jnp.tril(q_sqrt, k=-1)
    diag = jnp.log(jnp.diagonal(q_sqrt, axis1=-2, axis2=-1))
    m = q_sqrt.shape[-1]
    eye = jnp.eye(m, dtype=q_sqrt.dtype)
    return tril + eye * diag[..., None, :]


def init_params(
    kernel: str,
    x: Array,
    z: Array,
    noise_variance: float = 1.0,
    variance: float = 1.0,
    lengthscales: float | Array | None = None,
    outputs: int = 1,
) -> dict[str, Array]:
    """SVGP params: SGPR's hyperparameter heuristics (reference
    gpras/gpr.py:289-298) plus whitened variational leaves ``q_mu`` (M, P)
    and ``q_raw`` (P, M, M), initialized to q(v) = N(0, I) (zero KL)."""
    if lengthscales is None:
        lengthscales = jnp.mean(jnp.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance,
                      lengthscales=lengthscales, dtype=x.dtype)
    p["log_noise_variance"] = jnp.asarray(jnp.log(noise_variance), dtype=x.dtype)
    p["z"] = jnp.asarray(z, dtype=x.dtype)
    m = p["z"].shape[0]
    p["q_mu"] = jnp.zeros((m, outputs), dtype=x.dtype)
    p["q_raw"] = jnp.zeros((outputs, m, m), dtype=x.dtype)
    return p


def _whitened_projection(kernel: str, params: dict[str, Array], x: Array):
    """A = L^{-1} k(Z, x) — the only O(M^2 B) work per batch."""
    from gpras_tpu.gp.sgpr import kuu_gram

    kuu = kuu_gram(kernel, params, params["z"])
    l = linalg.safe_cholesky(kuu, jitter=0.0)
    kux = K.gram(kernel, params, params["z"], x)  # (M, B)
    return linalg.solve_triangular(l, kux, lower=True)


def _f_moments(params: dict[str, Array], a: Array, kdiag: Array):
    """Marginal posterior moments of f at the batch points.

    Returns mean (B, P) and variance (B, P) of the variational posterior
    (noise-free latent f)."""
    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)
    mean = a.T @ params["q_mu"]  # (B, P)
    sa = jnp.einsum("pkm,kb->pmb", q_sqrt, a)  # q_sqrt^T a, (P, M, B)
    var = (kdiag - jnp.sum(a * a, axis=0))[:, None] \
        + jnp.sum(sa * sa, axis=1).T  # (B, P)
    return mean, jnp.maximum(var, 0.0)


def kl_to_prior(params: dict[str, Array]) -> Array:
    """KL(q(v) || N(0, I)) summed over outputs; zero at init."""
    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)
    m = q_sqrt.shape[-1]
    p = q_sqrt.shape[0]
    logdet = 2.0 * jnp.sum(jnp.diagonal(params["q_raw"], axis1=-2, axis2=-1))
    return 0.5 * (jnp.sum(params["q_mu"] ** 2) + jnp.sum(q_sqrt**2)
                  - p * m - logdet)


@partial(jax.jit, static_argnums=(0,))
def elbo(kernel: str, params: dict[str, Array], x: Array, y: Array,
         n_total: Array | int) -> Array:
    """Uncollapsed evidence lower bound on a (mini)batch.

    ``n_total`` is the full-dataset size: the data term is scaled by
    ``n_total / batch`` so minibatch gradients are unbiased estimates of the
    full-bound gradient. At ``x.shape[0] == n_total`` this is the exact bound,
    and it is dominated by (<=) SGPR's collapsed bound, with equality at the
    analytically optimal q (see tests/test_svgp.py)."""
    y2 = y[:, None] if y.ndim == 1 else y
    b = y2.shape[0]
    sigma2 = jnp.exp(params["log_noise_variance"])
    a = _whitened_projection(kernel, params, x)
    mean, var_f = _f_moments(params, a, K.kdiag(kernel, params, x))
    # closed-form Gaussian expected log-likelihood per point/output
    quad = (y2 - mean) ** 2 + var_f
    loglik = -0.5 * (math.log(2.0 * math.pi) + jnp.log(sigma2)) \
        - 0.5 * quad / sigma2
    scale = jnp.asarray(n_total, dtype=y2.dtype) / b
    return scale * jnp.sum(loglik) - kl_to_prior(params)


def training_loss(kernel: str, params: dict[str, Array], x: Array, y: Array,
                  n_total: Array | int) -> Array:
    """-(ELBO + log prior) — same objective shape the optimizer zoo minimizes
    for every other engine (reference gpras/gpr.py:154,187)."""
    return -(elbo(kernel, params, x, y, n_total) + log_prior(params))


@partial(jax.jit, static_argnums=(0, 3))
def predict(kernel: str, params: dict[str, Array], x_test: Array,
            include_noise: bool = True) -> tuple[Array, Array]:
    """Posterior predictive at x_test from the fitted params ALONE.

    Unlike SGPR/exact predict, no training set is needed — the variational
    posterior q(u) is the model state (O(M^2) serving footprint).
    ``include_noise=True`` mirrors the reference's ``predict_y`` semantics
    (gpras/gpr.py:337)."""
    a = _whitened_projection(kernel, params, x_test)
    mean, var = _f_moments(params, a, K.kdiag(kernel, params, x_test))
    if include_noise:
        var = var + jnp.exp(params["log_noise_variance"])
    p = params["q_mu"].shape[1]
    if p == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def optimal_q(kernel: str, params: dict[str, Array], x: Array,
              y: Array) -> dict[str, Array]:
    """Analytically optimal whitened q(v) for the Gaussian likelihood.

    With A = L^{-1} K_zx over the FULL dataset: S* = (I + A A^T / s2)^{-1},
    m* = S* A y / s2. Substituting them into the uncollapsed bound recovers
    Titsias' collapsed ELBO exactly — useful to warm-start minibatch training
    from an SGPR fit and as the correctness anchor in the tests."""
    y2 = y[:, None] if y.ndim == 1 else y
    sigma2 = jnp.exp(params["log_noise_variance"])
    a = _whitened_projection(kernel, params, x)
    m = a.shape[0]
    b_mat = jnp.eye(m, dtype=x.dtype) + (a @ a.T) / sigma2
    lb = linalg.safe_cholesky(b_mat, jitter=0.0)
    # S* = B^{-1} = LB^{-T} LB^{-1}; its Cholesky factor is LB^{-T} re-factored
    s_star = linalg.cho_solve(lb, jnp.eye(m, dtype=x.dtype))
    q_sqrt = linalg.safe_cholesky(s_star, jitter=0.0)
    q_mu = s_star @ (a @ y2) / sigma2
    out = dict(params)
    out["q_mu"] = q_mu
    out["q_raw"] = jnp.broadcast_to(
        raw_from_q_sqrt(q_sqrt)[None], (y2.shape[1], m, m)).copy()
    return out


def natgrad_step(kernel: str, params: dict[str, Array], x: Array, y: Array,
                 n_total: Array | int, lr: float = 0.1) -> dict[str, Array]:
    """One natural-gradient step on the variational leaves (q_mu, q_raw).

    For the Gaussian likelihood the ELBO is conjugate in q's natural
    parameters (lam1, lam2) = (S^{-1} m, -S^{-1}/2), and the natural
    gradient in expectation parameters is available in closed form: with
    G = (n_total / B) A A^T / s2 and b = (n_total / B) A y / s2 over the
    batch,

        lam1'      = (1 - lr) lam1 + lr b
        -2 lam2'   = (1 - lr) S^{-1} + lr (G + I)

    Both summands of -2 lam2' are PD, so the step is PD-safe for any
    lr in (0, 1]. At lr = 1 on the full dataset this lands EXACTLY on
    :func:`optimal_q` from any starting q — the conjugate jump GPflow's
    NaturalGradient(gamma=1) makes — so hyperparameter-only optimization
    with interleaved lr=1 NGD recovers collapsed-SGPR training at SVGP's
    per-step cost. Minibatches use lr < 1 (stochastic G, b).
    """
    y2 = y[:, None] if y.ndim == 1 else y
    b_size = y2.shape[0]
    p_out = y2.shape[1]
    sigma2 = jnp.exp(params["log_noise_variance"])
    a = _whitened_projection(kernel, params, x)  # (M, B)
    m = a.shape[0]
    scale = jnp.asarray(n_total, dtype=y2.dtype) / b_size
    g_mat = scale * (a @ a.T) / sigma2  # (M, M), shared across outputs
    b_vec = scale * (a @ y2) / sigma2  # (M, P)
    eye = jnp.eye(m, dtype=a.dtype)

    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)

    def one_output(q_sqrt_p, q_mu_p, b_p):
        # S^{-1} = L^{-T} L^{-1}; lam1 = S^{-1} m
        linv = linalg.solve_triangular(q_sqrt_p, eye, lower=True)
        s_inv = linv.T @ linv
        lam1 = s_inv @ q_mu_p
        prec_new = (1.0 - lr) * s_inv + lr * (g_mat + eye)
        lp = linalg.safe_cholesky(prec_new, jitter=0.0)
        s_new = linalg.cho_solve(lp, eye)
        lam1_new = (1.0 - lr) * lam1 + lr * b_p
        m_new = s_new @ lam1_new
        return linalg.safe_cholesky(s_new, jitter=0.0), m_new

    q_sqrt_new, q_mu_new = jax.vmap(one_output, in_axes=(0, 1, 1))(
        q_sqrt, params["q_mu"], b_vec)
    out = dict(params)
    out["q_mu"] = jnp.moveaxis(q_mu_new, 0, 1).reshape(m, p_out)
    out["q_raw"] = raw_from_q_sqrt(q_sqrt_new)
    return out


def make_minibatch_fit(kernel: str, batch_size: int, epochs: int,
                       learning_rate: float = 0.01, optimizer=None,
                       n_total: int | None = None,
                       natgrad: float | None = None):
    """One-program minibatch trainer: ``fit(params, x, y, key)``.

    Compiles a single jitted program: an outer ``lax.scan`` over epochs
    (each draws a fresh on-device permutation and drops the remainder, so
    every batch is a uniform random subset — the ELBO's ``n_total / B``
    scaling stays unbiased) and an inner ``lax.scan`` over the epoch's
    batches. Static shapes throughout: no retraces, no host round trips —
    the whole fit is one dispatch.

    ``natgrad``: when set (e.g. 0.5), each batch step interleaves a
    :func:`natgrad_step` on the variational leaves (q_mu, q_raw) with an
    Adam step on everything else (q-gradients masked) — the GPflow
    NaturalGradient + Adam recipe; the conjugate NGD step follows the
    information geometry of q directly and converges in far fewer epochs
    than Adam on the Cholesky parameterization.

    Returns ``(params, epoch_mean_losses)`` with losses shaped (epochs,).
    """
    import optax

    opt = optax.adam(learning_rate) if optimizer is None else optimizer
    q_leaves = ("q_mu", "q_raw")

    def fit(params, x, y, key):
        n = x.shape[0]
        scale_n = n if n_total is None else n_total
        nb = n // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {n}")
        y2 = y[:, None] if y.ndim == 1 else y

        def loss_fn(p, xb, yb):
            return training_loss(kernel, p, xb, yb, scale_n)

        def step(carry, batch):
            p, s = carry
            xb, yb = batch
            if natgrad is not None:
                p = natgrad_step(kernel, p, xb, yb, scale_n, lr=natgrad)
            loss, g = jax.value_and_grad(loss_fn)(p, xb, yb)
            if natgrad is not None:
                g = {k: (jnp.zeros_like(v) if k in q_leaves else v)
                     for k, v in g.items()}
            updates, s = opt.update(g, s, p)
            return (optax.apply_updates(p, updates), s), loss

        def epoch(carry, k):
            perm = jax.random.permutation(k, n)[: nb * batch_size]
            xb = x[perm].reshape(nb, batch_size, x.shape[-1])
            yb = y2[perm].reshape(nb, batch_size, y2.shape[-1])
            carry, losses = lax.scan(step, carry, (xb, yb))
            return carry, jnp.mean(losses)

        opt_state = opt.init(params)
        keys = jax.random.split(key, epochs)
        (params_out, _), hist = lax.scan(epoch, (params, opt_state), keys)
        return params_out, hist

    return jax.jit(fit)


def make_stream_fit(kernel: str, learning_rate: float = 0.01,
                    optimizer=None, natgrad: float | None = None):
    """Host-streamed trainer for archives that live OFF the device.

    :func:`make_minibatch_fit` assumes x/y are device-resident (the fastest
    path when they fit device memory). Production flood archives live in parquet on
    the host, so the realistic bound includes host->device ingestion. This
    returns ``(init, run_chunk)``:

    - ``opt_state = init(params)``
    - ``params, opt_state, losses = run_chunk(params, opt_state, xc, yc)``
      where ``xc`` is (n_batches, B, D) and ``yc`` (n_batches, B, P) — one
      pre-shuffled CHUNK of minibatches, shipped host->device as one
      transfer and scanned through on device.

    The caller streams chunks (`jax.device_put` of the next chunk while the
    current one computes — dispatch is async, so transfers overlap compute
    up to the interconnect's ability) and shuffles on the host, which is
    where a parquet/Arrow reader would do it. ``n_total`` for the ELBO's
    minibatch scaling must be passed per chunk via ``run_chunk``'s
    ``n_total`` argument (the archive size, not the chunk size).

    Same per-step math as :func:`make_minibatch_fit` (optional conjugate
    NGD on q interleaved with Adam on hyperparameters), so the two trainers
    walk identical trajectories given identical batch streams
    (tests/test_svgp.py).
    """
    import optax

    opt = optax.adam(learning_rate) if optimizer is None else optimizer
    q_leaves = ("q_mu", "q_raw")

    def init(params):
        return opt.init(params)

    @partial(jax.jit, static_argnums=(4,))
    def run_chunk(params, opt_state, xc, yc, n_total: int):
        def step(carry, batch):
            p, s = carry
            xb, yb = batch
            if natgrad is not None:
                p = natgrad_step(kernel, p, xb, yb, n_total, lr=natgrad)
            loss, g = jax.value_and_grad(
                lambda pp: training_loss(kernel, pp, xb, yb, n_total))(p)
            if natgrad is not None:
                g = {k: (jnp.zeros_like(v) if k in q_leaves else v)
                     for k, v in g.items()}
            updates, s = opt.update(g, s, p)
            return (optax.apply_updates(p, updates), s), loss

        (params, opt_state), losses = lax.scan(step, (params, opt_state),
                                               (xc, yc))
        return params, opt_state, losses

    return init, run_chunk

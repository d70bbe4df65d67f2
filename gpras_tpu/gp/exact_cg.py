"""Matrix-free exact-GP NLML: batched conjugate gradients + stochastic
Lanczos quadrature (the full BBMM algorithm of Gardner et al. 2018, GPyTorch's
large-N engine — see PAPERS.md).

Every other exact engine in this package (gp/exact.py, exact_lean.py,
exact_stochastic.py) materializes the (N, N) kernel matrix and factorizes it:
O(N^2) device memory caps them (exact_stochastic.dense_n_max). This engine
never stores K at all:

- ``kmv``: K @ V evaluated in **row panels** inside a ``lax.fori_loop`` —
  each iteration rebuilds the (panel, N) Gram tile from x on the fly (one
  matmul + elementwise tail) and contracts it with V — or, on a GPU, the
  fused Pallas kernel (ops/fused.py) that never stores a tile. Peak memory is
  O(N * (panel + rhs)); compute per matvec-batch is one full Gram pass.
- ``mbcg``: modified batched CG (Saad alg. 6.18 with per-column scalars) that
  solves K [y, Z] = [b...] for the target and m probe vectors SIMULTANEOUSLY
  (the Gram pass is amortized over all columns), while recording the Lanczos
  tridiagonal coefficients of every probe column.
- NLML value: quad term from the y-solve (exact up to CG tolerance); logdet
  from SLQ — logdet ~= (1/m) sum_i ||z_i||^2 e1' log(T_i) e1 with T_i the
  probe's tridiagonal (eigh of a (k, k) matrix, trivially in-graph).
- NLML gradient (custom VJP): the same rank-(m+1) cotangent as
  exact_stochastic —  Kbar = 0.5 g [(1/m) W Z' - alpha alpha'] with
  W = K^{-1} Z already produced by the SAME CG solves — contracted against
  dK/dtheta one Gram **column panel** at a time. No factor, no O(N^3) step
  anywhere: a training step costs (iters + 2) Gram passes = O(N^2 (d + m)).

Numerics: CG on a f32 kernel matrix with the default relative jitter behaves
like GPyTorch's f32 BBMM; convergence is governed by cond(K) ~ var/noise.
A Jacobi preconditioner is pointless (the diagonal is constant for stationary
kernels) — the real conditioning dial is ``precond_rank`` (matrix-free
pivoted-Cholesky preconditioner, Gardner et al. sec. 4). Keep ``max_iters``
at or below ~32-48 in f32: without reorthogonalization, long f32 Lanczos
runs grow ghost Ritz values near lambda_min and the SLQ logdet diverges
(at N=8192, noise 1e-2: rank=128/iters=32 lands within 4% of the f64 truth
while the dense f32 Cholesky is NaN outright; iters=64+ explodes regardless
of rank). Raise the preconditioner rank, not the
iteration count.
"""

from __future__ import annotations

import logging
import math
from functools import partial

import jax
import jax.numpy as jnp

_log = logging.getLogger(__name__)

from gpras_tpu.gp.priors import log_prior
from gpras_tpu.ops import fused, linalg
from gpras_tpu.ops import kernels as K

Array = jax.Array


from gpras_tpu.ops.block_cholesky import fit_block as _fit_panel  # canonical


def kmv(kernel: str, params: dict[str, Array], x: Array, v: Array,
        noise: Array, row_panel: int = 4096) -> Array:
    """(K(x,x) + noise I) @ v without materializing K.

    v: (N, R). Returns (N, R). Where ``fused.use_fused`` holds (f32,
    stationary kernel, a supported GPU) this is the fused Pallas kernel
    (ops/fused.kmv): each covariance tile is built and contracted in
    registers, so device-memory traffic is O(N (D + R)) instead of the
    plain path's O(N^2) tile round-trip. Otherwise a fori_loop over
    (panel, N) Gram tiles.
    """
    if fused.use_fused(kernel, x.dtype, v.shape[1]):
        return fused.kmv(kernel, params, x, v) + noise * v
    n = x.shape[0]
    p = _fit_panel(n, row_panel)
    n_panels = n // p

    def body(j, out):
        r0 = j * p
        x_rows = jax.lax.dynamic_slice_in_dim(x, r0, p, axis=0)
        tile = K.gram(kernel, params, x_rows, x)  # (p, N)
        upd = jnp.matmul(tile, v, preferred_element_type=v.dtype)
        return jax.lax.dynamic_update_slice_in_dim(out, upd, r0, axis=0)

    # seed the carry with a data dependence on x so the loop is usable under
    # shard_map (VMA typing: the body output is varying over the mesh axis)
    out0 = jnp.zeros_like(v) + jnp.zeros((), v.dtype) * x[0, 0]
    out = jax.lax.fori_loop(0, n_panels, body, out0)
    return out + noise * v


def pivoted_cholesky(kernel: str, params: dict[str, Array], x: Array,
                     rank: int) -> Array:
    """Rank-``rank`` pivoted (partial) Cholesky of K(x, x) — matrix-free.

    Greedy: pick the largest residual-diagonal entry, evaluate that single
    kernel column k(x, x[piv]) (one (N, 1) Gram build), orthogonalize against
    the factors so far, update the residual diagonal. O(N * rank) memory,
    O(N rank (rank + D)) compute — no (N, N) object anywhere. Returns
    L (N, rank) with K ~= L L^T + residual. This is GPyTorch's BBMM
    preconditioner construction (PAPERS.md, Gardner et al. 2018 sec. 4).
    """
    n = x.shape[0]
    diag = K.kdiag(kernel, params, x)
    l = jnp.zeros((n, rank), x.dtype)

    def step(i, carry):
        l, diag_r = carry
        piv = jnp.argmax(diag_r)
        x_piv = jax.lax.dynamic_slice_in_dim(x, piv, 1, axis=0)  # (1, D)
        col = K.gram(kernel, params, x, x_piv)[:, 0]  # (N,)
        l_piv = jax.lax.dynamic_slice_in_dim(l, piv, 1, axis=0)[0]  # (rank,)
        # mask out factors not yet computed (j >= i)
        mask = (jnp.arange(rank) < i).astype(x.dtype)
        proj = l @ (l_piv * mask)
        d_piv = jnp.maximum(diag_r[piv], 1e-30)
        new_col = (col - proj) / jnp.sqrt(d_piv)
        # zero the column if the residual diagonal is (numerically) exhausted
        new_col = jnp.where(diag_r[piv] > 1e-12 * diag[piv], new_col, 0.0)
        l = l.at[:, i].set(new_col)
        diag_r = jnp.maximum(diag_r - new_col * new_col, 0.0)
        return l, diag_r

    l, _ = jax.lax.fori_loop(0, rank, step, (l, diag))
    return l


def make_woodbury_pinv(l: Array, noise: Array):
    """Apply P^{-1} for P = L L^T + noise I via the Woodbury identity.

    Returns (pinv(v), logdet_P): precomputes the (k, k) capacitance Cholesky.
    det P = noise^(N-k) * det(noise I_k + L^T L).
    """
    n, k = l.shape
    m = noise * jnp.eye(k, dtype=l.dtype) + l.T @ l
    lm = jnp.linalg.cholesky(m)

    def pinv(v):
        t = l.T @ v                                     # (k, R)
        t = jax.scipy.linalg.cho_solve((lm, True), t)   # M^{-1} L^T v
        return (v - l @ t) / noise

    logdet_p = (n - k) * jnp.log(noise) + 2.0 * jnp.sum(
        jnp.log(jnp.maximum(jnp.diagonal(lm), 1e-30)))
    return pinv, logdet_p


def mbcg(matvec, b: Array, max_iters: int = 32, tol: float = 1e-6,
         pinv=None):
    """Modified batched CG: solve A X = b per column, recording Lanczos
    tridiagonal coefficients.

    b: (N, R). Returns (x, alphas, betas, rz0) where alphas/betas are
    (max_iters, R) Lanczos recurrence coefficients (diag / off-diag of T
    derive from them the standard way) and rz0 = b^T P^{-1} b — the SLQ probe
    weights (== ||b||^2 when unpreconditioned). Always runs ``max_iters``
    iterations (static shapes; converged columns freeze via the tolerance
    mask), which keeps the program one fori_loop regardless of conditioning.

    ``pinv`` applies a preconditioner P^{-1}: the iteration becomes standard
    PCG, and the recorded coefficients are the Lanczos tridiagonal of the
    preconditioned operator P^{-1/2} A P^{-1/2} (Saad ch. 9; what the
    preconditioned SLQ quadrature needs).
    """
    n, r = b.shape
    if pinv is None:
        pinv = lambda v: v
    carry, rz0, stop2 = _mbcg_init(b, max_iters, tol, pinv)
    x, _, res, _, alphas, betas, _ = _mbcg_run(
        matvec, carry, 0, max_iters, stop2, pinv)
    return x, alphas, betas, rz0


def _mbcg_init(b: Array, max_iters: int, tol: float, pinv):
    """Initial mbcg carry + (rz0, stop2) — split out so the host-chunked
    runner (cg_solves_chunked) can share the exact same state machine."""
    r = b.shape[1]
    b2 = jnp.sum(b * b, axis=0)
    stop2 = (tol * tol) * b2
    z0 = pinv(b)
    rz0 = jnp.sum(b * z0, axis=0)
    x0 = jnp.zeros_like(b)
    # a data dependence on b gives the fresh carries b's varying mesh axes,
    # so the loop also runs under shard_map (sharded prediction)
    zero = jnp.zeros((), b.dtype) * b[0, 0]
    alphas = jnp.zeros((max_iters, r), b.dtype) + zero
    betas = jnp.zeros((max_iters, r), b.dtype) + zero
    done0 = jnp.zeros((r,), bool) & jnp.isfinite(zero)
    return (x0, z0, b, rz0, alphas, betas, done0), rz0, stop2


def _mbcg_run(matvec, carry, start: int, stop: int, stop2, pinv):
    """fori_loop over mbcg iterations [start, stop) — identical math to the
    monolithic loop, so segmenting changes nothing numerically."""

    def body(i, carry):
        x, p, res, rz, alphas, betas, done = carry
        ap = matvec(p)
        pap = jnp.sum(p * ap, axis=0)
        # breakdown guard: in f32, once the residual stagnates near machine
        # precision, curvature (p'Ap) or residual energy (r'P^{-1}r) can go
        # non-positive/non-finite; recording those iterations would inject
        # spurious Ritz values into the SLQ tridiagonal (log of a garbage
        # eigenvalue). Freeze such columns permanently.
        broken = (pap <= 0) | ~jnp.isfinite(pap)
        done_now = done | broken
        alpha = jnp.where(done_now, 0.0, rz / jnp.where(pap > 0, pap, 1.0))
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * ap
        z = pinv(res)
        rz_new = jnp.sum(res * z, axis=0)
        res2 = jnp.sum(res * res, axis=0)
        broken2 = (rz_new <= 0) | ~jnp.isfinite(rz_new)
        beta = jnp.where(done_now | broken2, 0.0,
                         rz_new / jnp.where(rz > 0, rz, 1.0))
        p = z + beta[None, :] * p
        alphas = alphas.at[i].set(alpha)
        betas = betas.at[i].set(beta)
        done = done_now | broken2 | (res2 <= stop2)
        rz_next = jnp.where(done, rz, rz_new)
        return x, p, res, rz_next, alphas, betas, done

    return jax.lax.fori_loop(start, stop, body, carry)


def _slq_logdet_from_coeffs(alphas: Array, betas: Array, b2: Array) -> Array:
    """Stochastic Lanczos quadrature: rebuild each probe's tridiagonal T from
    its CG coefficients and average ||z||^2 e1' log(T) e1.

    alphas/betas: (k, m) CG step/conjugacy coefficients for the m PROBE
    columns; b2: (m,) squared probe norms. Standard identities
    (Saad; GPyTorch's linear_cg): T[0,0] = 1/alpha_0,
    T[j,j] = 1/alpha_j + beta_{j-1}/alpha_{j-1},
    T[j-1,j] = T[j,j-1] = sqrt(beta_{j-1})/alpha_{j-1}.
    Zero alphas (frozen converged columns) are padded with identity rows so
    log(eigenvalue)=0 contributes nothing.
    """
    k, m = alphas.shape

    def one_probe(a, bt, nrm2):
        safe_a = jnp.where(a > 0, a, 1.0)
        active = a > 0
        diag = 1.0 / safe_a
        diag = diag.at[1:].add(jnp.where(active[:-1], bt[:-1] / safe_a[:-1], 0.0))
        # off-diagonal j<->j+1 exists only when BOTH nodes are active —
        # otherwise the last real Lanczos node couples into the identity
        # padding and shifts every Ritz value (breakdown-frozen columns
        # record beta[i-1] = O(1) right before the freeze)
        off = jnp.where(active[:-1] & active[1:],
                        jnp.sqrt(jnp.maximum(bt[:-1], 0.0)) / safe_a[:-1], 0.0)
        diag = jnp.where(active, diag, 1.0)  # identity padding
        t = jnp.diag(diag) + jnp.diag(off, 1) + jnp.diag(off, -1)
        evals, evecs = jnp.linalg.eigh(t)
        w = evecs[0, :] ** 2
        return nrm2 * jnp.sum(w * jnp.log(jnp.maximum(evals, 1e-30)))

    vals = jax.vmap(one_probe, in_axes=(1, 1, 0))(alphas, betas, b2)
    return jnp.mean(vals)


def slq_logdet_rr(kernel: str, params: dict[str, Array], x: Array,
                  key: Array, probes: int = 16, base_iters: int = 16,
                  seg_iters: int = 8, n_tail: int = 8, q: float = 0.6,
                  precond_rank: int = 0) -> Array:
    """Russian-roulette SLQ: randomized-truncation logdet of (K + noise I).

    NOT jit-safe (unlike everything else in this module): the truncation
    depth J is sampled on the HOST from ``key`` via float(), so this
    function cannot appear under jit/vmap; each distinct sampled depth
    compiles its own ``_rr_inner`` program (at most ``n_tail + 1``,
    cached across calls).

    The truncated CG+SLQ logdet at a fixed shallow depth is BIASED — the
    failure mode of the giant-N cold fits (a linesearch optimizer steers into hyperparameter regions
    where the depth-k quadrature undershoots the physically possible NLML
    by thousands of nats). This estimator removes the truncation bias the
    randomized-truncation way (Kahn's russian roulette; Lyne et al. 2015
    for pseudo-marginal MCMC): telescope the quadrature over checkpoint
    depths k_j = base + j*seg,

        Q_K = Q_0 + sum_{j=1..n_tail} (Q_j - Q_{j-1}),

    sample a truncation J = min(G, n_tail) with geometric survival
    P(J >= j) = q**j, run mbcg only to depth k_J, and reweight the
    surviving increments by 1/q**j. E[estimate] is EXACTLY the deep-budget
    quadrature Q_{n_tail} (the telescoped sum is finite, so unbiasedness
    needs no tail-convergence assumption), while the expected depth is
    base + seg * q/(1-q) iterations — e.g. q=0.6, seg=8: base + 12,
    against a deep budget of base + 64 at n_tail=8.

    Caveats, stated plainly: (a) the target is the DEPTH-K_max quadrature —
    set ``base_iters + n_tail*seg_iters`` where the quadrature is measured
    converged (and no deeper: past ~32-48 unpreconditioned f32 Lanczos
    steps, ghost Ritz values corrupt T — raise ``precond_rank`` instead,
    module docstring); (b) the variance of the reweighted increments grows
    as (decay_rate/q)^j — pick q at or above the observed increment decay;
    (c) given a FIXED key the estimate is a deterministic function of
    params whose pointwise value still deviates from the truth, so a
    linesearch can in principle exploit a fixed-key RR objective the same
    way it exploits fixed truncation — the production cold-fit protocol
    therefore keeps the residual-gated deep budget (gp/coldfit.py), and
    this estimator serves value estimation / fresh-key-per-step SGD, where
    unbiasedness is the property that matters.

    Probes are Rademacher (``precond_rank=0``) or N(0, P) with the
    preconditioned quadrature + analytic Woodbury ``logdet P`` correction
    (Gardner et al. 2018 sec. 4), exactly as in ``make_cg_nlml``. Returns
    a scalar; the host samples J from ``key`` (deterministic), so distinct
    J values compile distinct mbcg depths (at most ``n_tail + 1`` shapes).
    """
    k_depth, k_probe = jax.random.split(key)
    # J = min(G, n_tail) with P(G >= j) = q**j, from one uniform
    u = float(jax.random.uniform(k_depth, ()))
    g = int(math.floor(math.log(max(u, 1e-30)) / math.log(q)))
    j_trunc = min(g, n_tail)
    return _rr_inner(kernel, params, x, k_probe, probes, base_iters,
                     seg_iters, j_trunc, q, precond_rank)


@partial(jax.jit, static_argnames=("kernel", "probes", "base_iters",
                                   "seg_iters", "j_trunc", "q",
                                   "precond_rank"))
def _rr_inner(kernel: str, params, x: Array, k_probe: Array, probes: int,
              base_iters: int, seg_iters: int, j_trunc: int, q: float,
              precond_rank: int) -> Array:
    """slq_logdet_rr's jitted body — one compiled program per sampled
    truncation depth (at most n_tail + 1), cached across calls."""
    n = x.shape[0]
    noise = jnp.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
    depth = base_iters + j_trunc * seg_iters

    if precond_rank > 0:
        l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
        pinv, logdet_p = make_woodbury_pinv(l_pc, noise)
        k1, k2 = jax.random.split(k_probe)
        u1 = jax.random.normal(k1, (precond_rank, probes), x.dtype)
        u2 = jax.random.normal(k2, (n, probes), x.dtype)
        z = l_pc @ u1 + jnp.sqrt(noise) * u2
    else:
        pinv, logdet_p = None, jnp.zeros((), x.dtype)
        z = jax.random.rademacher(k_probe, (n, probes), dtype=x.dtype)

    mv = lambda v: kmv(kernel, params, x, v, noise)
    _, alphas, betas, rz0 = mbcg(mv, z, max_iters=depth, tol=1e-12,
                                 pinv=pinv)

    def q_at(k_nodes: int) -> Array:
        m = (jnp.arange(depth) < k_nodes).astype(alphas.dtype)[:, None]
        return _slq_logdet_from_coeffs(alphas * m, betas * m, rz0)

    qs = [q_at(base_iters + j * seg_iters) for j in range(j_trunc + 1)]
    est = qs[0]
    for j in range(1, j_trunc + 1):
        est = est + (qs[j] - qs[j - 1]) / (q ** j)
    return est + logdet_p


def make_cg_nlml(kernel: str, probes: int = 16, max_iters: int = 32,
                 row_panel: int = 4096, col_panel: int = 4096,
                 precond_rank: int = 0,
                 residual_gate: float | None = None):
    """Returns ``nlml(params, x, y, key)``: matrix-free value + gradient.

    The value's logdet term and the gradient's trace term are stochastic
    (probes); the quad term is exact up to CG tolerance. Pass a fresh key per
    step. Differentiable w.r.t. params and y.

    ``precond_rank`` > 0 enables the full BBMM preconditioned path
    (Gardner et al. 2018 sec. 4): a rank-k matrix-free pivoted Cholesky
    P = L_k L_k^T + noise I drives PCG (fewer iterations when the fitted
    noise is small), probes are drawn from N(0, P) (z = L u1 + sqrt(noise)
    u2) so that
        logdet K = logdet P + E[(z^T P^{-1} z) e1' log(T_pcg) e1]
    with logdet P analytic via the (k, k) Woodbury capacitance, and the
    gradient trace uses E[z z^T] = P:
        tr(K^{-1} dK) = E[(K^{-1} z)^T dK (P^{-1} z)].

    ``residual_gate`` mirrors ``make_cg_step_chunked``'s solver-validity
    gate: if any column's final relative CG residual exceeds the gate, the
    VALUE is +inf (the gradient at such a point is estimator noise anyway) —
    so a linesearch rejects the trial instead of descending into the
    truncated-SLQ bias regions (see that function's docstring).
    """

    def solves(params, x, y, key):
        n = x.shape[0]
        noise = jnp.exp(params["log_noise_variance"])
        jitter = linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        total_noise = noise + jitter
        if precond_rank > 0:
            l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
            pinv, logdet_p = make_woodbury_pinv(l_pc, total_noise)
            k1, k2 = jax.random.split(key)
            u1 = jax.random.normal(k1, (precond_rank, probes), x.dtype)
            u2 = jax.random.normal(k2, (n, probes), x.dtype)
            z = l_pc @ u1 + jnp.sqrt(total_noise) * u2  # z ~ N(0, P)
        else:
            pinv, logdet_p = None, 0.0
            z = jax.random.rademacher(key, (n, probes), dtype=x.dtype)
        b = jnp.concatenate([y[:, None], z], axis=1)
        mv = lambda v: kmv(kernel, params, x, v, total_noise, row_panel)
        carry, rz0, stop2 = _mbcg_init(b, max_iters, 1e-6,
                                       pinv if pinv is not None
                                       else (lambda v: v))
        sol, _, res, _, alphas, betas, _ = _mbcg_run(
            mv, carry, 0, max_iters, stop2,
            pinv if pinv is not None else (lambda v: v))
        alpha_y = sol[:, 0]
        w = sol[:, 1:]
        logdet = logdet_p + _slq_logdet_from_coeffs(
            alphas[:, 1:], betas[:, 1:], rz0[1:])
        v = pinv(z) if precond_rank > 0 else z
        if residual_gate is not None:
            b2 = jnp.sum(b * b, axis=0)
            rel2 = jnp.sum(res * res, axis=0) / jnp.maximum(b2, 1e-30)
            gated = jnp.max(rel2) > residual_gate * residual_gate
        else:
            gated = jnp.zeros((), bool)
        return alpha_y, w, v, logdet, gated

    def _gate(out, gated):
        return jnp.where(gated, jnp.asarray(jnp.inf, out.dtype), out)

    def value(params, x, y, key):
        n = x.shape[0]
        alpha_y, _, _, logdet, gated = solves(params, x, y, key)
        quad = 0.5 * jnp.vdot(y, alpha_y)
        return _gate(quad + 0.5 * logdet
                     + 0.5 * n * math.log(2.0 * math.pi), gated)

    @jax.custom_vjp
    def nlml(params, x, y, key):
        return value(params, x, y, key)

    def fwd(params, x, y, key):
        n = x.shape[0]
        alpha_y, w, v, logdet, gated = solves(params, x, y, key)
        quad = 0.5 * jnp.vdot(y, alpha_y)
        out = _gate(quad + 0.5 * logdet
                    + 0.5 * n * math.log(2.0 * math.pi), gated)
        return out, (params, x, alpha_y, w, v)

    def bwd(res, g):
        params, x, alpha, w, v = res
        # cast a possibly weak-f64-promoted cotangent (e.g. optax zoom
        # linesearch under jax_enable_x64) back to the engine dtype
        g = jnp.asarray(g, x.dtype)
        grads = _cotangent_grads(kernel, params, x, alpha, w, v, g,
                                 1.0 / probes, col_panel)
        return grads, jnp.zeros_like(x), g * alpha, None

    nlml.defvjp(fwd, bwd)
    return nlml


def _cotangent_grads(kernel: str, params, x: Array, alpha: Array, w: Array,
                     v: Array, g, inv_m: float, col_panel: int):
    """dNLML/dparams from the rank-(m+1) cotangent
    Kbar = 0.5 g [(1/m) W V^T - alpha alpha^T]  (v = P^{-1} z under
    preconditioning, z itself otherwise:
    tr(K^{-1} dK) = E_{z~N(0,P)}[(K^{-1}z)^T dK (P^{-1}z)]).

    Where ``fused.use_fused`` holds: the fused Pallas contraction
    (ops/fused.kgrad) — no (N, panel) Gram tile, cotangent or autodiff
    residual in device memory. Otherwise the Gram-vjp panel loop. The O(N m)
    diagonal term for the noise/jitter gradient is computed directly.
    Shared by the jitted custom-VJP backwards (this engine's and
    exact_stochastic's) and the host-chunked step."""
    n = x.shape[0]
    if fused.use_fused(kernel, x.dtype):
        fg = fused.kgrad(kernel, params, x, w, v, alpha, g=g, inv_m=inv_m)
        diag_sum = 0.5 * g * (inv_m * jnp.sum(w * v)
                              - jnp.sum(alpha * alpha))
        grads = jax.tree.map(jnp.zeros_like, params)
        grads["log_variance"] = fg["log_variance"].astype(x.dtype)
        grads["log_lengthscales"] = fg["log_lengthscales"].astype(x.dtype)
        return _add_diag_grads(grads, params, diag_sum, x.dtype)

    r = _fit_panel(n, col_panel)
    n_panels = n // r

    def panel_step(j, carry):
        grads_acc, diag_acc = carry
        c0 = j * r
        x_cols = jax.lax.dynamic_slice_in_dim(x, c0, r, axis=0)
        v_cols = jax.lax.dynamic_slice_in_dim(v, c0, r, axis=0)
        a_cols = jax.lax.dynamic_slice_in_dim(alpha, c0, r, axis=0)
        kbar = 0.5 * g * (inv_m * (w @ v_cols.T)
                          - alpha[:, None] * a_cols[None, :])
        idx = jnp.arange(r)
        diag_acc = diag_acc + jnp.sum(kbar[c0 + idx, idx])
        _, pullback = jax.vjp(
            lambda pp: K.gram(kernel, pp, x, x_cols), params)
        (grads_t,) = pullback(kbar)
        return jax.tree.map(jnp.add, grads_acc, grads_t), diag_acc

    zero = jax.tree.map(jnp.zeros_like, params)
    grads, diag_sum = jax.lax.fori_loop(
        0, n_panels, panel_step, (zero, jnp.zeros((), x.dtype)))
    return _add_diag_grads(grads, params, diag_sum, x.dtype)


def _add_diag_grads(grads, params, diag_sum, dtype):
    """Add the gradient of the noise + relative-jitter diagonal, whose
    cotangent sum is ``diag_sum``."""
    grads["log_noise_variance"] = grads["log_noise_variance"] + \
        diag_sum * jnp.exp(params["log_noise_variance"])
    grads["log_variance"] = grads["log_variance"] + \
        diag_sum * linalg.default_jitter(dtype) * jnp.exp(params["log_variance"])
    return grads


def make_cg_training_loss(kernel: str, probes: int = 16, max_iters: int = 32,
                          **kwargs):
    nlml = make_cg_nlml(kernel, probes, max_iters, **kwargs)

    def loss(params, x, y, key):
        return nlml(params, x, y, key) - log_prior(params)

    return loss


def gate_abort_decision(rel_hist: list[float], rel: float, segs_ran: int,
                        n_segs: int, gate: float) -> bool:
    """The chunked-CG gate-abort rule, as a pure host-side predicate.

    Abort (return True) only when BOTH hold:
    - the decay is NEAR-STALLED: the best per-segment improvement ratio ever
      observed in this solve is >= 0.9 (the measured bias-region linesearch
      trials — residuals 0.8-85 — never beat that; any solve that once
      decayed faster may be mid Ritz-value convergence and can accelerate
      again, so it is never aborted);
    - even projecting that best ratio over every remaining segment leaves
      the final residual above 4x the gate.

    Healthy solves are protected twice over: CG decay ACCELERATES late
    (superlinear as Ritz values converge — the measured rank-1024 131k run
    falls 0.90 -> 0.08 over the back half), so a solve with any sub-0.9
    segment is left to run; and a solve frozen by convergence/breakdown is
    caught by the cheaper ``early_exit`` path, not this rule.
    """
    if segs_ran < 4:
        return False  # the projection needs history to mean anything
    ratios = [rel_hist[i + 1] / rel_hist[i]
              for i in range(len(rel_hist) - 1) if rel_hist[i] > 0]
    r_best = min(1.0, min(ratios)) if ratios else 1.0
    if r_best < 0.9:
        return False  # decay not stalled: late acceleration is plausible
    projected = rel * r_best ** (n_segs - segs_ran)
    return projected > 4.0 * gate


def make_cg_step_chunked(kernel: str, probes: int = 127, max_iters: int = 24,
                         seg_iters: int = 4, col_panel: int = 4096,
                         tol: float = 1e-6, precond_rank: int = 0,
                         residual_gate: float | None = None,
                         early_exit: bool = True,
                         gate_abort: bool = True):
    """Training-loss value + gradient for GIANT N, dispatched as several
    device programs instead of one.

    Why: chunking the CG loop into ``seg_iters``-iteration programs lets
    the host stop an evaluation as soon as its outcome is known (early exit,
    gate abort below) and keeps every program short at giant N; the
    segments dispatch back-to-back WITHOUT host synchronization (in-order
    device stream), so the only overhead is per-dispatch latency, and the
    math is bit-identical to the monolithic loop (_mbcg_run is the same
    state machine).

    Returns ``step(params, x, y, key) -> (loss, grads)`` (host function;
    the pieces are jitted and cached across calls).

    ``precond_rank`` > 0 mirrors make_cg_nlml's full BBMM preconditioned
    estimator (pivoted-Cholesky Woodbury PCG, probes drawn from N(0, P),
    logdet = logdet_P + preconditioned SLQ, trace with v = P^{-1} z) — the
    rank-k factor rides through the segments as an array and the (k, k)
    capacitance is re-factorized per program (negligible). Same key
    semantics as make_cg_nlml, so values/grads are bit-comparable.

    ``residual_gate`` defines the SOLVER-VALIDITY region: if any column's
    final relative CG residual exceeds the gate, the loss is returned as
    +inf (the gradient is garbage there anyway). Rationale: a linesearch optimizer on the
    truncated CG+SLQ objective finds hyperparameter regions where the
    un-converged estimator is biased thousands of nats BELOW the physically
    possible NLML and walks into them; gating turns those regions into
    rejected trials instead of fake minima.

    ``early_exit`` (default on): the host boundary between segments checks
    the mbcg ``done`` mask and stops dispatching once EVERY column has
    converged to ``tol`` (or frozen on breakdown). Skipping the remaining
    segments is BIT-IDENTICAL to running them: a fully-frozen carry is a
    fixed point of the mbcg body on every output ``finish`` reads (alpha
    and beta forced to 0, x/res/coefficients unchanged — only the unused
    search direction keeps evolving). The per-segment scalar fetch is one
    host round trip per segment, lagged one segment behind the dispatch
    stream; the payoff is that well-conditioned
    evaluations (early linesearch trials at cold-init noise) stop at the
    tolerance instead of burning the full ``max_iters`` budget sized for
    the hardest region. The number of segments actually dispatched on the
    last call is exposed as ``step.last_segments`` — a single-threaded
    DEBUG aid only: it is a mutable attribute on the shared closure,
    overwritten per call, so under concurrent use of one ``step`` across
    threads the value observed may belong to a different call.

    ``gate_abort`` (default on; active only with a ``residual_gate``):
    stop dispatching segments once the gate outcome is already decided —
    when the residual decay is NEAR-STALLED (best observed per-segment
    improvement ratio >= 0.9, matching the measured bias-region
    linesearch trials: residuals 0.8-85 with ratios near 1) AND even
    projecting that best ratio over every remaining segment leaves the
    final residual above 4x the gate. The stall precondition is what
    makes the projection sound: CG decay ACCELERATES as Ritz values
    converge (the measured rank-1024 131k run drops 0.90 -> 0.08 over
    the back half, benchmarks/precond_sweep.py), so an early best ratio
    alone would OVER-estimate the final residual of a healthy solve and
    could abort a trial the full budget would have brought inside the
    gate; a solve whose decay never beats 0.9 per segment has no
    converged-Ritz acceleration under way to mispredict. The decision is
    the pure predicate ``gate_abort_decision`` (unit-tested on synthetic
    histories), and each abort is logged (module logger, INFO) with the
    residual, gate, and recent history so any misprediction is visible in
    production logs. After an abort,
    ``finish`` runs on the current carry and its gate fires on the
    (still above-gate) residuals, so the returned loss is the same +inf
    the full budget would have produced."""
    if max_iters % seg_iters != 0:
        raise ValueError(f"seg_iters {seg_iters} must divide max_iters "
                         f"{max_iters}")
    inv_m = 1.0 / probes
    identity = lambda v: v

    def _pinv(l_pc, noise):
        if precond_rank > 0:
            return make_woodbury_pinv(l_pc, noise)
        return identity, jnp.zeros((), noise.dtype)

    @jax.jit
    def setup(params, x, y, key):
        n = x.shape[0]
        noise = jnp.exp(params["log_noise_variance"]) + \
            linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        if precond_rank > 0:
            l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
            k1, k2 = jax.random.split(key)
            u1 = jax.random.normal(k1, (precond_rank, probes), x.dtype)
            u2 = jax.random.normal(k2, (n, probes), x.dtype)
            z = l_pc @ u1 + jnp.sqrt(noise) * u2  # z ~ N(0, P)
        else:
            l_pc = jnp.zeros((n, 0), x.dtype)
            z = jax.random.rademacher(key, (n, probes), dtype=x.dtype)
        pinv, _ = _pinv(l_pc, noise)
        b = jnp.concatenate([y[:, None], z], axis=1)
        carry, rz0, stop2 = _mbcg_init(b, max_iters, tol, pinv)
        return carry, rz0, stop2, z, noise, l_pc, jnp.sum(b * b, axis=0)

    @jax.jit
    def segment(params, x, carry, extras, i0):
        # i0 traced (fori_loop lowers to while_loop): ONE compiled program
        # serves every segment offset
        noise, stop2, l_pc = extras
        pinv, _ = _pinv(l_pc, noise)
        mv = lambda vv: kmv(kernel, params, x, vv, noise)
        return _mbcg_run(mv, carry, i0, i0 + seg_iters, stop2, pinv)

    @jax.jit
    def finish(params, x, y, carry, rz0, z, noise, l_pc, b2):
        sol, _, res, _, alphas, betas, _ = carry
        n = x.shape[0]
        alpha_y = sol[:, 0]
        w = sol[:, 1:]
        pinv, logdet_p = _pinv(l_pc, noise)
        logdet = logdet_p + _slq_logdet_from_coeffs(alphas[:, 1:],
                                                    betas[:, 1:], rz0[1:])
        quad = 0.5 * jnp.vdot(y, alpha_y)
        loss = quad + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi) \
            - log_prior(params)
        if residual_gate is not None:
            rel2 = jnp.sum(res * res, axis=0) / jnp.maximum(b2, 1e-30)
            loss = jnp.where(
                jnp.max(rel2) > residual_gate * residual_gate,
                jnp.asarray(jnp.inf, loss.dtype), loss)
        v = pinv(z) if precond_rank > 0 else z
        grads = _cotangent_grads(kernel, params, x, alpha_y, w, v,
                                 jnp.ones((), x.dtype), inv_m, col_panel)
        prior_grads = jax.grad(log_prior)(params)
        grads = jax.tree.map(lambda a, b_: a - b_, grads, prior_grads)
        return loss, grads

    n_segs = max_iters // seg_iters

    @jax.jit
    def probe_state(carry, b2):
        # one fetch per segment serves both host decisions: (all frozen,
        # max relative residual)
        res = carry[2]
        rel2 = jnp.sum(res * res, axis=0) / jnp.maximum(b2, 1e-30)
        return jnp.all(carry[6]), jnp.sqrt(jnp.max(rel2))

    def step(params, x, y, key):
        carry, rz0, stop2, z, noise, l_pc, b2 = setup(params, x, y, key)
        ran = 0
        rel_hist: list[float] = []
        check = early_exit or (gate_abort and residual_gate is not None)
        # the host decision lags one segment behind the dispatch stream:
        # segment k+1 is already enqueued when segment k's probe is
        # fetched, so the device never idles on the fetch round trip;
        # stopping
        # one segment late is bit-identical for the early exit (frozen
        # fixed point) and immaterial for the abort (+inf either way)
        prev_probe = None
        prev_ran = 0
        for k, i0 in enumerate(range(0, max_iters, seg_iters)):
            carry = segment(params, x, carry, (noise, stop2, l_pc), i0)
            ran = k + 1
            if not check or ran >= n_segs:
                continue
            cur = probe_state(carry, b2)
            stop = False
            if prev_probe is not None:
                all_done, rel = jax.device_get(prev_probe)
                if early_exit and bool(all_done):
                    stop = True
                elif gate_abort and residual_gate is not None:
                    rel_hist.append(float(rel))
                    if gate_abort_decision(rel_hist, float(rel), prev_ran,
                                           n_segs, residual_gate):
                        _log.info(
                            "cg gate_abort at segment %d/%d: rel=%.3g "
                            "gate=%.3g history=%s", prev_ran, n_segs,
                            float(rel), residual_gate,
                            ["%.3g" % r for r in rel_hist[-4:]])
                        # finish()'s gate fires on these residuals
                        stop = True
            if stop:
                break
            prev_probe, prev_ran = cur, ran
        step.last_segments = ran
        return finish(params, x, y, carry, rz0, z, noise, l_pc, b2)

    step.last_segments = 0
    return step


def kmv_cross(kernel: str, params: dict[str, Array], x1: Array, x2: Array,
              v: Array, row_panel: int = 4096) -> Array:
    """k(x1, x2) @ v streamed over row panels of x1 (never stores the cross
    Gram). v: (N2, R) -> (N1, R)."""
    if fused.use_fused(kernel, x1.dtype, v.shape[1]):
        return fused.kmv(kernel, params, x1, v, x2)
    n1 = x1.shape[0]
    p = _fit_panel(n1, row_panel)

    def body(j, out):
        r0 = j * p
        rows = jax.lax.dynamic_slice_in_dim(x1, r0, p, axis=0)
        tile = K.gram(kernel, params, rows, x2)
        upd = jnp.matmul(tile, v, preferred_element_type=v.dtype)
        return jax.lax.dynamic_update_slice_in_dim(out, upd, r0, axis=0)

    out = jnp.zeros((n1,) + v.shape[1:], v.dtype) + \
        jnp.zeros((), v.dtype) * x1[0, 0]
    return jax.lax.fori_loop(0, n1 // p, body, out)


def cg_posterior_alpha(kernel: str, params: dict[str, Array], x: Array,
                       y: Array, max_iters: int = 64,
                       row_panel: int = 4096,
                       precond_rank: int = 32) -> Array:
    """alpha = (K + noise I)^{-1} y via batched PCG (matrix-free); a rank-k
    pivoted-Cholesky preconditioner keeps the solve accurate at small fitted
    noise (precond_rank=0 disables it)."""
    noise = jnp.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
    mv = lambda v: kmv(kernel, params, x, v, noise, row_panel)
    pinv = None
    if precond_rank > 0:
        l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
        pinv, _ = make_woodbury_pinv(l_pc, noise)
    y2 = y[:, None] if y.ndim == 1 else y
    sol, _, _, _ = mbcg(mv, y2, max_iters=max_iters, pinv=pinv)
    return sol[:, 0] if y.ndim == 1 else sol


def cg_predict(kernel: str, params: dict[str, Array], x: Array, y: Array,
               x_test: Array, alpha: Array | None = None,
               max_iters: int = 64, row_panel: int = 4096,
               var_chunk: int = 256, precond_rank: int = 32,
               l_pc: Array | None = None) -> tuple[Array, Array]:
    """Matrix-free posterior (mean, variance) of y* at x_test.

    mean = k(x*, X) alpha;  var_i = k(x*_i,x*_i) − k_i* K^{-1} k_i*^T + noise,
    with the per-test-point solves batched ``var_chunk`` columns at a time
    (each chunk is one batched-CG run; memory O(N * var_chunk)). The exact
    posterior of the dense engine, evaluated without ever forming K.
    """
    if alpha is None:
        alpha = cg_posterior_alpha(kernel, params, x, y, max_iters, row_panel,
                                   precond_rank)
    mean = kmv_cross(kernel, params, x_test, x, alpha[:, None],
                     row_panel)[:, 0]
    noise = jnp.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
    mv = lambda v: kmv(kernel, params, x, v, noise, row_panel)
    pinv = None
    if l_pc is None and precond_rank > 0:
        # (serving callers precompute l_pc once per model — it depends only
        # on params/x — instead of paying O(N k^2) per predict call)
        l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
    if l_pc is not None:
        pinv, _ = make_woodbury_pinv(l_pc, noise)
    s = x_test.shape[0]
    c = _fit_panel(s, var_chunk)

    def chunk(j, var_out):
        c0 = j * c
        xq = jax.lax.dynamic_slice_in_dim(x_test, c0, c, axis=0)
        ks = K.gram(kernel, params, x, xq)  # (N, c) tile
        sol, _, _, _ = mbcg(mv, ks, max_iters=max_iters, pinv=pinv)
        quad = jnp.sum(ks * sol, axis=0)
        return jax.lax.dynamic_update_slice_in_dim(var_out, quad, c0, axis=0)

    # seeded from x_test so the carry is varying under shard_map
    quad0 = jnp.zeros((s,), x.dtype) + jnp.zeros((), x.dtype) * x_test[0, 0]
    quad_all = jax.lax.fori_loop(0, s // c, chunk, quad0)
    var = K.kdiag(kernel, params, x_test) - quad_all
    var = jnp.maximum(var, 0.0) + jnp.exp(params["log_noise_variance"])
    return mean, var

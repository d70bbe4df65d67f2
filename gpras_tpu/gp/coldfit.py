"""Cold exact-GP fits from standard init: the measured fastest protocol.

The reference's only training loop is fixed-lr Adam with a plateau rule
(gpras/gpr.py:44-214); cold-fitting a large-N exact GP that way costs 600+
steps. This module packages a faster cold protocol as a library call:
zoom-linesearch L-BFGS through the host-chunked driver
(fit/optimizers.lbfgs_fit_chunked), over the engine the problem size calls
for (the dense ceiling is exact_stochastic.dense_n_max, derived from the
device's memory):

- N at or below the ceiling: Hutchinson stochastic-trace loss over the
  in-place super-panel factorization (the (N, N) Gram fits the device).
  At N=49,152 it enters the 600-step-Adam L* stopping band at L-BFGS
  iteration 23.
- Above it: matrix-free BBMM CG+SLQ (the Gram matrix never exists), run
  HONESTLY: rank-128 pivoted-Cholesky preconditioning, 256 CG iterations,
  and a solver-validity residual gate. The cheap 24-iteration estimator
  (the bench step-timing unit) is NOT linesearch-safe — measured at
  131k/262k, L-BFGS finds hyperparameter regions where the truncated
  SLQ logdet is biased thousands of nats below the physically possible
  NLML (per-point NLML cannot beat the true model's entropy, ~-0.884 for
  the bench DGP; the exploited trajectories reached -1.7 to -4.3/pt) and
  walks into them until every nearby evaluation goes non-finite. With
  (256 iters, rank 128) the true-noise region solves to y-residual 1.8% /
  probe max 5.2% (measured at 131k), inside the 0.1 gate, while the bias
  regions (residuals 0.8-85) are rejected as trials.
- The CG engine defaults to the HOST linesearch
  (fit/optimizers.lbfgs_fit_hostls): each evaluation dispatches as
  seg_iters-iteration CG segment programs (exact_cg.make_cg_step_chunked),
  so the host can stop an evaluation early once CG has converged or its
  residual gate is decided, and no program grows with the linesearch.
  Passing ``host_linesearch=False`` forces the monolithic device path
  (same preconditioner and residual gate, one jitted program per
  linesearch eval).

The loss is made a pure function by fixing the probe key: Hutchinson
randomizes only the gradient estimator and SLQ's quadrature is
deterministic given the probes, so the linesearch sees a deterministic
objective and the whole trajectory reproduces bit-for-bit.

``benchmarks/lbfgs_cold.py`` is the measured protocol driving this API.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import jax

from gpras_tpu.fit.optimizers import lbfgs_fit_chunked
from gpras_tpu.gp import exact
from gpras_tpu.gp.exact_stochastic import dense_n_max

Array = jax.Array


def _dense_loss(kernel: str, n: int, probes: int):
    # engine knobs: the shared policy — one source of truth with
    # GPRAS._loss_fn and bench.py
    from gpras_tpu.gp.exact_stochastic import (default_chol_config,
                                               make_hutchinson_training_loss)

    return make_hutchinson_training_loss(kernel, probes=probes,
                                         col_panel=4096,
                                         **default_chol_config(n))


def _cg_loss(kernel: str, probes: int, cg_iters: int, precond_rank: int,
             residual_gate: float | None):
    from gpras_tpu.gp.exact_cg import make_cg_training_loss

    return make_cg_training_loss(kernel, probes=probes, max_iters=cg_iters,
                                 row_panel=4096, col_panel=4096,
                                 precond_rank=precond_rank,
                                 residual_gate=residual_gate)


def fit_exact(
    kernel: str,
    x: Array,
    y: Array,
    *,
    engine: str = "auto",
    max_iter: int | None = None,
    chunk: int | None = None,
    memory_size: int = 15,
    max_linesearch_steps: int | None = None,
    tol: float = 1e-5,
    patience: int = 10,
    stop_loss: float | None = None,
    stop_decrease: float | None = None,
    noise_variance: float = 0.1,
    noise_floor: float | None = None,
    probes: int | None = None,
    cg_iters: int = 256,
    seg_iters: int = 16,
    precond_rank: int = 128,
    residual_gate: float | None = 0.1,
    cg_stop_tol: float = 0.02,
    host_linesearch: bool | None = None,
    key: Array | None = None,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[dict[str, Array], dict[str, Any]]:
    """Cold-fit an exact GP's hyperparameters from standard init.

    Engine ``auto`` picks Hutchinson up to exact_stochastic.dense_n_max()
    and matrix-free CG above (override to ``"hutchinson"``/``"cg"`` to
    force); ``host_linesearch`` (auto: on for every CG-engine fit) moves the
    strong-Wolfe linesearch to the host and dispatches each evaluation as
    ``seg_iters``-iteration CG segments; ``host_linesearch=False``
    keeps the same preconditioned, residual-gated objective in one jitted
    program per evaluation (``seg_iters`` then has no effect). ``patience``
    counts L-BFGS ITERATIONS (each costs 1-3 NLML evaluations, so the
    reference's patience=50 — tuned for 1-eval Adam steps,
    gpras/gpr.py:162-173 — would waste many minutes post-plateau; the
    measured plateau-to-rule-fire tail at 131k is ~11 iterations).
    ``stop_loss`` stops at band entry (loss <= stop_loss + tol*|stop_loss|)
    when a converged target is known. Returns ``(params, info)`` with
    ``info["stopped_by"]`` one of ``stop_loss_band`` / ``plateau_rule`` /
    ``noise_plateau`` / ``max_iter`` / ``non_finite_chunk`` /
    ``linesearch_failure``.

    ``stop_decrease`` (host-linesearch CG path only): the noise-plateau
    stop — end the fit after an accepted step earning less than this many
    nats instead of paying the terminal failing linesearch, whose
    gate-rejected trials each cost the chunked-CG projection's 4-segment
    minimum history (~120 s of the measured 391 s honest 131k fit). Set it
    to the estimator's noise scale at the terminus (SLQ probe noise; ~5-50
    nats at 131k). ``None`` keeps the failing-linesearch terminus.

    ``cg_stop_tol`` (host-linesearch CG path): per-column relative-residual
    tolerance at which mbcg freezes a column, and — through the chunked
    step's host early exit — the point where an evaluation stops
    dispatching CG segments entirely once every column has reached it.
    ``cg_iters`` stays the BUDGET sized for the hardest (true-noise)
    region, where the measured residuals at 256 iterations are 1.8% (y) /
    5.2% (probe max) and the budget therefore runs in full; easy regions
    (e.g. cold-init trials at high noise) converge to 2% in a fraction of
    the budget and now cost only what they need. Set to 0 (or anything
    below ~1e-6) to reproduce the fixed-budget protocol exactly.

    ``noise_floor`` (a VARIANCE) defaults per engine: 1e-4 for Hutchinson
    (its logdet comes from an exact factorization) but **1e-3 for CG** —
    measured at N=131k/262k, the truncated 24-iteration CG+SLQ estimator is
    BIASED in the near-floor-noise conditioning regime, and a linesearch
    optimizer is efficient enough to find and exploit that bias: the
    "loss" descends past the physical bound of the data-generating process
    (per-point NLML cannot beat the true model's entropy) while the real
    NLML worsens. Flooring the noise at the level the estimator handles
    honestly blocks the bias cliff; raise ``cg_iters`` if the application
    genuinely needs smaller noise.
    """
    n = x.shape[0]
    if engine == "auto":
        engine = "cg" if n > dense_n_max() else "hutchinson"
    if engine not in ("hutchinson", "cg"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected auto|hutchinson|cg")
    big = engine == "cg"
    if max_iter is None:
        max_iter = 64
    if chunk is None:
        # one CG-engine L-BFGS iteration is already (1 + linesearch) full
        # CG solves in ONE program
        chunk = 1 if big else 8
    if max_linesearch_steps is None:
        max_linesearch_steps = 4 if big else 8
    if probes is None:
        # 127 probes (+1 for y) fill the fused matvec's power-of-two RHS
        # width exactly
        probes = 127 if big else 16
    if key is None:
        key = jax.random.PRNGKey(0)
    if host_linesearch is None:
        # an honest CG evaluation is 256 preconditioned iterations; the
        # host linesearch stops each one as soon as its outcome is known
        host_linesearch = big
    if noise_floor is None:
        noise_floor = 1e-3 if big else 1e-4  # see docstring

    params0 = exact.init_params(kernel, x, noise_variance=noise_variance)
    floors = {"log_noise_variance": float(math.log(noise_floor))}

    if stop_decrease is not None and not host_linesearch:
        raise ValueError("stop_decrease requires the host-linesearch CG "
                         "path (the chunked driver has no per-step "
                         "decrease hook)")
    if host_linesearch:
        if not big:
            raise ValueError("host_linesearch requires the cg engine")
        from gpras_tpu.fit.optimizers import lbfgs_fit_hostls
        from gpras_tpu.gp.exact_cg import make_cg_step_chunked

        step = make_cg_step_chunked(kernel, probes=probes,
                                    max_iters=cg_iters, seg_iters=seg_iters,
                                    precond_rank=precond_rank,
                                    residual_gate=residual_gate,
                                    tol=max(cg_stop_tol, 1e-7))

        def vag(p: dict[str, Array]) -> tuple[float, dict[str, Array]]:
            # enforce the noise floor INSIDE the objective: linesearch trial
            # points otherwise drive the noise far below it, where the
            # ill-conditioned CG/SLQ goes non-finite (measured at N=262k —
            # the between-iterations projection alone was not enough)
            from gpras_tpu.fit.optimizers import _apply_floors

            loss_v, grads = step(_apply_floors(p, floors), x, y, key)
            return float(loss_v), grads

        params, info = lbfgs_fit_hostls(
            vag, params0, max_iter=max_iter, memory_size=memory_size,
            max_linesearch_steps=max_linesearch_steps, tol=tol,
            patience=patience, stop_loss=stop_loss,
            min_decrease=stop_decrease, floors=floors,
            progress=progress)
        info["engine"] = "cg_hostls"
        return params, info

    loss = (_cg_loss(kernel, probes, cg_iters, precond_rank, residual_gate)
            if big else _dense_loss(kernel, n, probes))

    def loss_fn(p: dict[str, Array]) -> Array:
        return loss(p, x, y, key)

    params, info = lbfgs_fit_chunked(
        loss_fn, params0, max_iter=max_iter, chunk=chunk,
        memory_size=memory_size, max_linesearch_steps=max_linesearch_steps,
        tol=tol, patience=patience, stop_loss=stop_loss,
        floors=floors, progress=progress)
    info["engine"] = engine
    return params, info

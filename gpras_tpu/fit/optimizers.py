"""Optimizer zoo: fully-jitted drivers over a GP training loss.

Capability parity with the reference's seven hyperparameter-optimization
strategies (reference gpras/gpr.py:206-214):

- ``adam``                  — Adam with the reference's early-stop semantics
                              (rel-improvement tol 1e-5, patience 50,
                              gpras/gpr.py:147-173), as a ``lax.while_loop``.
- ``adadelta``              — fixed-iteration Adadelta (gpras/gpr.py:176-192).
- ``L-BFGS-B``              — L-BFGS with zoom line search (optax), replacing the
                              scipy bridge (gpras/gpr.py:195-203).
- ``two-stage``             — Adam on inducing Z only, then Adam on the remaining
                              hyperparameters with Z frozen (gpras/gpr.py:112-127).
                              Freezing is a gradient mask, not object mutation.
- ``three-stage``           — Adam on Z, L-BFGS on hypers, L-BFGS polish on all
                              (gpras/gpr.py:130-144).
- ``stochastic``            — multi-start: 40 random restarts in log10 space
                              ([-1,1] variance, [-1,1] lengthscale, [-3,0] noise),
                              short Adam each, keep the best, L-BFGS polish
                              (gpras/gpr.py:73-109). The restarts run **vmapped in a
                              single jit** instead of a Python loop. (The reference
                              has a bug where ``best_loss`` is never updated so the
                              last restart always wins, gpras/gpr.py:96-102; we
                              implement the intended keep-the-best behavior.)
- ``diffential_evolution``  — [sic, reference key] Adam on Z first, then
                              differential evolution over log10 hyperparameters with
                              bounds [(-1,1),(-1,1),(-3,0)] (gpras/gpr.py:44-70).
                              The population evaluates **vmapped** per generation.

All drivers operate on ``loss_fn(params) -> scalar`` over an unconstrained param
dict, so they compose with both the exact-GP NLML and the SGPR ELBO, and with any
kernel in the zoo. Everything data-dependent (early stop, convergence) is
``lax.while_loop`` state — no per-step Python, no host sync inside a fit.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

Array = jax.Array
Params = dict[str, Array]
LossFn = Callable[[Params], Array]

LN10 = math.log(10.0)

#: Structural (non-trainable) parameter keys, excluded from every gradient mask.
NON_TRAINABLE = ("degree",)


# ---------------------------------------------------------------------------
# gradient masks (the functional replacement for gpflow.set_trainable mutation)
# ---------------------------------------------------------------------------

def mask_only(params: Params, keys: tuple[str, ...]) -> Params:
    """Mask that trains only ``keys``."""
    return {k: jnp.asarray(float(k in keys and k not in NON_TRAINABLE)) for k in params}


def mask_except(params: Params, keys: tuple[str, ...] = ()) -> Params:
    """Mask that trains everything except ``keys`` (and structural constants)."""
    return {k: jnp.asarray(float(k not in keys and k not in NON_TRAINABLE)) for k in params}


def _apply_mask(grads: Params, mask: Params | None) -> Params:
    if mask is None:
        mask = {k: jnp.asarray(float(k not in NON_TRAINABLE)) for k in grads}
    return {k: grads[k] * mask[k].astype(grads[k].dtype) for k in grads}


def _apply_floors(params: Params, floors: dict[str, float] | None) -> Params:
    """Project parameters onto ``{p_k >= floor_k}`` after an update step.

    The float32 stability companion to the reference's unconstrained log
    params (gpras/gpr.py:303-305): once the fitted noise shrinks past what
    the f32 Cholesky can represent, a single Adam overshoot NaNs the
    factorization. A floor on ``log_noise_variance`` (GPyTorch
    floors raw noise at 1e-4 for the same reason) keeps the exact-GP fit
    on the stable side with no effect on converged values above the floor.
    """
    if not floors:
        return params
    return {
        k: (jnp.maximum(v, jnp.asarray(floors[k], v.dtype)) if k in floors else v)
        for k, v in params.items()
    }


# ---------------------------------------------------------------------------
# Adam / Adadelta
# ---------------------------------------------------------------------------

def adam_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    learning_rate: float = 0.001,
    tol: float = 1e-5,
    patience: int = 50,
    mask: Params | None = None,
    lower_bounds: dict[str, float] | None = None,
    reject_nonfinite: bool = False,
) -> tuple[Params, dict[str, Array]]:
    """Adam with the reference's early stopping (gpras/gpr.py:159-173).

    Stops when the relative improvement over the best-seen loss has been below
    ``tol`` for more than ``patience`` consecutive steps. Defaults mirror
    tf.keras Adam (lr 0.001, eps 1e-7) and the reference's tol/patience.
    ``lower_bounds`` optionally projects named params onto ``>= floor`` after
    each step (float32 stability — see ``_apply_floors``).

    ``reject_nonfinite`` adds AMP-GradScaler-style step rejection: when the
    loss or any gradient is non-finite, the step is skipped and params +
    optimizer state revert to the last finite iterate (a rejected step counts
    against ``patience``, so an optimizer pinned at the float32 stability
    boundary terminates as converged with finite params instead of NaN). The
    reference has no equivalent — GPflow/TF just NaNs out (its float64 loses
    the race later, at bigger N).
    """
    opt = optax.adam(learning_rate, b1=0.9, b2=0.999, eps=1e-7)
    vag = jax.value_and_grad(loss_fn)

    def cond(state):
        i, _, _, _, count, _, _, _ = state
        return jnp.logical_and(i < max_iter, count <= patience)

    def body(state):
        i, p, opt_state, best, count, losses, good_p, good_opt = state
        loss, grads = vag(p)
        grads = _apply_mask(grads, mask)
        updates, opt_next = opt.update(grads, opt_state, p)
        p_next = optax.apply_updates(p, updates)
        p_next = _apply_floors(p_next, lower_bounds)
        improved = (best - loss) / jnp.abs(loss) > tol
        best = jnp.where(improved, loss, best)
        count = jnp.where(improved, 0, count + 1)
        losses = losses.at[i].set(loss)
        if reject_nonfinite:
            finite = jnp.isfinite(loss)
            for g in jax.tree.leaves(grads):
                finite = finite & jnp.all(jnp.isfinite(g))
            pick = lambda a, b: jax.tree.map(
                lambda u, v: jnp.where(finite, u, v), a, b)
            p_next = pick(p_next, good_p)
            opt_next = pick(opt_next, good_opt)
            good_p = pick(p, good_p)
            good_opt = pick(opt_state, good_opt)
        else:
            # a non-finite loss can never improve again — stop now instead
            # of burning `patience` more steps on NaN params
            count = jnp.where(jnp.isfinite(loss), count, patience + 1)
        return i + 1, p_next, opt_next, best, count, losses, good_p, good_opt

    dtype = params[next(iter(params))].dtype
    losses0 = jnp.full((max_iter,), jnp.nan, dtype=dtype)
    opt0 = opt.init(params)
    init = (0, params, opt0, jnp.asarray(jnp.inf, dtype), 0, losses0,
            params, opt0)
    i, p, _, _, _, losses, good_p, _ = jax.lax.while_loop(cond, body, init)
    if reject_nonfinite:
        # the last iterate may itself be the one that went non-finite;
        # fall back to the last known-good params in that case. The fallback
        # branch pays one extra loss eval; the common (finite) path reuses
        # the value just computed.
        final_loss = loss_fn(p)
        ok = jnp.isfinite(final_loss)
        p = jax.tree.map(lambda u, v: jnp.where(ok, u, v), p, good_p)
        final_loss = jax.lax.cond(ok, lambda: final_loss,
                                  lambda: loss_fn(good_p))
        return p, {"iterations": i, "losses": losses, "loss": final_loss}
    return p, {"iterations": i, "losses": losses, "loss": loss_fn(p)}


def adadelta_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    learning_rate: float = 0.001,
    mask: Params | None = None,
) -> tuple[Params, dict[str, Array]]:
    """Fixed-iteration Adadelta, mirroring the reference's graph loop
    (gpras/gpr.py:176-192; keras defaults lr 0.001, rho 0.95, eps 1e-7)."""
    opt = optax.adadelta(learning_rate, rho=0.95, eps=1e-7)
    vag = jax.value_and_grad(loss_fn)

    def body(i, state):
        p, opt_state, losses = state
        loss, grads = vag(p)
        grads = _apply_mask(grads, mask)
        updates, opt_state = opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, losses.at[i].set(loss)

    dtype = params[next(iter(params))].dtype
    losses0 = jnp.full((max_iter,), jnp.nan, dtype=dtype)
    p, _, losses = jax.lax.fori_loop(0, max_iter, body, (params, opt.init(params), losses0))
    return p, {"iterations": jnp.asarray(max_iter), "losses": losses, "loss": loss_fn(p)}


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------

def lbfgs_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    memory_size: int = 15,
    gtol: float = 1e-8,
    mask: Params | None = None,
) -> tuple[Params, dict[str, Array]]:
    """Jitted L-BFGS with zoom line search — replaces the reference's
    gpflow→scipy L-BFGS-B bridge (gpras/gpr.py:195-203), with no host round-trips.
    """
    if mask is None:
        masked_loss = loss_fn
    else:
        frozen = {k: params[k] for k in params}

        def masked_loss(p: Params) -> Array:
            merged = {
                k: p[k] * mask[k].astype(p[k].dtype)
                + frozen[k] * (1.0 - mask[k]).astype(p[k].dtype)
                for k in p
            }
            return loss_fn(merged)

    opt = optax.lbfgs(memory_size=memory_size)
    vag = optax.value_and_grad_from_state(masked_loss)

    def cond(state):
        i, _, _, err, _ = state
        return jnp.logical_and(i < max_iter, err > gtol)

    def body(state):
        i, p, opt_state, _, losses = state
        loss, grads = vag(p, state=opt_state)
        updates, opt_state = opt.update(
            grads, opt_state, p, value=loss, grad=grads, value_fn=masked_loss
        )
        p = optax.apply_updates(p, updates)
        err = optax.tree_utils.tree_l2_norm(grads)
        return i + 1, p, opt_state, err, losses.at[i].set(loss)

    dtype = params[next(iter(params))].dtype
    losses0 = jnp.full((max_iter,), jnp.nan, dtype=dtype)
    init = (0, params, opt.init(params), jnp.asarray(jnp.inf, dtype), losses0)
    i, p, _, _, losses = jax.lax.while_loop(cond, body, init)
    if mask is not None:
        p = {
            k: p[k] * mask[k].astype(p[k].dtype)
            + params[k] * (1.0 - mask[k]).astype(p[k].dtype)
            for k in p
        }
    return p, {"iterations": i, "losses": losses, "loss": loss_fn(p)}


def lbfgs_fit_chunked(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 96,
    chunk: int = 8,
    memory_size: int = 15,
    max_linesearch_steps: int = 8,
    mask: Params | None = None,
    floors: dict[str, float] | None = None,
    stop_loss: float | None = None,
    tol: float = 1e-5,
    patience: int = 50,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[Params, dict[str, Any]]:
    """Host-chunked L-BFGS: the same optax update/zoom-linesearch math as
    ``lbfgs_fit``, dispatched as ceil(max_iter / chunk) compiled programs of
    ``chunk`` iterations each, with the optimizer state (including the
    linesearch's cached value/grad) carried across dispatches — so
    ``chunk=max_iter`` reproduces a monolithic run exactly.

    Exists for large-N exact-GP fits, where every linesearch eval costs a
    full factorization, so a monolithic 100-iteration while_loop is one
    multi-minute program with no host observability; this driver bounds
    per-program device time at
    ``chunk * (1 + max_linesearch_steps)`` evals. The host boundary also
    applies the reference early-stop rule (rel-tol/patience,
    gpras/gpr.py:162-173), an optional stopping band (``stop_loss``: stop
    once loss <= stop_loss + tol*|stop_loss|, the bench.py band-entry
    semantics), ``floors`` projection between chunks (see
    ``_apply_floors``), and rejects a chunk whose every loss is non-finite
    (reverting to the pre-chunk state). ``progress(iterations_done,
    best_loss)`` is called after every chunk's host sync, so long fits are
    observable.
    """
    # Pin the loss to the caller's param dtypes: optax's zoom linesearch
    # evaluates along the line with weak-f64 stepsizes, which under
    # jax_enable_x64 promotes f32 params to f64 before they reach the loss
    # (and would flip the fori_loop carry dtype after apply_updates).
    dtypes = {k: params[k].dtype for k in params}

    def _pin(p: Params) -> Params:
        return {k: jnp.asarray(p[k], dtypes[k]) for k in p}

    if mask is None:

        def masked_loss(p: Params) -> Array:
            return loss_fn(_pin(p))

        frozen: Params = {}
    else:
        frozen = {k: params[k] for k in params}

        def masked_loss(p: Params) -> Array:
            p = _pin(p)
            merged = {
                k: p[k] * mask[k].astype(p[k].dtype)
                + frozen[k] * (1.0 - mask[k]).astype(p[k].dtype)
                for k in p
            }
            return loss_fn(merged)

    opt = optax.lbfgs(
        memory_size=memory_size,
        linesearch=optax.scale_by_zoom_linesearch(
            max_linesearch_steps=max_linesearch_steps))
    vag = optax.value_and_grad_from_state(masked_loss)

    @jax.jit
    def run_chunk(p: Params, opt_state, n_iters):
        # n_iters traced (the final chunk may be partial so the total never
        # exceeds max_iter): one compiled program serves every chunk size
        def body(i, carry):
            p, opt_state, losses = carry
            val, grads = vag(p, state=opt_state)
            updates, opt_state = opt.update(
                grads, opt_state, p, value=val, grad=grads,
                value_fn=masked_loss)
            p = _pin(optax.apply_updates(p, updates))
            return p, opt_state, losses.at[i].set(val)

        dtype = p[next(iter(p))].dtype
        losses0 = jnp.full((chunk,), jnp.nan, dtype=dtype)
        return jax.lax.fori_loop(0, n_iters, body, (p, opt_state, losses0))

    p, opt_state = params, opt.init(params)
    all_losses: list[np.ndarray] = []
    best = float("inf")
    count = 0
    done = 0
    stopped = ""
    while done < max_iter and not stopped:
        n_this = min(chunk, max_iter - done)
        p_new, opt_state_new, losses = run_chunk(p, opt_state, n_this)
        lv = np.asarray(losses)[:n_this]  # host sync once per chunk
        # A NaN ANYWHERE in the chunk means the iterate itself went NaN
        # (the loss is a pure deterministic function of the params) and
        # every later state in the chunk is poisoned — revert to the
        # pre-chunk iterate. +inf alone (e.g. a residual-gated trial) is
        # recoverable and only rejected when the whole chunk is non-finite.
        if np.isnan(lv).any() or not np.isfinite(lv).any():
            stopped = "non_finite_chunk"  # revert: keep pre-chunk state
            break
        p, opt_state = p_new, opt_state_new
        if floors:
            p = _apply_floors(p, floors)
        done += n_this
        all_losses.append(lv)
        if progress is not None:
            fin = lv[np.isfinite(lv)]
            progress(done, min(best, float(fin.min())) if fin.size else best)
        for v in lv:
            if not np.isfinite(v):
                count += 1
                if count > patience:
                    stopped = "plateau_rule"
                    break
                continue
            if (best - v) / max(abs(v), 1e-300) > tol:
                best, count = float(v), 0
            else:
                count += 1
            if stop_loss is not None and v <= stop_loss + tol * abs(stop_loss):
                stopped = "stop_loss_band"
                break
            if count > patience:
                stopped = "plateau_rule"
                break
    losses_full = np.full((max_iter,), np.nan, dtype=np.float32)
    if all_losses:
        flat = np.concatenate(all_losses)[:max_iter]
        losses_full[: flat.size] = flat
    if mask is not None:
        p = {
            k: p[k] * mask[k].astype(p[k].dtype)
            + frozen[k] * (1.0 - mask[k]).astype(p[k].dtype)
            for k in p
        }
    return p, {
        "iterations": jnp.asarray(done),
        "losses": jnp.asarray(losses_full),
        "loss": jnp.asarray(best),
        "stopped_by": stopped or "max_iter",
    }


def _flatten(params: Params, order: list[str]) -> np.ndarray:
    return np.concatenate(
        [np.asarray(params[k], np.float64).ravel() for k in order])


def _unflatten(vec: np.ndarray, template: Params,
               order: list[str]) -> Params:
    out: Params = {}
    i = 0
    for k in order:
        t = template[k]
        sz = int(np.prod(t.shape)) if t.shape else 1
        out[k] = jnp.asarray(vec[i:i + sz].reshape(t.shape), t.dtype)
        i += sz
    return out


def lbfgs_fit_hostls(
    value_and_grad_fn: Callable[[Params], tuple[float, Params]],
    params: Params,
    max_iter: int = 64,
    memory_size: int = 15,
    max_linesearch_steps: int = 8,
    c1: float = 1e-4,
    c2: float = 0.9,
    floors: dict[str, float] | None = None,
    stop_loss: float | None = None,
    tol: float = 1e-5,
    patience: int = 10,
    min_decrease: float | None = None,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[Params, dict[str, Any]]:
    """L-BFGS with the ENTIRE optimizer on the host: two-loop recursion and
    the strong-Wolfe bracket/zoom linesearch run in float64 numpy, and every
    NLML evaluation is its own ``value_and_grad_fn(params) -> (float, grads)``
    call — a host function free to dispatch one jitted program or several
    (e.g. ``exact_cg.make_cg_step_chunked``, whose CG segments are each a
    bounded-device-time program).

    Why a third L-BFGS driver exists (the ladder):

    - ``lbfgs_fit`` — one monolithic jitted program (optax); right whenever
      the whole fit fits the device budget (vmapped per-mode fits).
    - ``lbfgs_fit_chunked`` — optax state carried across chunk programs of
      whole iterations; right while ONE iteration (1 + linesearch evals,
      each a full factorization or CG solve) is a reasonable program.
    - this driver — no program ever contains more than one eval (and the
      eval itself may be segmented, e.g. to stop CG early on the host), so
      program length is bounded at any N; the price is one host round trip
      per eval, invisible next to multi-second evals.

    Early-stop semantics match ``lbfgs_fit_chunked``: reference plateau rule
    (rel-tol ``tol``, ``patience`` L-BFGS iterations), optional ``stop_loss``
    band entry, ``floors`` projection between iterations, and a non-finite /
    no-descent linesearch ends the fit on the last good iterate. The Wolfe
    parameters are the classics (c1=1e-4, c2=0.9, Nocedal & Wright alg.
    3.5-3.6, quadratic-bisection zoom).

    ``min_decrease`` (absolute loss units) is the noise-plateau stop: after
    an ACCEPTED step whose decrease is below it, stop immediately
    (``stopped_by="noise_plateau"``) instead of proposing another
    linesearch. Rationale: on a stochastic-estimator objective (Hutchinson / SLQ with
    a fixed probe key) the optimizer's terminus is the point where no step
    earns more than estimator noise — but DISCOVERING that via a failing
    linesearch costs max_linesearch_steps gate-rejected trials, each paying
    the chunked-CG gate-abort's 4-segment minimum history. Once a step earns less than the noise scale, the next
    linesearch is statistically guaranteed to be that failing one, so
    stopping here removes those trials without changing the iterate
    trajectory up to the stop. Set it to the measured estimator noise
    (e.g. SLQ probe-to-probe spread, ~5-50 nats at 131k depending on
    region); ``None`` (default) disables the rule and reproduces the
    failing-linesearch terminus exactly.
    """
    order = sorted(params.keys())
    template = {k: params[k] for k in order}

    def vag(vec: np.ndarray) -> tuple[float, np.ndarray]:
        val, grads = value_and_grad_fn(_unflatten(vec, template, order))
        return float(val), _flatten(grads, order)

    x = _flatten(params, order)
    f0, g = vag(x)
    evals = 1
    if not np.isfinite(f0):
        return params, {
            "iterations": jnp.asarray(0),
            "losses": jnp.asarray(np.full((max_iter,), np.nan, np.float32)),
            "loss": jnp.asarray(np.nan, jnp.float32),
            "stopped_by": "non_finite_init", "evals": evals,
        }

    s_mem: list[np.ndarray] = []
    y_mem: list[np.ndarray] = []
    losses = np.full((max_iter,), np.nan, np.float32)
    best = f0
    best_x = x.copy()
    count = 0
    stopped = ""
    done = 0

    for it in range(max_iter):
        # two-loop recursion for d = -H g
        q = g.copy()
        alphas = []
        for s, yv in zip(reversed(s_mem), reversed(y_mem)):
            a = (s @ q) / (yv @ s)
            alphas.append(a)
            q -= a * yv
        if s_mem:
            gamma = (s_mem[-1] @ y_mem[-1]) / (y_mem[-1] @ y_mem[-1])
            q *= gamma
        for (s, yv), a in zip(zip(s_mem, y_mem), reversed(alphas)):
            b = (yv @ q) / (yv @ s)
            q += (a - b) * s
        d = -q
        slope0 = g @ d
        if not np.isfinite(slope0) or slope0 >= 0.0:
            d = -g  # reset to steepest descent on a bad pair
            slope0 = g @ d
            s_mem.clear()
            y_mem.clear()

        # strong-Wolfe linesearch (bracket + zoom) on phi(a) = f(x + a d).
        # A non-finite GRADIENT poisons the next direction even when the
        # value is finite (measured at N=262k in the near-floor-noise
        # region), so it fails the trial the same way a non-finite value
        # does.
        def phi(a: float) -> tuple[float, np.ndarray, float]:
            fv, gv = vag(x + a * d)
            if not np.all(np.isfinite(gv)):
                return np.nan, gv, np.nan
            return fv, gv, gv @ d

        a_prev, f_prev, slope_prev, g_prev = 0.0, f0, slope0, g
        a_cur = 1.0 if s_mem else min(1.0, 1.0 / max(1.0,
                                                     float(np.abs(g).sum())))
        lo = hi = None  # zoom bracket: (a, f, slope, grad) tuples — the
        # gradient rides along so the budget-exhausted fallback never
        # re-evaluates a point phi() already paid for (each eval is a full
        # factorization / CG solve)
        accepted = None
        ls_evals = 0
        while ls_evals < max_linesearch_steps:
            f_cur, g_cur, slope_cur = phi(a_cur)
            evals += 1
            ls_evals += 1
            if not np.isfinite(f_cur):
                a_cur = 0.5 * (a_prev + a_cur)  # pull back toward the base
                continue
            if f_cur > f0 + c1 * a_cur * slope0 or \
                    (a_prev > 0.0 and f_cur >= f_prev):
                lo, hi = (a_prev, f_prev, slope_prev, g_prev), \
                    (a_cur, f_cur, slope_cur, g_cur)
                break
            if abs(slope_cur) <= -c2 * slope0:
                accepted = (a_cur, f_cur, g_cur)
                break
            if slope_cur >= 0.0:
                lo, hi = (a_cur, f_cur, slope_cur, g_cur), \
                    (a_prev, f_prev, slope_prev, g_prev)
                break
            a_prev, f_prev, slope_prev, g_prev = a_cur, f_cur, slope_cur, \
                g_cur
            a_cur = 2.0 * a_cur
        if accepted is None and lo is None and a_prev > 0.0 and f_prev < f0:
            # expansion exhausted the budget while every trial satisfied
            # Armijo and kept descending: the last point is a valid step
            accepted = (a_prev, f_prev, g_prev)
        while accepted is None and lo is not None and \
                ls_evals < max_linesearch_steps:
            # zoom: quadratic interpolation, bisection fallback
            a_lo, f_lo, s_lo, _ = lo
            a_hi, f_hi, _, _ = hi
            denom = 2.0 * (f_hi - f_lo - s_lo * (a_hi - a_lo))
            a_j = a_lo + (-s_lo * (a_hi - a_lo) ** 2 / denom
                          if abs(denom) > 1e-300 else 0.5 * (a_hi - a_lo))
            width = abs(a_hi - a_lo)
            if not np.isfinite(a_j) or \
                    not (min(a_lo, a_hi) + 0.1 * width <= a_j
                         <= max(a_lo, a_hi) - 0.1 * width):
                a_j = 0.5 * (a_lo + a_hi)
            f_j, g_j, slope_j = phi(a_j)
            evals += 1
            ls_evals += 1
            if not np.isfinite(f_j) or f_j > f0 + c1 * a_j * slope0 or \
                    f_j >= f_lo:
                hi = (a_j, f_j, slope_j, g_j)
            else:
                if abs(slope_j) <= -c2 * slope0:
                    accepted = (a_j, f_j, g_j)
                    break
                if slope_j * (a_hi - a_lo) >= 0.0:
                    hi = lo
                lo = (a_j, f_j, slope_j, g_j)
            if width < 1e-12:
                break
        if accepted is None:
            # no Wolfe point inside the budget: take the best finite
            # decrease seen in the zoom bracket, else stop
            cand = [t for t in (lo, hi) if t is not None
                    and np.isfinite(t[1]) and t[1] < f0 and t[0] > 0.0
                    and np.all(np.isfinite(t[3]))]
            if not cand:
                if s_mem:
                    # stale curvature pairs can demand a step the trial
                    # budget can't bracket; restart from steepest descent
                    # (standard L-BFGS practice) before giving up
                    s_mem.clear()
                    y_mem.clear()
                    continue
                stopped = "linesearch_failure"
                break
            a_b, f_b, _, g_b = min(cand, key=lambda t: t[1])
            accepted = (a_b, f_b, g_b)

        a_acc, f_new, g_new = accepted
        earned = f0 - f_new  # accepted-step decrease (>= 0 by construction)
        x_new = x + a_acc * d
        if floors:
            p_proj = _apply_floors(_unflatten(x_new, template, order),
                                   floors)
            x_new = _flatten(p_proj, order)
        s_vec = x_new - x
        y_vec = g_new - g
        if np.isfinite(y_vec @ s_vec) and (y_vec @ s_vec) > 1e-10 * \
                np.linalg.norm(s_vec) * np.linalg.norm(y_vec):
            s_mem.append(s_vec)
            y_mem.append(y_vec)
            if len(s_mem) > memory_size:
                s_mem.pop(0)
                y_mem.pop(0)
        x, f0, g = x_new, f_new, g_new
        losses[it] = f_new
        done = it + 1
        if progress is not None:
            progress(done, min(best, f_new))
        if f_new < best:
            if (best - f_new) / max(abs(f_new), 1e-300) > tol:
                count = 0
            else:
                count += 1
            best, best_x = f_new, x.copy()
        else:
            count += 1
        if stop_loss is not None and \
                f_new <= stop_loss + tol * abs(stop_loss):
            stopped = "stop_loss_band"
            break
        if min_decrease is not None and earned < min_decrease:
            stopped = "noise_plateau"
            break
        if count > patience:
            stopped = "plateau_rule"
            break

    p_out = _unflatten(best_x, template, order)
    return p_out, {
        "iterations": jnp.asarray(done),
        "losses": jnp.asarray(losses),
        "loss": jnp.asarray(best, jnp.float32),
        "stopped_by": stopped or "max_iter",
        "evals": evals,
    }


# ---------------------------------------------------------------------------
# staged schedules
# ---------------------------------------------------------------------------

def two_stage_fit(
    loss_fn: LossFn, params: Params, max_iter: int = 100, **adam_kwargs: Any
) -> tuple[Params, dict[str, Array]]:
    """Adam on Z only, then Adam on all other params with Z frozen
    (reference gpras/gpr.py:112-127). For models without inducing inputs
    (the exact backend) the Z stage would run ~patience full NLML+gradient
    evaluations with an all-zero mask — it is skipped."""
    if "z" in params:
        p, _ = adam_fit(loss_fn, params, max_iter,
                        mask=mask_only(params, ("z",)), **adam_kwargs)
    else:
        p = params
    p, info = adam_fit(loss_fn, p, max_iter, mask=mask_except(p, ("z",)), **adam_kwargs)
    return p, info


def three_stage_fit(
    loss_fn: LossFn, params: Params, max_iter: int = 100
) -> tuple[Params, dict[str, Array]]:
    """Adam on Z, L-BFGS on hypers (Z frozen), L-BFGS polish on everything
    (reference gpras/gpr.py:130-144). The Z stage is skipped when the model
    has no inducing inputs (see two_stage_fit)."""
    p = params
    if "z" in params:
        p, _ = adam_fit(loss_fn, p, max_iter, mask=mask_only(p, ("z",)))
    p, _ = lbfgs_fit(loss_fn, p, max_iter, mask=mask_except(p, ("z",)))
    p, info = lbfgs_fit(loss_fn, p, max_iter)
    return p, info


# ---------------------------------------------------------------------------
# multi-start ("stochastic")
# ---------------------------------------------------------------------------

def _sample_restart(key: Array, params: Params, x: Array | None) -> Params:
    """One random restart in the reference's log10 sampling boxes
    (gpras/gpr.py:87-91): variance 10^U(-1,1), lengthscale 10^U(-1,1) (scalar,
    broadcast over ARD dims), noise 10^U(-3,0), Z ~ U(feature mins, maxs)."""
    kv, kl, kn, kz = jax.random.split(key, 4)
    out = dict(params)
    dtype = params["log_variance"].dtype
    out["log_variance"] = (jax.random.uniform(kv, (), dtype, -1.0, 1.0)) * LN10
    if "log_lengthscales" in params:
        ls = jax.random.uniform(kl, (), dtype, -1.0, 1.0) * LN10
        out["log_lengthscales"] = jnp.full_like(params["log_lengthscales"], ls)
    out["log_noise_variance"] = jax.random.uniform(kn, (), dtype, -3.0, 0.0) * LN10
    if "z" in params and x is not None:
        mins = jnp.min(x, axis=0)
        maxs = jnp.max(x, axis=0)
        u = jax.random.uniform(kz, params["z"].shape, dtype)
        out["z"] = mins + u * (maxs - mins)
    return out


def multi_start_fit(
    loss_fn: LossFn,
    params: Params,
    x: Array | None = None,
    n_starts: int = 40,
    iter_initial: int = 20,
    iter_final: int = 1000,
    seed: int = 1,
) -> tuple[Params, dict[str, Array]]:
    """Vmapped multi-start Adam, keep the best restart, L-BFGS polish
    (reference "stochastic", gpras/gpr.py:73-109; np.random.seed(1) parity on the
    seed default). All ``n_starts`` restarts run data-parallel in one jit."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_starts)
    starts = jax.vmap(lambda k: _sample_restart(k, params, x))(keys)

    def short_fit(p: Params) -> tuple[Params, Array]:
        p2, info = adam_fit(loss_fn, p, iter_initial)
        return p2, info["loss"]

    fitted, losses = jax.vmap(short_fit)(starts)
    best = jnp.nanargmin(losses)
    best_params = {k: v[best] for k, v in fitted.items()}
    p, info = lbfgs_fit(loss_fn, best_params, iter_final)
    info["restart_losses"] = losses
    return p, info


# ---------------------------------------------------------------------------
# differential evolution
# ---------------------------------------------------------------------------

def de_fit(
    loss_fn: LossFn,
    params: Params,
    popsize: int = 15,
    max_iter: int = 500,
    adam_iter: int = 3000,
    tol: float = 0.01,
    recombination: float = 0.7,
    seed: int = 0,
    eval_map: Callable[[Callable], Callable] | None = None,
) -> tuple[Params, dict[str, Array]]:
    """Adam on Z first, then differential evolution (best/1/bin with dithered
    mutation, scipy-compatible defaults) over the three log10 hyperparameters with
    bounds [(-1,1), (-1,1), (-3,0)] (reference gpras/gpr.py:44-70). Each
    generation's population evaluates vmapped; lengthscales are assigned as a
    scalar broadcast exactly like the reference's ``assign``.

    ``eval_map`` overrides how the population's energies are evaluated (a
    function wrapping the per-member loss into a batched evaluator) — the
    hook parallel/pfit.sharded_de uses to shard the evaluation over a mesh.
    """
    if "z" in params:
        params, _ = adam_fit(loss_fn, params, adam_iter, mask=mask_only(params, ("z",)))

    lo = jnp.asarray([-1.0, -1.0, -3.0])
    hi = jnp.asarray([1.0, 1.0, 0.0])
    dim = 3
    n_pop = popsize * dim

    def set_params(u: Array) -> Params:
        out = dict(params)
        dtype = params["log_variance"].dtype
        out["log_variance"] = (u[0] * LN10).astype(dtype)
        if "log_lengthscales" in params:
            out["log_lengthscales"] = jnp.full_like(
                params["log_lengthscales"], (u[1] * LN10).astype(dtype)
            )
        out["log_noise_variance"] = (u[2] * LN10).astype(dtype)
        return out

    emap = eval_map if eval_map is not None else jax.vmap
    energy = emap(lambda u: loss_fn(set_params(u)))

    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    pop0 = lo + jax.random.uniform(sub, (n_pop, dim)) * (hi - lo)
    f0 = energy(pop0)

    def cond(state):
        i, key, pop, f = state
        spread = jnp.std(f)
        return jnp.logical_and(i < max_iter, spread > tol * jnp.abs(jnp.mean(f)))

    def body(state):
        i, key, pop, f = state
        key, kf, kr, kcross, kjdim = jax.random.split(key, 5)
        fmut = jax.random.uniform(kf, (), minval=0.5, maxval=1.0)  # dithering
        best_u = pop[jnp.argmin(f)]
        idx = jax.random.randint(kr, (n_pop, 2), 0, n_pop)
        mutant = best_u[None, :] + fmut * (pop[idx[:, 0]] - pop[idx[:, 1]])
        mutant = jnp.clip(mutant, lo, hi)
        cross = jax.random.uniform(kcross, (n_pop, dim)) < recombination
        jdim = jax.random.randint(kjdim, (n_pop,), 0, dim)
        force = jax.nn.one_hot(jdim, dim, dtype=bool)
        cross = jnp.logical_or(cross, force)
        trial = jnp.where(cross, mutant, pop)
        f_trial = energy(trial)
        accept = f_trial < f
        pop = jnp.where(accept[:, None], trial, pop)
        f = jnp.where(accept, f_trial, f)
        return i + 1, key, pop, f

    i, _, pop, f = jax.lax.while_loop(cond, body, (0, key, pop0, f0))
    best_u = pop[jnp.argmin(f)]
    p = set_params(best_u)
    return p, {"iterations": i, "loss": jnp.min(f), "losses": f}


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

FITTERS: dict[str, Callable[..., tuple[Params, dict[str, Array]]]] = {
    "two-stage": two_stage_fit,
    "three-stage": three_stage_fit,
    "adam": adam_fit,
    "adadelta": adadelta_fit,
    "L-BFGS-B": lbfgs_fit,
    "stochastic": multi_start_fit,
    "diffential_evolution": de_fit,  # [sic] reference key, gpras/gpr.py:213
    "differential_evolution": de_fit,
}


def fit(
    loss_fn: LossFn, params: Params, method: str = "two-stage", **kwargs: Any
) -> tuple[Params, dict[str, Array]]:
    """Dispatch to an optimizer by its reference-parity name (gpras/gpr.py:206-214)."""
    if method not in FITTERS:
        raise ValueError(f"Unknown optimizer {method!r}; expected one of {sorted(FITTERS)}")
    return FITTERS[method](loss_fn, params, **kwargs)

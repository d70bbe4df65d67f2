"""Warm-start transfer protocol for large-N exact-GP fits.

Productizes the headline bench's warm-start robustness: a converged fit on a subsample rung transfers its hyperparameters
to the full-N problem only after the **conditioning-envelope clamp**, and the
full-N fit **certifies** the transferred parameters with one forward NLML
evaluation before polishing.

Why the clamp exists (observed at N=49,152): the f32 factorization of
the full-N Gram is feasible only while kappa ~ n * var / noise stays inside
the f32 envelope, and a subsample rung over-inflates the kernel variance
along the flat var-vs-nuisance-lengthscale NLML ridge — the 4,096-point rung
on the hard DGP lands at var/noise = 88 where the full-N loss is non-finite
(and stays non-finite under ANY nuisance-lengthscale clip down to e^2: the
RATIO, not the lengthscales, is the wall), while the full-N cold fit
converges at var/noise = 47 with zero rejected steps. Clamping the rung
variance to ``ratio_cap * noise`` (default 50, the measured converged
operating point) leaves every other parameter untouched and puts the
transfer back inside the envelope.

The certify step covers what the static clamp cannot see (different DGPs
put the wall elsewhere): evaluate the full-N loss once at the clamped
parameters; while non-finite, halve the cap and retry. A transfer that stays
non-finite down to ``min_cap`` is reported infeasible and the caller falls
back to standard init.

``GPRAS.fit(warm_start_subsample=...)`` routes through this module per mode
(gp/model.py); bench.py's headline protocol calls ``transfer_clamp`` for the
same clamp and keeps its own committed-L* band timing on top.

Reference contract: gpras/gpr.py:237 (the one-call ``fit``) — the reference
has no warm-start path at all; this module is the greenfield robustness
layer that makes the hierarchical fit safe in f32.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

#: Measured f32 feasibility envelope at N=49,152 (round 4): the full-N cold
#: fit converges at var/noise = 47; the unclamped rung transfer at 88 is
#: non-finite. 50 is the converged operating point with margin.
DEFAULT_RATIO_CAP = 50.0


def transfer_clamp(params: dict[str, Array],
                   ratio_cap: float = DEFAULT_RATIO_CAP) -> dict[str, Array]:
    """Clamp the kernel variance to ``<= ratio_cap * noise_variance``.

    Works on a single parameter pytree or a mode-batched one (leading axis =
    mode; the clamp is elementwise). Every entry other than
    ``log_variance`` is returned untouched. A no-op when the ratio is
    already inside the cap (e.g. the easy-DGP rung at var/noise ~ 10).
    """
    p = dict(params)
    lv = p["log_variance"]
    p["log_variance"] = jnp.minimum(
        lv, p["log_noise_variance"] + jnp.asarray(math.log(ratio_cap),
                                                  lv.dtype))
    return p


def certify_transfer(
    loss_fn: Callable[[dict[str, Array]], Any],
    params: dict[str, Array],
    ratio_cap: float = DEFAULT_RATIO_CAP,
    min_cap: float = 2.0,
) -> tuple[dict[str, Array], dict[str, Any]]:
    """Clamp ``params`` into the feasibility envelope of ``loss_fn``.

    One forward evaluation at the clamped parameters certifies the
    transfer; while the loss is non-finite the cap halves (the measured
    envelope is problem-dependent) until it is finite or falls below
    ``min_cap``. Returns ``(clamped_params, info)`` with
    ``info["feasible"]`` (bool), ``info["ratio_cap_used"]`` (the cap that
    certified, or the last one tried), and ``info["cert_loss"]`` (the
    certifying loss value; NaN when infeasible).

    ``loss_fn`` takes a single-mode parameter pytree and returns a scalar
    (a jitted NLML forward; the Hutchinson loss VALUE is exact — probes
    only randomize gradients).
    """
    cap = float(ratio_cap)
    cert = float("nan")
    while cap >= min_cap:
        clamped = transfer_clamp(params, cap)
        cert = float(loss_fn(clamped))
        if np.isfinite(cert):
            return clamped, {"feasible": True, "ratio_cap_used": cap,
                             "cert_loss": cert}
        cap /= 2.0
    return transfer_clamp(params, min_cap), {
        "feasible": False, "ratio_cap_used": cap * 2.0, "cert_loss": cert}


def certify_transfer_batched(
    loss_fn: Callable[[dict[str, Array], int], Any],
    params: dict[str, Array],
    fallback: dict[str, Array],
    ratio_cap: float = DEFAULT_RATIO_CAP,
    min_cap: float = 2.0,
) -> tuple[dict[str, Array], dict[str, Any]]:
    """Per-mode ``certify_transfer`` over a mode-batched parameter pytree.

    ``loss_fn(p_i, i)`` evaluates mode ``i``'s full-N loss at single-mode
    params ``p_i``; ``fallback`` is the mode-batched standard init used for
    any mode whose transfer stays infeasible down to ``min_cap`` (the
    honest recovery: a cold fit beats a NaN'd warm one). Modes loop on the
    host — the cert is one forward evaluation per mode and mode counts are
    small (EOF retains ~10-50 modes).

    Returns ``(params, info)`` with per-mode ``info["ratio_caps"]``,
    ``info["cert_losses"]`` and ``info["fell_back_modes"]``.
    """
    n_modes = int(jax.tree.leaves(params)[0].shape[0])
    out_modes, caps, certs, fell_back = [], [], [], []
    for i in range(n_modes):
        p_i = {k: v[i] for k, v in params.items()}
        clamped, info = certify_transfer(lambda p: loss_fn(p, i), p_i,
                                         ratio_cap=ratio_cap,
                                         min_cap=min_cap)
        caps.append(info["ratio_cap_used"])
        certs.append(info["cert_loss"])
        if info["feasible"]:
            out_modes.append(clamped)
        else:
            fell_back.append(i)
            out_modes.append({k: v[i] for k, v in fallback.items()})
    stacked = {k: jnp.stack([m[k] for m in out_modes])
               for k in params.keys()}
    return stacked, {"ratio_caps": caps, "cert_losses": certs,
                     "fell_back_modes": fell_back}

"""Memory-lean exact-GP NLML for very large N on a single device.

The standard custom VJP (gpras_tpu.gp.exact) materializes K^{-1} and the full
cotangent K_bar in the backward pass — three extra O(N^2) buffers on top of the
factor, four (N, N) buffers in all. This variant keeps
the same mathematics

    dNLML/dK = 0.5 (K^{-1} - alpha alpha^T)

but reconstructs K^{-1} in **column panels** inside a ``lax.fori_loop``: each
iteration solves (L L^T) Z = E_panel for one (N, R) identity block, forms the
(N, R) slice of K_bar, and contracts it with dK/dtheta through a vjp of the
corresponding Gram **tile** k(x, x_panel). Peak backward memory is the saved
factor plus O(N * R) temporaries (an (N, N) f32 factor at N = 50k is 10 GB).
FLOPs match the
dense backward (the identity solves are the same O(N^3)).

This is the single-device twin of ``gpras_tpu.parallel.pexact``'s distributed
backward; the two share the algorithm, differing only in collectives.
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


def make_lean_nlml(kernel: str, col_panel: int = 2048,
                   blocked: int | None = None, engine: str | None = None,
                   chol_w: int = 1024, chol_strip: int = 16384,
                   chol_precision: str | None = None):
    """Returns ``nlml(params, x, y)`` (y strictly (N,)) with the panel-scan
    backward; differentiable w.r.t. params and y.

    ``engine`` picks the factorization/solve implementation:
    - ``None``/"xla": jnp.linalg.cholesky + XLA solves (compile cost and the
      K+L double buffer grow with N; fine to ~16k).
    - ``"super"``: ops.block_cholesky.super_cholesky (in-place, shrinking
      static trailing updates, flat compile — the N >= 32k configuration)
      + flat-compile panel solves.
    - ``"blocked"``: the masked full-width fori_loop factorization (tiny HLO,
      ~3x slower; kept for debugging). ``blocked=b`` is the legacy spelling.
    """

    if blocked is not None and engine is None:
        engine = "blocked"
    if engine == "super":
        from gpras_tpu.ops.block_cholesky import (blocked_cho_solve, fit_block,
                                                  super_cholesky)

        chol = lambda k: super_cholesky(k, fit_block(k.shape[0], chol_w),
                                        chol_strip, chol_precision,
                                        zero_upper=False)
        solve = lambda l, r: blocked_cho_solve(l, r, 512)
    elif engine == "blocked":
        from gpras_tpu.ops.block_cholesky import blocked_cho_solve, blocked_cholesky

        b = blocked or 512
        chol = lambda k: blocked_cholesky(k, b)
        solve = lambda l, r: blocked_cho_solve(l, r, b)
    else:
        chol = jnp.linalg.cholesky
        solve = linalg.cho_solve

    def forward(params, x, y):
        n = x.shape[0]
        noise = jnp.exp(params["log_noise_variance"])
        jitter = linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        k = K.gram(kernel, params, x)
        k = k + (noise + jitter) * jnp.eye(n, dtype=k.dtype)
        l = chol(k)
        alpha = solve(l, y[:, None])[:, 0]
        quad = 0.5 * jnp.vdot(y, alpha)
        logdet = linalg.logdet_from_chol(l)
        out = quad + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
        return out, (l, alpha)

    @jax.custom_vjp
    def nlml(params, x, y):
        return forward(params, x, y)[0]

    def fwd(params, x, y):
        out, (l, alpha) = forward(params, x, y)
        return out, (params, x, y, l, alpha)

    def bwd(res, g):
        params, x, y, l, alpha = res
        # cast a possibly weak-f64-promoted cotangent (e.g. optax zoom
        # linesearch under jax_enable_x64) back to the engine dtype
        g = jnp.asarray(g, x.dtype)
        n = x.shape[0]
        from gpras_tpu.ops.block_cholesky import fit_block

        r = fit_block(n, col_panel)
        n_panels = n // r

        def contract_tile(p, x_cols, kbar_tile):
            _, pullback = jax.vjp(lambda pp: K.gram(kernel, pp, x, x_cols), p)
            (grads,) = pullback(kbar_tile)
            return grads

        def panel_step(j, carry):
            grads_acc, diag_acc = carry
            cols = j * r + jnp.arange(r)
            eye_cols = (jnp.arange(n)[:, None] == cols[None, :]).astype(x.dtype)
            z = solve(l, eye_cols)  # (N, R) columns of K^{-1}
            kbar = 0.5 * g * (z - alpha[:, None] * alpha[cols][None, :])
            diag_acc = diag_acc + jnp.sum(kbar[cols, jnp.arange(r)])
            grads_t = contract_tile(params, x[cols], kbar)
            grads_acc = jax.tree.map(jnp.add, grads_acc, grads_t)
            return grads_acc, diag_acc

        zero = jax.tree.map(jnp.zeros_like, params)
        grads, diag_sum = jax.lax.fori_loop(
            0, n_panels, panel_step, (zero, jnp.zeros((), x.dtype)))
        grads["log_noise_variance"] = grads["log_noise_variance"] + \
            diag_sum * jnp.exp(params["log_noise_variance"])
        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        return grads, jnp.zeros_like(x), g * alpha

    nlml.defvjp(fwd, bwd)
    return nlml


def make_lean_training_loss(kernel: str, col_panel: int = 2048,
                            blocked: int | None = None, **engine_kwargs):
    """Lean NLML minus the log prior (the optimizer objective)."""
    nlml = make_lean_nlml(kernel, col_panel, blocked, **engine_kwargs)

    def loss(params, x, y):
        return nlml(params, x, y) - log_prior(params)

    return loss

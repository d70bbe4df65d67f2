"""Distributed exact-GP NLML over a device mesh, with a factor-reusing custom VJP.

Composes the communication-free row-sharded Gram (``pgram_rows``), the
distributed blocked Cholesky, and distributed triangular solves into the exact
GP marginal likelihood for N too large for one chip (BASELINE.json configs[4]).

Gradient strategy: plain autodiff through the blocked factorization would save
every trailing-update intermediate (O(N^2/d * n_blocks) residual memory), so
``make_dist_nlml`` wraps the objective in a custom VJP that **reuses the
distributed factor**:

    dNLML/dK = 0.5 (K^{-1} - alpha alpha^T)

The backward pass reconstructs K^{-1} in column batches by re-solving against
identity blocks with the already-computed factor, contracting each batch with
dK/dtheta via a local-tile vjp of the Gram build and a psum over the mesh.
Per-device backward compute is O(N^2 * batch) per batch (the solves run
redundantly — the factor strip is distributed but every device walks all
blocks); memory stays O(N^2/d + N*batch). For the largest N,
``make_dist_nlml_stochastic`` swaps in a Hutchinson stochastic-trace
backward (one distributed (N, m) probe solve + outer-product cotangents,
O(N^2 (d + m)) per step — the same estimator as the single-chip headline
engine, gp/exact_stochastic.py).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gpras_tpu.ops import kernels as K
from gpras_tpu.parallel.pcholesky import (
    dist_cho_solve,
    dist_cholesky,
    dist_logdet_from_chol,
)
from gpras_tpu.parallel.pgram import pgram_rows

Array = jax.Array


def resolve_layout(mesh: Mesh, layout: str = "auto") -> str:
    """``"auto"`` -> ``"2d"`` on a true 2-D mesh (axes "i" AND "j", both
    > 1 device), else ``"1d"``. The 2-D P(i, j) engine's panel broadcasts
    scale with the mesh's 2-D shape, so it is the default whenever the mesh
    shape allows it."""
    if layout != "auto":
        return layout
    shape = dict(mesh.shape)
    if shape.get("i", 1) > 1 and shape.get("j", 1) > 1:
        return "2d"
    return "1d"


def _noise_plus_jitter(params, dtype):
    from gpras_tpu.ops import linalg

    jit = linalg.default_jitter(dtype)
    return jnp.exp(params["log_noise_variance"]) + jit * jnp.exp(params["log_variance"])


def dist_nlml_forward(mesh: Mesh, kernel: str, params: dict[str, Array],
                      x: Array, y: Array, b: int = 128,
                      layout: str = "auto"):
    """(nlml, (l, alpha)) with the factor left sharded on the mesh.

    ``y`` must be a single output column (N,): the logdet and constant terms
    are counted once (for multi-mode models, vmap/lax.map over modes — see
    GPRAS.fit — rather than passing an (N, P) matrix, which would silently
    drop P-1 logdet terms).

    ``layout`` selects the sharding: ``"1d"`` row strips over axis "i"
    (pcholesky.py) or ``"2d"`` P(i, j) tiles over a 2-D mesh
    (pcholesky2d.py — the BASELINE configs[4] layout; requires mesh axes
    "i" and "j").
    """
    if y.ndim != 1:
        raise ValueError(f"dist_nlml expects y of shape (N,), got {y.shape}; "
                         "map over output modes instead")
    layout = resolve_layout(mesh, layout)
    n = x.shape[0]
    noise = _noise_plus_jitter(params, x.dtype)
    if layout == "2d":
        from gpras_tpu.parallel.pcholesky2d import (dist_cho_solve_2d,
                                                    dist_cholesky_2d,
                                                    dist_logdet_from_chol_2d)
        from gpras_tpu.parallel.pgram import pgram_2d

        k = pgram_2d(mesh, kernel, params, x, noise=noise)
        l = dist_cholesky_2d(mesh, k, b=b)
        alpha = dist_cho_solve_2d(mesh, l, y, b=b)
        logdet = dist_logdet_from_chol_2d(mesh, l)
    elif layout == "1d":
        k = pgram_rows(mesh, kernel, params, x, noise=noise)
        l = dist_cholesky(mesh, k, b=b)
        alpha = dist_cho_solve(mesh, l, y, b=b)
        logdet = dist_logdet_from_chol(mesh, l)
    else:
        raise ValueError(f"unknown layout {layout!r}; expected '1d' or '2d'")
    quad = 0.5 * jnp.vdot(y, alpha)
    nlml = quad + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
    return nlml, (l, alpha)


def make_dist_nlml(mesh: Mesh, kernel: str, b: int = 128, col_batch: int = 256,
                   layout: str = "auto"):
    """Returns ``nlml(params, x, y)`` differentiable w.r.t. params, with the
    Cholesky-factor-reusing backward described in the module docstring.
    ``layout="2d"`` runs the forward on the P(i, j)-tiled engine
    (pcholesky2d), the backward's solves in the same layout, and the
    Gram-vjp contraction fully tiled P(i, j): device (a, b) contracts its
    (N/di, c/dj) cotangent tile against gram(x_rows_a, x_cols_b), and
    shard_map's varying-axis tracking psums the pullback over both axes
    toward the replicated params — each tile is distinct, so there is no
    double counting (validated vs the 1-D gradients in test_pcholesky2d)."""
    layout = resolve_layout(mesh, layout)
    if layout == "2d":
        from gpras_tpu.parallel.pcholesky2d import dist_cho_solve_2d
        solver = lambda l, rhs: dist_cho_solve_2d(mesh, l, rhs, b=b)
    else:
        solver = lambda l, rhs: dist_cho_solve(mesh, l, rhs, b=b)

    @jax.custom_vjp
    def nlml(params, x, y):
        return dist_nlml_forward(mesh, kernel, params, x, y, b=b,
                                 layout=layout)[0]

    def fwd(params, x, y):
        out, (l, alpha) = dist_nlml_forward(mesh, kernel, params, x, y, b=b,
                                            layout=layout)
        return out, (params, x, y, l, alpha)

    def bwd(res, g):
        params, x, y, l, alpha = res
        n = x.shape[0]
        dj = mesh.shape["j"] if layout == "2d" else 1
        # c must divide N (batch loop) and, for 2-D, split evenly over "j"
        c = min(col_batch, n)
        while c >= dj and (n % c != 0 or c % dj != 0):
            c -= 1
        if c < dj or n % c != 0 or c % dj != 0:
            raise ValueError(
                f"no column batch <= {col_batch} divides N={n} and is a "
                f"multiple of the mesh 'j' axis ({dj}); raise col_batch")
        nbatch = n // c

        def local_contract(p, x_rows, x_cols, kbar_tile):
            """vjp of the local Gram tile w.r.t. params.

            Under shard_map's varying-manual-axes semantics the pullback toward
            the replicated (unvarying) ``p`` already includes the cross-device
            psum (broadcast transposes to reduce) — do NOT psum again."""
            _, pullback = jax.vjp(lambda pp: K.gram(kernel, pp, x_rows, x_cols), p)
            (grads,) = pullback(kbar_tile)
            return grads

        if layout == "2d":
            # fully tiled backward: device (a, b) contracts the
            # (N/di, c/dj) cotangent tile against its gram(x_rows_a,
            # x_cols_b) jacobian — per-device work scales with the 2-D
            # mesh shape, like the forward
            contract = shard_map(
                local_contract, mesh=mesh,
                in_specs=(jax.tree.map(lambda _: P(), params), P("i", None),
                          P("j", None), P("i", "j")),
                out_specs=jax.tree.map(lambda _: P(), params))
        else:
            contract = shard_map(
                local_contract, mesh=mesh,
                in_specs=(jax.tree.map(lambda _: P(), params), P("i", None),
                          P(None, None), P("i", None)),
                out_specs=jax.tree.map(lambda _: P(), params))

        def batch_step(j, carry):
            grads_acc, diag_acc = carry
            # identity columns [j*c, (j+1)*c)
            cols = j * c + jnp.arange(c)
            eye_cols = (jnp.arange(n)[:, None] == cols[None, :]).astype(x.dtype)
            z = solver(l, eye_cols)  # (N, c) = K^{-1} cols
            alpha_cols = alpha[cols]
            kbar_cols = 0.5 * g * (z - alpha[:, None] * alpha_cols[None, :])
            # diagonal contribution (for the noise/jitter term)
            diag_vals = kbar_cols[cols, jnp.arange(c)]
            diag_acc = diag_acc + jnp.sum(diag_vals)
            x_cols = x[cols]
            grads_b = contract(params, x, x_cols, kbar_cols)
            grads_acc = jax.tree.map(jnp.add, grads_acc, grads_b)
            return grads_acc, diag_acc

        zero_grads = jax.tree.map(jnp.zeros_like, params)
        grads, diag_sum = jax.lax.fori_loop(
            0, nbatch, batch_step, (zero_grads, jnp.zeros((), x.dtype)))
        # d(noise + jitter*variance)/dparams on the diagonal
        grads["log_noise_variance"] = grads.get("log_noise_variance", 0.0) + \
            diag_sum * jnp.exp(params["log_noise_variance"])
        from gpras_tpu.ops import linalg

        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        y_bar = g * alpha
        return grads, jnp.zeros_like(x), y_bar

    nlml.defvjp(fwd, bwd)
    return nlml


def make_dist_nlml_stochastic(mesh: Mesh, kernel: str, b: int = 128,
                              col_batch: int = 256, layout: str = "auto",
                              probes: int = 16):
    """Returns ``nlml(params, x, y, key)``: the distributed NLML with a
    Hutchinson stochastic-trace backward — the large-N upgrade over
    :func:`make_dist_nlml`'s exact backward.

    The exact backward reconstructs all N columns of K^{-1} through
    distributed solves (O(N^3) per step — it re-does a factorization-sized
    job batch by batch). Here the trace term uses m Rademacher probes
    (gp/exact_stochastic.py, the same estimator the single-chip headline
    engine runs): ONE distributed solve of the (N, m) probe block, then the
    rank-(m+1) cotangent  Kbar = 0.5 g [(1/m) W Z^T - alpha alpha^T]  is
    contracted against the Gram jacobian one column batch at a time with
    outer products instead of solves — O(N^2 (d + m)) per step. Layout
    semantics (1-D / 2-D tiling of the contraction) match make_dist_nlml.
    Gradients are unbiased; pass a fresh ``key`` per step."""
    layout = resolve_layout(mesh, layout)
    if layout == "2d":
        from gpras_tpu.parallel.pcholesky2d import dist_cho_solve_2d
        solver = lambda l, rhs: dist_cho_solve_2d(mesh, l, rhs, b=b)
    else:
        solver = lambda l, rhs: dist_cho_solve(mesh, l, rhs, b=b)

    @jax.custom_vjp
    def nlml(params, x, y, key):
        return dist_nlml_forward(mesh, kernel, params, x, y, b=b,
                                 layout=layout)[0]

    def fwd(params, x, y, key):
        out, (l, alpha) = dist_nlml_forward(mesh, kernel, params, x, y, b=b,
                                            layout=layout)
        return out, (params, x, l, alpha, key)

    def bwd(res, g):
        params, x, l, alpha, key = res
        n = x.shape[0]
        dj = mesh.shape["j"] if layout == "2d" else 1
        c = min(col_batch, n)
        while c >= dj and (n % c != 0 or c % dj != 0):
            c -= 1
        if c < dj or n % c != 0 or c % dj != 0:
            raise ValueError(
                f"no column batch <= {col_batch} divides N={n} and is a "
                f"multiple of the mesh 'j' axis ({dj}); raise col_batch")
        nbatch = n // c
        z = jax.random.rademacher(key, (n, probes), dtype=x.dtype)
        w = solver(l, z)  # ONE distributed (N, m) solve: K^{-1} Z
        inv_m = jnp.asarray(1.0 / probes, x.dtype)

        def local_contract(p, x_rows, x_cols, kbar_tile):
            # pullback toward replicated p psums over the mesh via
            # shard_map's varying-axis tracking — do NOT psum again
            _, pullback = jax.vjp(
                lambda pp: K.gram(kernel, pp, x_rows, x_cols), p)
            (grads,) = pullback(kbar_tile)
            return grads

        if layout == "2d":
            contract = shard_map(
                local_contract, mesh=mesh,
                in_specs=(jax.tree.map(lambda _: P(), params), P("i", None),
                          P("j", None), P("i", "j")),
                out_specs=jax.tree.map(lambda _: P(), params))
        else:
            contract = shard_map(
                local_contract, mesh=mesh,
                in_specs=(jax.tree.map(lambda _: P(), params), P("i", None),
                          P(None, None), P("i", None)),
                out_specs=jax.tree.map(lambda _: P(), params))

        def batch_step(j, carry):
            grads_acc, diag_acc = carry
            cols = j * c + jnp.arange(c)
            # rank-(m+1) cotangent: no solve — two skinny matmuls
            kbar_cols = 0.5 * g * (
                inv_m * jnp.matmul(w, z[cols].T, preferred_element_type=x.dtype)
                - alpha[:, None] * alpha[cols][None, :])
            diag_acc = diag_acc + jnp.sum(kbar_cols[cols, jnp.arange(c)])
            grads_b = contract(params, x, x[cols], kbar_cols)
            grads_acc = jax.tree.map(jnp.add, grads_acc, grads_b)
            return grads_acc, diag_acc

        zero_grads = jax.tree.map(jnp.zeros_like, params)
        grads, diag_sum = jax.lax.fori_loop(
            0, nbatch, batch_step, (zero_grads, jnp.zeros((), x.dtype)))
        from gpras_tpu.ops import linalg

        grads["log_noise_variance"] = grads["log_noise_variance"] + \
            diag_sum * jnp.exp(params["log_noise_variance"])
        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        return grads, jnp.zeros_like(x), g * alpha, None

    nlml.defvjp(fwd, bwd)
    return nlml


def make_dist_fit_step(mesh: Mesh, kernel: str, b: int = 128,
                       learning_rate: float = 0.01, layout: str = "auto",
                       backward: str = "exact", probes: int = 16):
    """One jitted Adam step on the distributed NLML — the multi-chip training
    step (used by ``__graft_entry__.dryrun_multichip``). ``layout="auto"``
    picks the 2-D P(i, j) engine on 2-D meshes (resolve_layout).
    ``backward="hutchinson"`` swaps the exact O(N^3) backward for the
    stochastic-trace one (make_dist_nlml_stochastic); the returned step then
    takes and returns a PRNG key: ``step(params, opt_state, x, y, key)``."""
    import optax

    opt = optax.adam(learning_rate)

    def init(params):
        return opt.init(params)

    if backward == "hutchinson":
        nlml_s = make_dist_nlml_stochastic(mesh, kernel, b=b, layout=layout,
                                           probes=probes)

        @jax.jit
        def step_h(params, opt_state, x, y, key):
            key, sub = jax.random.split(key)
            loss, grads = jax.value_and_grad(nlml_s)(params, x, y, sub)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, key

        return init, step_h
    if backward != "exact":
        raise ValueError(f"unknown backward {backward!r}; "
                         "expected 'exact' or 'hutchinson'")
    nlml = make_dist_nlml(mesh, kernel, b=b, layout=layout)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(nlml)(params, x, y)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return init, step

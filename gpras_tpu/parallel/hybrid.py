"""Hybrid data x model parallel training over a 3-axis ("dp", "i", "j") mesh.

Multi-host scaling design (greenfield — the reference has no distributed
runtime at all, SURVEY.md section 2.2): the surrogate is a stack of
INDEPENDENT per-EOF-mode latent GPs over a shared input matrix
(/root/reference/gpras/gpr.py:289-330 fits one GPflow model per mode), so
the mode axis is the framework's weak-communication axis — no collective
ever crosses it during a fit step. That is exactly the axis to place on the
network when a job spans several hosts ("How to Scale Your Model": put the
axis with the lowest communication volume on the slowest interconnect):

- axis "dp" (across hosts): EOF modes. Each host group fits its local
  modes' hyperparameters; zero cross-host traffic inside the step.
- axes ("i", "j") (within a host, NVLink): the N x N Gram, 2-D P(i, j)
  tiled — Cholesky panel broadcasts, solve corrections, and gradient psums
  all stay on the fast links (pcholesky2d.py).

The whole multi-mode step is ONE ``shard_map`` over the 3-axis mesh; inside,
each device loops its group's local modes (``lax.map``, lockstep trip count
across groups) and runs the per-device bodies of the 2-D distributed engine
(``dist_cholesky_2d_local`` / ``dist_solve_*_2d_local``) with collectives
over ("i", "j") only. Gradients use the same rank-(m+1) Hutchinson
stochastic-trace cotangent as the single-chip headline engine and the
mesh-level distributed backward (pexact.make_dist_nlml_stochastic):
one (N, 1+m) distributed solve yields alpha and W = K^-1 Z, then
Kbar = 0.5 [(1/m) W Z^T - alpha alpha^T] is contracted against each
device's LOCAL Gram-tile jacobian and psummed over ("i", "j").

On one host the same code runs with "dp" mapped to local devices (any
3-axis mesh works); the layout is validated on a virtual (2, 2, 2)
CPU mesh in tests/test_hybrid.py and __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg
from gpras_tpu.parallel.pcholesky2d import (
    dist_cholesky_2d_local,
    dist_solve_lower_2d_local,
    dist_solve_upper_2d_local,
)

Array = jax.Array

AXES = ("dp", "i", "j")


def check_hybrid_shapes(mesh: Mesh, n: int, p_modes: int, b: int,
                        axes: tuple[str, str, str] = AXES) -> None:
    adp, ai, aj = axes
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"hybrid step needs mesh axis {a!r}; "
                             f"mesh has {tuple(mesh.shape)}")
    ddp, di, dj = mesh.shape[adp], mesh.shape[ai], mesh.shape[aj]
    if p_modes % ddp != 0:
        raise ValueError(f"P={p_modes} modes must divide mesh axis "
                         f"{adp!r}={ddp}")
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by mesh axes ({di}, {dj})")
    if (n // di) % b != 0 or (n // dj) % b != 0:
        raise ValueError(
            f"block size {b} must divide both local extents "
            f"({n // di} rows, {n // dj} cols)")


def make_hybrid_nlml_and_grads(mesh: Mesh, kernel: str, b: int = 128,
                               probes: int = 16,
                               axes: tuple[str, str, str] = AXES):
    """Returns ``fn(params_b, x, y_modes, key) -> (losses, grads)``.

    ``params_b``: per-mode hyperparameter pytree with leading mode axis (P,
    ...), sharded P("dp"). ``x``: (N, D) replicated. ``y_modes``: (N, P)
    with modes sharded P(None, "dp"). ``losses``: (P,) per-mode NLML values
    (no prior term — same objective as pexact.make_dist_nlml). ``grads``:
    pytree like ``params_b`` — unbiased Hutchinson stochastic-trace
    gradients; pass a fresh ``key`` per step (probe draws are folded per
    GLOBAL mode index, so they are independent across modes and
    reproducible for testing).
    """
    adp, ai, aj = axes

    def body(params_loc, x_rows, x_cols, y_loc, key):
        nr, nc = x_rows.shape[0], x_cols.shape[0]
        di = jax.lax.axis_size(ai)
        n = nr * di
        mi = jax.lax.axis_index(ai)
        mj = jax.lax.axis_index(aj)
        mdp = jax.lax.axis_index(adp)
        gidx_r = mi * nr + jnp.arange(nr)
        gidx_c = mj * nc + jnp.arange(nc)
        diag_mask = (gidx_r[:, None] == gidx_c[None, :])
        pm = y_loc.shape[1]  # local modes per slice
        dtype = x_rows.dtype
        jit = linalg.default_jitter(dtype)
        inv_m = jnp.asarray(1.0 / probes, dtype)

        def one_mode(idx):
            p = jax.tree.map(lambda leaf: leaf[idx], params_loc)
            y_col = y_loc[:, idx]
            gmode = mdp * pm + idx
            z = jax.random.rademacher(jax.random.fold_in(key, gmode),
                                      (n, probes), dtype=dtype)

            noise = jnp.exp(p["log_noise_variance"]) + \
                jit * jnp.exp(p["log_variance"])
            k_tile = K.gram(kernel, p, x_rows, x_cols)
            k_tile = k_tile + noise * diag_mask.astype(dtype)
            l_loc = dist_cholesky_2d_local(k_tile, b=b, axes=(ai, aj))

            # one (N, 1+m) distributed solve: alpha = K^-1 y, W = K^-1 Z
            rhs = jnp.concatenate([y_col[:, None], z], axis=1)
            sol = dist_solve_upper_2d_local(
                l_loc,
                dist_solve_lower_2d_local(l_loc, rhs, b=b, axes=(ai, aj)),
                b=b, axes=(ai, aj))
            alpha = sol[:, 0]
            w = sol[:, 1:]

            # logdet from local diagonal entries of the factor
            lc = gidx_r - mj * nc
            inside = (lc >= 0) & (lc < nc)
            dvals = l_loc[jnp.arange(nr), jnp.clip(lc, 0, nc - 1)]
            logdet = 2.0 * jax.lax.psum(
                jnp.sum(jnp.where(inside, jnp.log(dvals), 0.0)), (ai, aj))
            loss = 0.5 * jnp.vdot(y_col, alpha) + 0.5 * logdet + \
                0.5 * n * math.log(2.0 * math.pi)

            # rank-(m+1) stochastic cotangent, tiled to this device's block
            i32 = lambda v: jnp.asarray(v, jnp.int32)
            w_rows = jax.lax.dynamic_slice(w, (i32(mi * nr), i32(0)),
                                           (nr, probes))
            z_cols = jax.lax.dynamic_slice(z, (i32(mj * nc), i32(0)),
                                           (nc, probes))
            a_rows = jax.lax.dynamic_slice(alpha, (i32(mi * nr),), (nr,))
            a_cols = jax.lax.dynamic_slice(alpha, (i32(mj * nc),), (nc,))
            kbar = 0.5 * (
                inv_m * jnp.matmul(w_rows, z_cols.T, preferred_element_type=dtype)
                - a_rows[:, None] * a_cols[None, :])

            # pullback toward p (unvarying over i/j) already psums over the
            # mesh via shard_map's varying-axis tracking — do NOT psum again
            _, pullback = jax.vjp(
                lambda pp: K.gram(kernel, pp, x_rows, x_cols), p)
            (gr,) = pullback(kbar)
            diag_sum = jax.lax.psum(
                jnp.sum(jnp.where(diag_mask, kbar, 0.0)), (ai, aj))
            gr["log_noise_variance"] = gr["log_noise_variance"] + \
                diag_sum * jnp.exp(p["log_noise_variance"])
            gr["log_variance"] = gr["log_variance"] + \
                diag_sum * jit * jnp.exp(p["log_variance"])
            return loss, gr

        return jax.lax.map(one_mode, jnp.arange(pm))

    def nlml_and_grads(params_b, x, y_modes, key):
        n, p_modes = y_modes.shape
        check_hybrid_shapes(mesh, n, p_modes, b, axes)
        specs_in = (jax.tree.map(lambda _: P(adp), params_b), P(ai, None),
                    P(aj, None), P(None, adp), P())
        specs_out = (P(adp), jax.tree.map(lambda _: P(adp), params_b))
        f = shard_map(body, mesh=mesh, in_specs=specs_in,
                      out_specs=specs_out)
        return f(params_b, x, x, y_modes, key)

    return nlml_and_grads


def make_hybrid_fit_step(mesh: Mesh, kernel: str, b: int = 128,
                         probes: int = 16, learning_rate: float = 0.01,
                         axes: tuple[str, str, str] = AXES):
    """One jitted Adam step fitting ALL modes' hyperparameters at once on the
    hybrid ("dp", "i", "j") layout: ``step(params_b, opt_state, x, y_modes,
    key) -> (params_b, opt_state, losses, key)``. The optimizer update is
    elementwise, so it runs sharded P("dp") with no extra communication.
    """
    import optax

    opt = optax.adam(learning_rate)
    nlml_and_grads = make_hybrid_nlml_and_grads(mesh, kernel, b=b,
                                                probes=probes, axes=axes)

    def init(params_b):
        return opt.init(params_b)

    @jax.jit
    def step(params_b, opt_state, x, y_modes, key):
        key, sub = jax.random.split(key)
        losses, grads = nlml_and_grads(params_b, x, y_modes, sub)
        updates, opt_state = opt.update(grads, opt_state, params_b)
        params_b = optax.apply_updates(params_b, updates)
        return params_b, opt_state, losses, key

    return init, step

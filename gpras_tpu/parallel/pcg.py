"""Distributed matrix-free exact-GP: row-sharded CG + SLQ over a device mesh.

The single-chip matrix-free engine (gp/exact_cg.py) caps out at whatever one
chip can stream; this module shards the MATVEC — the only O(N^2) work in the
whole algorithm — across the mesh:

    (K @ V)[rows_d] = k(x[rows_d], x) @ V        per device d

Each device holds its row shard of x and rebuilds its (N/d, N) Gram strip
tile-by-tile against the (replicated) full x; no element of K is ever stored
and the ONLY collective in the CG iteration is the psum of the dot products
(alpha/beta scalars) — V itself stays fully replicated (N x R is tiny).
Communication per iteration: 2 scalar-psums. This is the shard_map analog of
distributed BBMM, and scales N linearly with the mesh (per-device memory
bounds only the O(N * panel) streaming buffers).

Gradients use the same rank-(m+1) cotangent as the single-chip engine,
contracted against each device's own Gram strip via a local vjp and one psum.
Reference capability anchor: the reference has no exact GP and no distribution
at all (SURVEY.md section 2.2); this is the BASELINE.json configs[4]
"N >= 100k" axis taken past one device's memory.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gpras_tpu.gp.priors import log_prior
from gpras_tpu.gp.exact_cg import _slq_logdet_from_coeffs
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg

Array = jax.Array


def _local_kmv(kernel, params, x_local, x_full, v, noise, row_panel, axis):
    """One device's rows of (K + noise I) @ v: this device's (N/d, N) Gram
    strip contracted with the replicated v — exact_cg.kmv_cross streams the
    tiles (and takes the fused Pallas matvec where ops/fused.use_fused
    holds), so no element of
    the strip is ever resident."""
    from gpras_tpu.gp.exact_cg import kmv_cross

    nl = x_local.shape[0]
    out = kmv_cross(kernel, params, x_local, x_full, v, row_panel)
    # noise * v restricted to this device's rows
    axis_idx = jax.lax.axis_index(axis)
    row0 = axis_idx * nl
    v_rows = jax.lax.dynamic_slice_in_dim(v, row0, nl, axis=0)
    return out + noise * v_rows


def dist_pivoted_cholesky(mesh: Mesh, kernel: str, params, x: Array,
                          rank: int, axis: str = "i") -> Array:
    """Rank-``rank`` pivoted-Cholesky factor of K(x, x), replicated.

    The factor is O(N * rank) — negligible next to the O(N^2) matvec work —
    so each device all_gathers x (N x D, tiny) and runs the identical greedy
    matrix-free build (gp/exact_cg.pivoted_cholesky): zero communication
    beyond the one coordinate gather, bit-identical replicated output (the
    greedy pivot order is deterministic)."""
    from gpras_tpu.gp.exact_cg import pivoted_cholesky

    def body_fn(x_local):
        x_full = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
        return pivoted_cholesky(kernel, params, x_full, rank)

    fn = shard_map(body_fn, mesh=mesh, in_specs=(P(axis),), out_specs=P(),
                   check_vma=False)
    return fn(x)


def dist_mbcg(mesh: Mesh, kernel: str, params, x: Array, b: Array,
              noise, max_iters: int = 32, tol: float = 1e-6,
              row_panel: int = 1024, axis: str = "i",
              l_pc: Array | None = None):
    """Batched (preconditioned) CG with the matvec row-sharded over the mesh.

    x: (N, D) row-sharded; b: (N, R) replicated; ``l_pc`` an optional
    replicated (N, k) pivoted-Cholesky factor — when given, the iteration is
    PCG against P = l_pc l_pc^T + noise I via the Woodbury apply (all small
    replicated matmuls, no extra collectives). Returns (solution (N, R),
    alphas (k, R), betas (k, R), rz0 (R,)) replicated, where rz0 = b^T P^{-1} b
    is the SLQ probe weight (== ||b||^2 unpreconditioned). The iteration state
    (p, res) is kept replicated; each device computes its row block of A@p and
    the blocks are all-gathered (the only O(N R) collective), while the
    reduction scalars psum.
    """
    n, r = b.shape

    def _make_body(with_pc: bool):
        def body_fn(x_local, b_rep, *pc_args):
            if with_pc:
                from gpras_tpu.gp.exact_cg import make_woodbury_pinv

                pinv, _ = make_woodbury_pinv(pc_args[0], noise)
            else:
                pinv = lambda v: v
            b2 = jnp.sum(b_rep * b_rep, axis=0)
            stop2 = (tol * tol) * b2
            z0 = pinv(b_rep)
            rz0 = jnp.sum(b_rep * z0, axis=0)
            # gather the full coordinates once (N x D is tiny); every matvec
            # then costs one all_gather of the (N, R) product blocks
            x_full = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)

            def mv(v):
                local = _local_kmv(kernel, params, x_local, x_full,
                                   v, noise, row_panel, axis)
                return jax.lax.all_gather(local, axis, axis=0, tiled=True)

            def step(i, carry):
                sol, p, res, rz, alphas, betas, done = carry
                ap = mv(p)
                pap = jnp.sum(p * ap, axis=0)
                # f32 breakdown guard (same as exact_cg.mbcg): freeze a column
                # permanently on non-positive/non-finite curvature or residual
                # energy so no garbage enters the SLQ tridiagonal
                broken = (pap <= 0) | ~jnp.isfinite(pap)
                done_now = done | broken
                alpha = jnp.where(done_now, 0.0,
                                  rz / jnp.where(pap > 0, pap, 1.0))
                sol = sol + alpha[None, :] * p
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
                return sol, p, res, rz_next, alphas, betas, done

            # all_gather'ed matvec outputs are typed 'varying over axis' under
            # shard_map; the carry must match from iteration 0
            init = jax.tree.map(
                lambda a: jax.lax.pcast(a, (axis,), to="varying"),
                (jnp.zeros_like(b_rep), z0, b_rep, rz0,
                 jnp.zeros((max_iters, r), b_rep.dtype),
                 jnp.zeros((max_iters, r), b_rep.dtype),
                 jnp.zeros((r,), bool)))
            sol, _, _, _, alphas, betas, _ = jax.lax.fori_loop(
                0, max_iters, step, init)
            return sol, alphas, betas, rz0

        return body_fn

    # outputs are numerically replicated (every device all_gathers the same
    # blocks) but the VMA type system cannot prove it -> check_vma=False
    if l_pc is None:
        fn = shard_map(_make_body(False), mesh=mesh,
                       in_specs=(P(axis), P()),
                       out_specs=(P(), P(), P(), P()), check_vma=False)
        return fn(x, b)
    fn = shard_map(_make_body(True), mesh=mesh,
                   in_specs=(P(axis), P(), P()),
                   out_specs=(P(), P(), P(), P()), check_vma=False)
    return fn(x, b, l_pc)


def make_dist_cg_nlml(mesh: Mesh, kernel: str, probes: int = 8,
                      max_iters: int = 32, row_panel: int = 1024,
                      col_panel: int = 1024, axis: str = "i",
                      precond_rank: int = 0):
    """Distributed matrix-free NLML with the BBMM stochastic gradient.

    Returns ``nlml(params, x_sharded, y, key)``; x must be placed with
    PartitionSpec((axis,)) rows, y/key replicated. Value = exact quad +
    SLQ logdet; gradient = rank-(m+1) cotangent contracted against each
    device's Gram strip (one psum).

    ``precond_rank`` > 0 enables the full preconditioned BBMM path — the same
    math as the single-chip engine (gp/exact_cg.make_cg_nlml: PCG against
    P = L_k L_k^T + noise I, probes ~ N(0, P), logdet K = logdet P +
    SLQ(T_pcg), trace via E[z z^T] = P) with the SAME key-split/draw order,
    so a given key produces identical randomness on 1 chip and on the mesh.
    The factor build and every Woodbury apply are replicated O(N k) work; the
    collectives per CG iteration are unchanged (one (N, R) all_gather).
    """

    def solves(params, x, y, key):
        n = x.shape[0]
        noise = jnp.exp(params["log_noise_variance"]) + \
            linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        if precond_rank > 0:
            from gpras_tpu.gp.exact_cg import make_woodbury_pinv

            l_pc = dist_pivoted_cholesky(mesh, kernel, params, x,
                                         precond_rank, axis=axis)
            pinv, logdet_p = make_woodbury_pinv(l_pc, noise)
            k1, k2 = jax.random.split(key)
            u1 = jax.random.normal(k1, (precond_rank, probes), x.dtype)
            u2 = jax.random.normal(k2, (n, probes), x.dtype)
            z = l_pc @ u1 + jnp.sqrt(noise) * u2  # z ~ N(0, P)
        else:
            l_pc, pinv, logdet_p = None, None, 0.0
            z = jax.random.rademacher(key, (n, probes), dtype=x.dtype)
        b = jnp.concatenate([y[:, None], z], axis=1)
        sol, alphas, betas, rz0 = dist_mbcg(mesh, kernel, params, x, b, noise,
                                            max_iters, row_panel=row_panel,
                                            axis=axis, l_pc=l_pc)
        logdet = logdet_p + _slq_logdet_from_coeffs(
            alphas[:, 1:], betas[:, 1:], rz0[1:])
        v = pinv(z) if precond_rank > 0 else z
        return sol[:, 0], sol[:, 1:], v, logdet

    def value(params, x, y, key):
        n = x.shape[0]
        alpha_y, _, _, logdet = solves(params, x, y, key)
        return (0.5 * jnp.vdot(y, alpha_y) + 0.5 * logdet
                + 0.5 * n * math.log(2.0 * math.pi))

    @jax.custom_vjp
    def nlml(params, x, y, key):
        return value(params, x, y, key)

    def fwd(params, x, y, key):
        n = x.shape[0]
        alpha_y, w, v, logdet = solves(params, x, y, key)
        out = (0.5 * jnp.vdot(y, alpha_y) + 0.5 * logdet
               + 0.5 * n * math.log(2.0 * math.pi))
        return out, (params, x, alpha_y, w, v)

    def bwd(res, g):
        # v = P^{-1} z under preconditioning (z itself otherwise):
        # tr(K^{-1} dK) = E_{z~N(0,P)}[(K^{-1}z)^T dK (P^{-1}z)]
        params, x, alpha, w, v = res
        n = x.shape[0]
        inv_m = 1.0 / probes

        def local_grads(x_local, alpha_rep, w_rep, z_rep):
            x_full = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
            nl = x_local.shape[0]
            axis_idx = jax.lax.axis_index(axis)
            row0 = axis_idx * nl
            # this device's rows of the cotangent:
            # Kbar[rows] = 0.5 g [(1/m) W_rows V^T - alpha_rows alpha^T]
            w_rows = jax.lax.dynamic_slice_in_dim(w_rep, row0, nl, axis=0)
            a_rows = jax.lax.dynamic_slice_in_dim(alpha_rep, row0, nl, axis=0)
            kbar_rows = 0.5 * g * (inv_m * (w_rows @ z_rep.T)
                                   - a_rows[:, None] * alpha_rep[None, :])
            _, pullback = jax.vjp(
                lambda pp: K.gram(kernel, pp, x_local, x_full), params)
            (grads_t,) = pullback(kbar_rows)
            grads_t = jax.tree.map(lambda a: jax.lax.psum(a, axis), grads_t)
            # diagonal term (noise/jitter path): local diag entries
            idx = jnp.arange(nl)
            diag_local = jnp.sum(kbar_rows[idx, row0 + idx])
            diag_sum = jax.lax.psum(diag_local, axis)
            return grads_t, diag_sum

        fn = shard_map(local_grads, mesh=mesh,
                       in_specs=(P(axis), P(), P(), P()),
                       out_specs=(P(), P()), check_vma=False)
        grads, diag_sum = fn(x, alpha, w, v)
        grads["log_noise_variance"] = grads["log_noise_variance"] + \
            diag_sum * jnp.exp(params["log_noise_variance"])
        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        return grads, jnp.zeros_like(x), g * alpha, None

    nlml.defvjp(fwd, bwd)

    def loss(params, x, y, key):
        return nlml(params, x, y, key) - log_prior(params)

    return nlml, loss

"""Preconditioner-rank frontier for the HONEST giant-N CG+SLQ evaluation.

The honest cold-fit protocol (gp/coldfit.py) pays 256 preconditioned CG
iterations per NLML evaluation at rank-128 pivoted-Cholesky preconditioning.
An earlier iters/rank frontier showed rank <= 128 cannot substitute for
Lanczos steps AT FIXED TINY ITERATION COUNTS (12-32); whether a HIGH-rank
preconditioner (256-1024) collapses the iteration count needed for honest
residual convergence (the 0.1 solver-validity gate; ~2-5% measured at
256/128) was never measured. A rank-k pivoted Cholesky costs O(N k (k + d))
once per evaluation and O(N k) per CG apply, against O(N^2 d) for the Gram
pass of every CG iteration, so a high rank that reaches the gate in far
fewer iterations makes the evaluation cheaper at identical (better) solve
quality.

For each rank this script runs ONE segmented mbcg solve (same state machine
as exact_cg.make_cg_step_chunked — seg-iteration programs) and, at every
segment boundary, fetches the relative residuals
(y column / probe median / probe max), the partial-coefficient SLQ logdet,
and the running NLML value. Output: one JSON line per (rank, iteration
checkpoint) on stdout; a summary line per rank at the end.

Run: ``python benchmarks/precond_sweep.py [N] [NOISE] [RANKS...]``
(defaults: N=131072, noise=0.01 — the true-noise region where the honest
protocol's residuals were measured; ranks 128 256 512 1024).
Knobs: GPRAS_SWEEP_ITERS (default 256), GPRAS_SWEEP_SEG (default 16),
GPRAS_SWEEP_PROBES (default 127).
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gpras_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main() -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from gpras_tpu.gp import exact
    from gpras_tpu.gp.exact_cg import (_mbcg_init, _mbcg_run,
                                       _slq_logdet_from_coeffs, kmv,
                                       make_woodbury_pinv, pivoted_cholesky)
    from gpras_tpu.ops import linalg

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    noise_var = float(sys.argv[2]) if len(sys.argv) > 2 else 0.01
    ranks = [int(a) for a in sys.argv[3:]] or [128, 256, 512, 1024]
    max_iters = int(os.environ.get("GPRAS_SWEEP_ITERS", "256"))
    seg = int(os.environ.get("GPRAS_SWEEP_SEG", "16"))
    probes = int(os.environ.get("GPRAS_SWEEP_PROBES", "127"))
    kernel = "Matern52"

    x, y = bench._make_data(n, 8, jnp.float32)
    params = exact.init_params(kernel, x, noise_variance=noise_var)
    print(f"# N={n} noise={noise_var} iters={max_iters} seg={seg} "
          f"probes={probes} ranks={ranks}", file=sys.stderr, flush=True)

    @partial(jax.jit, static_argnames=("rank",))
    def build_pc(params, x, rank):
        return pivoted_cholesky(kernel, params, x, rank)

    @jax.jit
    def setup(params, x, y, key, l_pc):
        noise = jnp.exp(params["log_noise_variance"]) + \
            linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        pinv, logdet_p = make_woodbury_pinv(l_pc, noise)
        k1, k2 = jax.random.split(key)
        rank = l_pc.shape[1]
        u1 = jax.random.normal(k1, (rank, probes), x.dtype)
        u2 = jax.random.normal(k2, (n, probes), x.dtype)
        z = l_pc @ u1 + jnp.sqrt(noise) * u2
        b = jnp.concatenate([y[:, None], z], axis=1)
        carry, rz0, stop2 = _mbcg_init(b, max_iters, 1e-7, pinv)
        return carry, rz0, stop2, noise, logdet_p, jnp.sum(b * b, axis=0)

    @jax.jit
    def segment(params, x, carry, noise, stop2, l_pc, i0):
        pinv, _ = make_woodbury_pinv(l_pc, noise)
        mv = lambda v: kmv(kernel, params, x, v, noise)
        return _mbcg_run(mv, carry, i0, i0 + seg, stop2, pinv)

    @jax.jit
    def checkpoint(carry, rz0, b2, logdet_p, y):
        sol, _, res, _, alphas, betas, _ = carry
        rel = jnp.sqrt(jnp.sum(res * res, axis=0) / jnp.maximum(b2, 1e-30))
        logdet = logdet_p + _slq_logdet_from_coeffs(
            alphas[:, 1:], betas[:, 1:], rz0[1:])
        quad = 0.5 * jnp.vdot(y, sol[:, 0])
        return rel[0], jnp.median(rel[1:]), jnp.max(rel[1:]), logdet, quad

    key = jax.random.PRNGKey(0)
    summaries = []
    for rank in ranks:
        t0 = time.perf_counter()
        l_pc = build_pc(params, x, rank)
        jax.block_until_ready(l_pc)
        t_pc = time.perf_counter() - t0
        carry, rz0, stop2, noise, logdet_p, b2 = setup(
            params, x, y, key, l_pc)
        float(b2[0])
        t0 = time.perf_counter()
        gate_hit = None
        for i0 in range(0, max_iters, seg):
            carry = segment(params, x, carry, noise, stop2, l_pc, i0)
            ry, rmed, rmax, logdet, quad = checkpoint(
                carry, rz0, b2, logdet_p, y)
            row = {
                "rank": rank, "iters": i0 + seg,
                "t_cg": round(time.perf_counter() - t0, 2),
                "rel_res_y": float(ry), "rel_res_probe_med": float(rmed),
                "rel_res_probe_max": float(rmax),
                "logdet": round(float(logdet), 1),
                "nlml_quad": round(float(quad), 1),
            }
            print(json.dumps(row), flush=True)
            if gate_hit is None and max(row["rel_res_y"],
                                        row["rel_res_probe_max"]) < 0.1:
                gate_hit = dict(row)
        summary = {
            "rank": rank, "t_pivoted_cholesky": round(t_pc, 2),
            "gate_iters": gate_hit["iters"] if gate_hit else None,
            "gate_t_cg": gate_hit["t_cg"] if gate_hit else None,
            "gate_logdet": gate_hit["logdet"] if gate_hit else None,
            "final": row,
        }
        summaries.append(summary)
        print("# summary " + json.dumps(summary), file=sys.stderr, flush=True)
    print(json.dumps({"n": n, "noise": noise_var, "summaries": summaries}))


if __name__ == "__main__":
    main()

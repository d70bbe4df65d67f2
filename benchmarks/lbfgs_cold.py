"""Cold L-BFGS exact-GP fit to a convergence band (no warm start).

The bench's cold baseline is Adam lr=0.02 from standard init (600 steps on
the bench.py seeded problem: N=49,152, d=8, Matern52, Hutchinson
stochastic-trace loss). This script runs the SAME problem from the SAME
init through the host-chunked zoom-linesearch L-BFGS driver
(fit/optimizers.py lbfgs_fit_chunked), with the band-entry stopping rule
(loss <= L* + 1e-5|L*|) when an L* is given in GPRAS_LBFGS_STOP_LOSS (a
converged loss measured for this N, e.g. by bench.py's cold fit), and the
reference plateau rule otherwise. The trajectory itself is deterministic:
every run reproduces the same per-iteration losses.

Above exact_stochastic.dense_n_max() the (N, N) Gram no longer fits the
device, so the loss
switches to the matrix-free BBMM CG+SLQ engine run HONESTLY (gp/coldfit.py:
rank-128 pivoted-Cholesky preconditioning, 256 CG iterations, solver-
validity residual gate 0.1, host strong-Wolfe linesearch with segmented
dispatches) and the stop is the reference plateau rule applied per L-BFGS iteration (rel-tol 1e-5, patience
GPRAS_LBFGS_PATIENCE, default 10 — each iteration costs 1-3 full NLML
evaluations, so 50 would waste many minutes post-plateau). The cheap
24-iteration estimator (the bench step-timing unit) is NOT used here: a
linesearch optimizer exploits its truncation bias past the physically
possible NLML.

Run: ``python benchmarks/lbfgs_cold.py [N] [MAX_ITER] [CHUNK]``
Knobs: GPRAS_LBFGS_LS (max zoom-linesearch steps, default 8; 4 at N>=64k),
GPRAS_LBFGS_MEM (memory pairs, default 15), GPRAS_LBFGS_PATIENCE
(plateau patience in iterations, default 10), GPRAS_BENCH_CG_ITERS/
_CG_SEG/_CG_PROBES (honest-estimator shape, default 256/16/127),
GPRAS_LBFGS_HOSTLS (force the host/device linesearch),
GPRAS_LBFGS_STOP_DEC (noise-plateau stop in nats: end the fit after an
accepted step earning less than this, skipping the terminal failing
linesearch's gate-rejected trials — host-linesearch CG path only).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gpras_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main() -> dict:
    import numpy as np

    import jax
    import jax.numpy as jnp

    import bench
    from gpras_tpu.gp.coldfit import fit_exact
    from gpras_tpu.gp.exact_stochastic import dense_n_max

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 49152
    big = n > dense_n_max()
    max_iter = int(sys.argv[2]) if len(sys.argv) > 2 else (56 if big else 64)
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else None
    ls = int(os.environ.get("GPRAS_LBFGS_LS", "4" if big else "8"))
    mem = int(os.environ.get("GPRAS_LBFGS_MEM", "15"))
    patience = int(os.environ.get("GPRAS_LBFGS_PATIENCE", "10"))
    # the easy DGP by default; GPRAS_BENCH_DGP=hard runs the headline
    # problem (bench._make_data_hard)
    dgp = os.environ.get("GPRAS_BENCH_DGP", "easy")

    x, y = bench._make_data(n, 8, jnp.float32, dgp)

    stop = os.environ.get("GPRAS_LBFGS_STOP_LOSS")
    l_star = float(stop) if stop else None

    kwargs = dict(
        memory_size=mem, max_linesearch_steps=ls,
        probes=int(os.environ["GPRAS_BENCH_CG_PROBES"])
        if big and "GPRAS_BENCH_CG_PROBES" in os.environ else None,
        cg_iters=int(os.environ.get("GPRAS_BENCH_CG_ITERS", "256")),
        seg_iters=int(os.environ.get("GPRAS_BENCH_CG_SEG", "16")),
        # at N=524,288 the init eval is solver-gated at the 256-it budget
        # (CG needs ~sqrt(N) more iterations than 262k) — the honest
        # scale-out is a deeper budget and/or a stronger pivoted-Cholesky
        # preconditioner, both strictly-better numerics
        precond_rank=int(os.environ.get("GPRAS_BENCH_CG_RANK", "128")),
        host_linesearch=bool(int(os.environ["GPRAS_LBFGS_HOSTLS"]))
        if "GPRAS_LBFGS_HOSTLS" in os.environ else None,
        stop_decrease=float(os.environ["GPRAS_LBFGS_STOP_DEC"])
        if "GPRAS_LBFGS_STOP_DEC" in os.environ else None,
    )

    # warmup on a throwaway copy: compile/load only (one chunk program).
    # GPRAS_LBFGS_SKIP_WARMUP=1 skips it when the persistent compile cache
    # is known-hot for these exact shapes (at N>=524k the "warmup" is a full
    # L-BFGS iteration of ~20-min evaluations, not a compile formality;
    # iteration 1 of the timed fit then additionally carries the cached
    # executable LOAD, which is seconds)
    if os.environ.get("GPRAS_LBFGS_SKIP_WARMUP", "0") != "1":
        _ = fit_exact("Matern52", x, y, max_iter=1, chunk=1, **kwargs)
        print(f"# warmup ok (N={n})", file=sys.stderr)

    t0 = time.perf_counter()

    prev_best = [float("inf")]

    def report(done: int, best: float) -> None:
        dt = time.perf_counter() - t0
        earned = prev_best[0] - best  # inf on the first improving iteration
        prev_best[0] = min(prev_best[0], best)
        print(f"# iter {done:3d}  t={dt:7.1f}s  best={best:.2f}  "
              f"earned={earned:.2f}", file=sys.stderr, flush=True)

    p, info = fit_exact(
        "Matern52", x, y, max_iter=max_iter, chunk=chunk,
        stop_loss=l_star, patience=patience, progress=report, **kwargs)
    total = time.perf_counter() - t0

    losses = np.asarray(info["losses"])
    finite = losses[np.isfinite(losses)]
    # first iteration whose loss is within rel-tol of the final best —
    # where the plateau actually started (the patience tail is overhead)
    plateau_at = None
    if finite.size:
        best_v = float(finite.min())
        ok = np.where(losses <= best_v + 1e-5 * abs(best_v))[0]
        plateau_at = int(ok[0]) + 1 if ok.size else None
    out = {
        "n": n,
        "dgp": dgp,
        "engine": info["engine"],
        "iterations": int(info["iterations"]),
        "stopped_by": info["stopped_by"],
        "cold_lbfgs_seconds": round(total, 1),
        "best_loss": round(float(finite.min()), 2) if finite.size else None,
        "plateau_entry_iteration": plateau_at,
        "l_star": l_star,
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

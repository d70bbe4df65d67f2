"""Headline warm-protocol sweep at N=49,152 on the hard DGP (aim: the
honest headline under 10 s).

Sweeps the existing protocol knobs — rung optimizer (Adam replay vs
zoom-linesearch L-BFGS), rung size, polish-only Adam rate — against the
cold fit's L* with the stopping rule's own band semantics, exactly as
bench.bench_converged_fit measures them (the sweep calls that function).
One process, one host->device transfer of the seeded problem.

Run on the GPU: ``python benchmarks/headline_sweep.py [config_index ...]``
(no args = all configs). Prints one JSON line per config.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: (warm_opt, warm_ladder, polish_lr) — lr "" means the cold-fit default
CONFIGS = [
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "4096",
     "GPRAS_BENCH_POLISH_LR": ""},          # 0: 4096 adam rung (baseline)
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "4096",
     "GPRAS_BENCH_POLISH_LR": ""},          # rung change only
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "4096",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # rung + hot polish
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # smaller rung
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "4096",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # polish change only
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "4096",
     "GPRAS_BENCH_POLISH_LR": "0.05"},      # mid polish rate
    # the neighborhood of config 3
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": ""},          # 6: rung-size effect alone
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # 7: adam small rung + hot polish
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.05"},      # 8: small rung, mid polish
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "3072",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # 9: mid rung size
    {"GPRAS_BENCH_WARM_OPT": "lbfgs", "GPRAS_BENCH_WARM_LADDER": "1024",
     "GPRAS_BENCH_POLISH_LR": "0.08"},      # 10: below the 2048 floor?
    # refinements around adam-2048 + polish 0.08.
    # NOTE each config lists EVERY knob it or any sibling sets ("" = pop to
    # default) — the harness mutates os.environ between configs.
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.12", "GPRAS_BENCH_WARM_LR": "",
     "GPRAS_BENCH_WARM_ITERS": ""},         # 11: hotter polish
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "1024",
     "GPRAS_BENCH_POLISH_LR": "0.08", "GPRAS_BENCH_WARM_LR": "",
     "GPRAS_BENCH_WARM_ITERS": ""},         # 12: smaller adam rung
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.08", "GPRAS_BENCH_WARM_LR": "0.05",
     "GPRAS_BENCH_WARM_ITERS": "500"},      # 13: hot short rung
    {"GPRAS_BENCH_WARM_OPT": "adam", "GPRAS_BENCH_WARM_LADDER": "2048",
     "GPRAS_BENCH_POLISH_LR": "0.08", "GPRAS_BENCH_WARM_LR": "",
     "GPRAS_BENCH_WARM_ITERS": "1500"},     # 14: longer rung, fewer polish?
]


def main() -> None:
    import jax.numpy as jnp

    import bench

    n = int(os.environ.get("GPRAS_SWEEP_N", "49152"))
    picks = [int(a) for a in sys.argv[1:]] or range(len(CONFIGS))
    t0 = time.perf_counter()
    x, y = bench._make_data(n, 8, jnp.float32, "hard")
    float(x[0, 0])  # sync: the one transfer
    print(f"# data ready in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    for i in picks:
        cfg = CONFIGS[i]
        for k, v in cfg.items():
            if v:
                os.environ[k] = v
            else:
                os.environ.pop(k, None)
        t0 = time.perf_counter()
        try:
            out = bench.bench_converged_fit(n, dgp="hard", data=(x, y))
        except Exception as e:
            out = {"error": str(e)[:300]}
        out["config_index"] = i
        out["config"] = {k: v for k, v in cfg.items() if v}
        out["call_seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

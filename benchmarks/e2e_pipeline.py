"""End-to-end pipeline timing on a synthetic HEC-RAS project.

Builds a synthetic HF/LF project pair (tests/fixtures.py), runs the full
production path (extract -> EOF -> GP fit -> batched posterior -> reverse
transform -> metrics), and prints the phase timers twice (cold artifacts,
then warm cache replay).

Run on the default device or force CPU:
    python benchmarks/e2e_pipeline.py [--cpu]

Knobs: GPRAS_E2E_NX (HF mesh side, default 16), GPRAS_E2E_EVENTS
(default 6), GPRAS_EOF_HOST_ELEMENTS=0 to force the EOF stage's device
path (measures the dispatch overhead the host crossover removes).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def main() -> None:
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        # persistent compile cache (same as bench.py)
        from gpras_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    import numpy as np

    import fixtures as fx
    from gpras_tpu.pipeline.config import Config
    from gpras_tpu.pipeline.pipeline import pipeline

    nx = int(os.environ.get("GPRAS_E2E_NX", "16"))
    n_events = int(os.environ.get("GPRAS_E2E_EVENTS", "6"))
    plans = [f"e{i + 1}" for i in range(n_events)]
    train = plans[:-1]
    test = plans[-1:]

    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        hf = fx.make_project(root / "hf", "hfm", nx=nx, ny=nx, cell=1.0,
                             plans=plans)
        lf = fx.make_project(root / "lf", "lfm", nx=nx // 2, ny=nx // 2,
                             cell=2.0, plans=plans)
        aoi = root / "aoi.geojson"
        fx.write_aoi(aoi, 0.2, 0.2, nx - 0.2, nx - 0.2)
        event_plans = root / "event_plans.json"
        fx.write_event_plans(event_plans, train=train, test=test)

        config = Config(
            working_directory=str(root / "work"),
            hf_ras_stac_path=str(hf["stac"]),
            area_of_interest_path=str(aoi),
            event_plan_path=str(event_plans),
            mesh_id=fx.MESH_ID,
            hydraulic_parameter="wse",
            wet_threshold_depth=0.05,
            spatial_mode_count=3,
            kernel="RBF",
            inducing_pt_count=12,
            optimizer="adam",
            induction_pt_initializer="kmeans",
            optimizer_kwargs={"max_iter": 60},
            generate_plots=False,
            save_dbs=True,
            lf_model_type="ras_upskill",
            lf_ras_stac_path=str(lf["stac"]),
            dtype="float32",
        )
        out = {}
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            summary = pipeline(config)
            total = time.perf_counter() - t0
            timers = json.loads(
                (root / "work" / "model" / "timers.json").read_text())
            out[label] = {"total_seconds": round(total, 2),
                          **{k: round(v, 2) for k, v in timers.items()}}
            out[label]["depth_rmse"] = round(float(summary["depth_rmse"]), 4)
        assert np.isfinite(out["warm"]["depth_rmse"])
        print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Production serving from checkpoint artifacts: load once, predict forever.

Demonstrates the deployment path (gpras_tpu.gp.serving.PosteriorPredictor):
a trained surrogate + its two EOF preprocessors are saved as pickle-free
artifacts, then a fresh predictor loads them, precomputes posterior factors,
compiles its shape buckets up front, and serves low-fidelity fields ->
(high-fidelity field, variance) with no recompiles regardless of request
batch size. The reference has no serving layer (its predict path is the
batch pipeline, gpras/gpr.py:322-342); this is greenfield on top of parity
artifacts.

Run: ``python examples/serving.py`` (CPU or GPU; small sizes, seconds).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))  # repo root, when not pip-installed
sys.path.insert(0, _HERE)  # sibling examples

from quickstart import make_synthetic_flood  # noqa: E402 (sibling example)


def train_and_save(workdir: str, n_events: int = 96, n_cells: int = 1500,
                   n_modes: int = 4, n_inducing: int = 32,
                   max_iter: int = 150) -> tuple[str, str, str]:
    """Fit the quickstart surrogate and save the three serving artifacts."""
    from gpras_tpu import GPRAS, PreProcessor

    hf, lf, elev = make_synthetic_flood(n_events, n_cells)
    hf_pre = PreProcessor(hydraulic_parameter="depth", wet_threshold=0.03,
                          spatial_mode_count=n_modes)
    hf_pre.fit(hf, elev)
    lf_pre = PreProcessor(hydraulic_parameter="depth", wet_threshold=0.03,
                          spatial_mode_count=n_modes)
    lf_pre.fit(lf, elev)

    model = GPRAS("Matern32", model_type="sgpr")
    model.fit(lf_pre.transform(lf), hf_pre.transform(hf),
              n_inducing=n_inducing, optimization_method="adam",
              max_iter=max_iter)

    model_path = os.path.join(workdir, "model.npz")
    hf_path = os.path.join(workdir, "hf_pre.npz")
    lf_path = os.path.join(workdir, "lf_pre.npz")
    model.to_file(model_path)
    hf_pre.to_file(hf_path)
    lf_pre.to_file(lf_path)
    return model_path, hf_path, lf_path


def main(workdir: str | None = None, verbose: bool = True,
         n_events: int = 96, n_cells: int = 1500, n_modes: int = 4,
         n_inducing: int = 32, max_iter: int = 150):
    import tempfile

    from gpras_tpu.gp.serving import PosteriorPredictor

    owned = workdir is None
    if owned:
        tmp = tempfile.TemporaryDirectory()
        workdir = tmp.name
    try:
        model_path, hf_path, lf_path = train_and_save(
            workdir, n_events, n_cells, n_modes, n_inducing, max_iter)

        # ---- service start: load artifacts once, compile buckets up front
        server = PosteriorPredictor(model_path,
                                    hf_preprocessor_path=hf_path,
                                    lf_preprocessor_path=lf_path,
                                    buckets=(8, 32, 128))
        server.warmup()

        # ---- steady state: varying batch sizes, zero recompiles (each size
        # pads to a bucket already compiled by warmup)
        _, lf_fields, _ = make_synthetic_flood(n_events, n_cells, seed=7)
        lat = {}
        for s in (1, 5, 17, 32):
            batch = lf_fields[:s]
            server.predict_field(batch)  # bucket-pad -> already compiled
            t0 = time.perf_counter()
            field, field_var = server.predict_field(batch)
            lat[s] = time.perf_counter() - t0
            assert field.shape == (s, n_cells)
            assert np.all(np.isfinite(field)) and np.all(field_var >= 0.0)

        if verbose:
            for s, dt in lat.items():
                print(f"batch {s:3d} events -> full {n_cells}-cell field + "
                      f"variance in {dt * 1e3:7.1f} ms "
                      f"({s / dt:,.0f} events/s)")
        return lat
    finally:
        if owned:
            tmp.cleanup()


if __name__ == "__main__":
    main()

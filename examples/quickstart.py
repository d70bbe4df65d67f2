"""End-to-end quickstart on synthetic data: EOF reduction -> multi-mode GP
surrogate -> full-field prediction with uncertainty -> checkpoint round-trip.

Mirrors the library workflow of the reference (gpras/gpr.py + preprocess.py)
on a synthetic 1-D valley whose flood response is genuinely low-rank, so the
EOF truncation and the GP fit both have something real to find.

Run: ``python examples/quickstart.py`` (CPU or GPU; small sizes, seconds).
"""

from __future__ import annotations

import numpy as np


def make_synthetic_flood(n_events: int = 96, n_cells: int = 1500,
                         seed: int = 0):
    """(hf_wse, lf_wse, elevations): a valley transect with smooth storage-
    and slope-mode responses, plus a degraded low-fidelity copy."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, n_cells)
    elevations = 2.0 * (s - 0.5) ** 2 * 10.0  # parabolic valley, 0..5 m

    # two physical response modes: storage (uniform pool) + tilt (slope)
    pool = rng.gamma(4.0, 0.5, size=n_events)  # pool stage per event
    tilt = rng.normal(0.0, 0.4, size=n_events)
    stage = pool[:, None] + tilt[:, None] * (s - 0.5)[None, :]
    hf_wse = np.maximum(elevations[None, :], stage)  # dry cells at terrain

    # low fidelity: smoothed + biased stage, same terrain
    k = np.ones(25) / 25.0
    stage_lf = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"),
                                   1, stage) + 0.05
    lf_wse = np.maximum(elevations[None, :], stage_lf)
    return (hf_wse.astype(np.float32), lf_wse.astype(np.float32),
            elevations.astype(np.float32))


def main(n_events: int = 96, n_cells: int = 1500, n_modes: int = 4,
         n_inducing: int = 32, max_iter: int = 150,
         checkpoint: str | None = None, verbose: bool = True):
    from gpras_tpu import GPRAS, PreProcessor

    hf, lf, elev = make_synthetic_flood(n_events, n_cells)
    n_train = (3 * n_events) // 4
    tr, te = slice(0, n_train), slice(n_train, n_events)

    # 1. EOF reduction: one preprocessor per fidelity space
    hf_pre = PreProcessor(hydraulic_parameter="depth", wet_threshold=0.03,
                          spatial_mode_count=n_modes)
    hf_pre.fit(hf[tr], elev)
    lf_pre = PreProcessor(hydraulic_parameter="depth", wet_threshold=0.03,
                          spatial_mode_count=n_modes)
    lf_pre.fit(lf[tr], elev)

    y_tr = hf_pre.transform(hf[tr])  # (events, modes) targets
    x_tr = lf_pre.transform(lf[tr])  # (events, modes) features
    x_te = lf_pre.transform(lf[te])

    # 2. multi-mode GP surrogate (all modes fitted/vmapped in one program)
    model = GPRAS("Matern32", model_type="sgpr")
    model.fit(x_tr, y_tr, n_inducing=n_inducing,
              optimization_method="adam", max_iter=max_iter)

    # 3. predict held-out events and decode to full cell fields + variance
    mean, var = model.predict(x_te)
    field, field_var = hf_pre.reverse_transform(mean, var)

    truth_depth = np.maximum(hf[te] - elev[None, :], 0.0)
    wet = truth_depth > 0.03
    rmse = float(np.sqrt(np.mean((field[wet] - truth_depth[wet]) ** 2)))
    sigma = np.sqrt(np.maximum(field_var, 0.0))
    cover = float(np.mean(np.abs(field[wet] - truth_depth[wet])
                          <= 2.0 * sigma[wet]))

    # 4. checkpoint round-trip (npz + JSON manifest, no pickle)
    if checkpoint is not None:
        model.to_file(checkpoint)
        reloaded = GPRAS.from_file(checkpoint)
        m2, _ = reloaded.predict(x_te)
        assert np.allclose(m2, mean, atol=1e-6)

    if verbose:
        print(f"events train/test: {n_train}/{n_events - n_train}, "
              f"cells: {n_cells}, EOF modes: {y_tr.shape[1]}")
        print(f"held-out wet-cell depth RMSE: {rmse:.3f} m "
              f"(field std {float(np.std(truth_depth[wet])):.3f} m)")
        print(f"2-sigma coverage: {cover:.3f}")
    return rmse, cover


if __name__ == "__main__":
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))  # repo root, when not pip-installed
    with tempfile.TemporaryDirectory() as d:
        main(checkpoint=f"{d}/gpr.npz")

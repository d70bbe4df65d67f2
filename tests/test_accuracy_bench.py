"""Accuracy north-star machinery (gpras_tpu/accuracy.py): the f32 pipeline
path and the f64 dense gold path agree on a tiny synthetic upskilling problem
and produce calibrated posteriors."""

import numpy as np

from gpras_tpu import accuracy

TINY = {
    "n_events": 8,
    "n_train_events": 6,
    "t_steps": 16,
    "n_cells_hf": 256,
    "n_cells_lf": 64,
    "n_inducing": 16,
    "max_iter": 80,
}


def test_problem_is_deterministic():
    a = accuracy.make_problem(TINY)
    b = accuracy.make_problem(TINY)
    np.testing.assert_array_equal(a["hf_train"], b["hf_train"])
    np.testing.assert_array_equal(a["lf_test"], b["lf_test"])
    assert a["hf_train"].shape == (96, 256)
    assert a["hf_test"].shape == (32, 256)
    assert np.all(a["hf_train"] >= 0)  # depths


def test_paths_agree_and_calibrate():
    f32 = accuracy.run_path("f32", TINY)
    f64 = accuracy.run_path("f64", TINY)
    s = accuracy.summarize(f32, f64)
    assert set(s) == {
        "depth_rmse_f32", "depth_rmse_f64_gold", "depth_rmse_vs_f64",
        "depth_rmse_ratio_f32_over_f64", "coverage_2sigma_f32",
        "coverage_2sigma_f64",
    }
    # both surrogates actually learned the map: RMSE well under the field's
    # own scale
    scale = float(np.std(f32["truth"]))
    assert s["depth_rmse_f32"] < 0.5 * scale
    assert s["depth_rmse_f64_gold"] < 0.5 * scale
    # numerics gap between the two paths is small relative to the
    # irreducible error itself (SGPR-m16-f32 vs dense-f64 on 6 modes)
    assert s["depth_rmse_vs_f64"] < max(s["depth_rmse_f64_gold"], 1e-6)
    assert 0.5 < s["depth_rmse_ratio_f32_over_f64"] < 2.0
    assert 0.5 < s["coverage_2sigma_f32"] <= 1.0
    assert 0.5 < s["coverage_2sigma_f64"] <= 1.0


def test_exact_engine_accuracy_paths_small(tmp_path):
    """The exact-engine north star (accuracy.run_exact_path) end-to-end at
    toy size: f32 production fit -> f64 dense gold with matched
    hyperparameters -> summary; the numerics gap must be far below the
    statistical error, and coverage sane."""
    from gpras_tpu import accuracy

    cfg = {"n_train": 512, "n_test": 128, "max_iter": 150,
           "warm_start_subsample": 0}
    accuracy.run_exact_path("f32", str(tmp_path), cfg)
    accuracy.run_exact_path("f64", str(tmp_path), cfg)
    f32 = dict(np.load(tmp_path / "exact_f32.npz"))
    f64 = dict(np.load(tmp_path / "exact_f64.npz"))
    s = accuracy.summarize_exact(f32, f64, cfg)
    assert s["exact_rmse_f64_gold"] < 0.5
    # numerics gap well under the truth-error; ratio ~1
    assert s["exact_rmse_vs_f64"] < 0.25 * s["exact_rmse_f64_gold"]
    assert 0.8 < s["exact_rmse_ratio_f32_over_f64"] < 1.25
    assert s["exact_coverage_2sigma_f32"] > 0.85

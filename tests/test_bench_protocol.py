"""Headline-bench protocol machinery (bench.py bench_converged_fit).

The bench is the driver's artifact, so its protocol logic — the stopping
band, the warm-start transfer clamp, and the certify-then-polish flow —
is guarded here on tiny CPU problems (the numbers themselves are measured
on the GPU; these tests pin the FLOW)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.fixture()
def tiny_env(monkeypatch):
    monkeypatch.setenv("GPRAS_BENCH_COLD", "1")
    monkeypatch.setenv("GPRAS_BENCH_MAX_STEPS", "40")
    monkeypatch.setenv("GPRAS_BENCH_WARM_LADDER", "64")
    return monkeypatch


def test_easy_dgp_certifies_with_stop_band(tiny_env):
    res = bench.bench_converged_fit(512, dgp="easy")
    # stop band is the rule's own resolution: patience * tol * |L*|
    # (both fields are rounded for the JSON artifact: band to 3 decimals,
    # L* to 2 — compare at that resolution)
    assert res["stop_band_nats"] == pytest.approx(
        50 * 1e-5 * abs(res["converged_loss"]), abs=2e-3)
    assert res["band_certified_by"] in ("forward_nlml_eval", "polish_steps")
    assert res["fit_to_convergence_seconds"] > 0
    assert res["target_loss_source"] == "in_run_cold_fit"


def test_transfer_clamp_handicap_forces_polish(tiny_env):
    """With the variance clamped to <= 1x noise the warm start is pushed far
    outside the band, so the flow must take the polish branch (or report the
    honest infeasible fallback) instead of certifying in one eval. The cap
    is absurdly small (var <= 1e-3 x noise: a near-pure-noise model) so the
    clamped start is worse than even the tiny cold fit's 40-step L*."""
    tiny_env.setenv("GPRAS_BENCH_WARM_RATIO_CAP", "1e-3")
    res = bench.bench_converged_fit(512, dgp="easy")
    assert res["band_certified_by"] in ("polish_steps",
                                        "warm_start_infeasible")
    if res["band_certified_by"] == "polish_steps" \
            and res.get("fit_to_convergence_polish_steps", -1) > 0:
        # the failed certification + polish steps are inside the clock
        assert res["fit_to_convergence_seconds"] > res["warmstart_seconds"]


def test_transfer_clamp_is_inactive_at_huge_cap(tiny_env):
    """A huge ratio cap reproduces the unclamped protocol bit-for-bit on a
    problem whose rung never exceeds it (the clamp is min(), not a shift)."""
    tiny_env.setenv("GPRAS_BENCH_WARM_RATIO_CAP", "1e9")
    res_uncapped = bench.bench_converged_fit(512, dgp="hard")
    tiny_env.setenv("GPRAS_BENCH_WARM_RATIO_CAP", "50")
    res_default = bench.bench_converged_fit(512, dgp="hard")
    # deterministic seeded problem: identical losses unless the clamp bit
    assert res_uncapped["converged_loss"] == res_default["converged_loss"]
    assert (res_uncapped["warmstarted_final_loss"]
            == pytest.approx(res_default["warmstarted_final_loss"]))


def test_hard_dgp_multiscale_structure():
    """The hard DGP's three active components and nuisance dims are what the
    headline's difficulty claim rests on — pin the generator."""
    x, y = bench._make_data(4096, 8, np.float32, "hard")
    x, y = np.asarray(x), np.asarray(y)
    resid = y - (np.sin(x[:, 0]) + 0.5 * np.sin(2 * x[:, 1])
                 + 0.4 * np.sin(4 * x[:, 2]))
    assert np.std(resid) == pytest.approx(0.1, rel=0.05)  # sigma = 0.1
    # nuisance dims carry no signal: correlation at noise level
    for j in range(3, 8):
        assert abs(np.corrcoef(x[:, j], y)[0, 1]) < 0.05


def test_lbfgs_rung_and_polish_lr_knobs(tiny_env):
    """GPRAS_BENCH_WARM_OPT=lbfgs swaps the rung optimizer for the jitted
    zoom-linesearch L-BFGS (noise floored inside the loss) and
    GPRAS_BENCH_POLISH_LR gives the polish stage its own Adam rate; both
    must drive the standard certify-then-polish flow to a finite result."""
    tiny_env.setenv("GPRAS_BENCH_WARM_OPT", "lbfgs")
    tiny_env.setenv("GPRAS_BENCH_POLISH_LR", "0.05")
    res = bench.bench_converged_fit(512, dgp="hard")
    assert res["band_certified_by"] in ("forward_nlml_eval", "polish_steps",
                                        "warm_start_infeasible")
    assert np.isfinite(res["warmstarted_final_loss"])
    assert res["warmstart_seconds"] > 0


def test_round5_warm_defaults_and_instrumentation(tiny_env):
    """The hard-DGP warm defaults (adam rung lr 0.05 capped at 500
    iterations — the benchmarks/headline_sweep.py winner) are
    observable through the instrumentation fields, and the rung honors the
    iteration cap."""
    tiny_env.setenv("GPRAS_BENCH_WARM_ITERS", "7")
    res = bench.bench_converged_fit(512, dgp="hard")
    assert res["warm_rung_iterations"] == [7]  # cap honored + field emitted
    assert res["certification_seconds"] >= 0
    # easy-DGP continuity: rung still runs under the reference rule's cap
    tiny_env.delenv("GPRAS_BENCH_WARM_ITERS")
    res_e = bench.bench_converged_fit(512, dgp="easy")
    assert res_e["warm_rung_iterations"][0] <= 1000

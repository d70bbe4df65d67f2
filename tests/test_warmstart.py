"""Warm-start transfer protocol (gp/warmstart.py).

The bench's measured 49k warm-start robustness — conditioning-envelope
clamp + certify-then-polish — must be reachable through the public
``GPRAS.fit(warm_start_subsample=...)`` API, not only bench.py's private
protocol copy.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest

from gpras_tpu.gp import exact, warmstart
from gpras_tpu.gp.model import GPRAS


def _ratio(p):
    return float(np.exp(np.asarray(p["log_variance"])
                        - np.asarray(p["log_noise_variance"])))


def test_transfer_clamp_caps_ratio_and_leaves_rest():
    p = {
        "log_variance": jnp.asarray(math.log(1000.0), jnp.float32),
        "log_noise_variance": jnp.asarray(math.log(1.0), jnp.float32),
        "log_lengthscales": jnp.ones(4, jnp.float32) * 2.5,
    }
    out = warmstart.transfer_clamp(p, ratio_cap=50.0)
    assert _ratio(out) == pytest.approx(50.0, rel=1e-5)
    np.testing.assert_array_equal(np.asarray(out["log_lengthscales"]),
                                  np.asarray(p["log_lengthscales"]))
    np.testing.assert_array_equal(np.asarray(out["log_noise_variance"]),
                                  np.asarray(p["log_noise_variance"]))
    # already inside the envelope: a no-op
    p_ok = dict(p, log_variance=jnp.asarray(math.log(10.0), jnp.float32))
    out_ok = warmstart.transfer_clamp(p_ok, ratio_cap=50.0)
    assert _ratio(out_ok) == pytest.approx(10.0, rel=1e-5)


def test_transfer_clamp_batched_modes():
    p = {
        "log_variance": jnp.asarray([math.log(1000.0), math.log(5.0)],
                                    jnp.float32),
        "log_noise_variance": jnp.zeros(2, jnp.float32),
    }
    out = warmstart.transfer_clamp(p, ratio_cap=50.0)
    ratios = np.exp(np.asarray(out["log_variance"]))
    assert ratios[0] == pytest.approx(50.0, rel=1e-5)
    assert ratios[1] == pytest.approx(5.0, rel=1e-5)


def test_certify_transfer_halves_cap_until_feasible():
    """A deliberately ridge-inflated rung (var/noise = 1e6) against a loss
    whose feasibility wall sits at ratio 10: the cert must halve 50 -> 25
    -> 12.5 -> 6.25 and certify there."""
    p = {
        "log_variance": jnp.asarray(math.log(1e6), jnp.float32),
        "log_noise_variance": jnp.asarray(0.0, jnp.float32),
    }

    def loss(pp):
        r = float(np.exp(np.asarray(pp["log_variance"])))
        return float("nan") if r > 10.0 else r

    out, info = warmstart.certify_transfer(loss, p, ratio_cap=50.0)
    assert info["feasible"]
    assert info["ratio_cap_used"] == pytest.approx(6.25)
    assert _ratio(out) == pytest.approx(6.25, rel=1e-5)
    assert np.isfinite(info["cert_loss"])


def test_certify_transfer_reports_infeasible():
    p = {
        "log_variance": jnp.asarray(math.log(1e6), jnp.float32),
        "log_noise_variance": jnp.asarray(0.0, jnp.float32),
    }
    out, info = warmstart.certify_transfer(
        lambda pp: float("nan"), p, ratio_cap=50.0, min_cap=2.0)
    assert not info["feasible"]
    assert not np.isfinite(info["cert_loss"])
    # the returned params are still clamped to the tightest cap tried
    assert _ratio(out) <= 2.0 * (1 + 1e-5)


def test_certify_transfer_real_loss_envelope():
    """Against the REAL dense exact-GP loss: an inflated rung transfer is
    clamped back inside the envelope and certifies finite."""
    rng = np.random.default_rng(0)
    n, d = 256, 3
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    p = exact.init_params("Matern52", x, noise_variance=0.1)
    p = dict(p, log_variance=p["log_variance"] + 20.0)  # ridge-inflated

    def loss(pp):
        return exact.training_loss("Matern52", pp, x, y)

    out, info = warmstart.certify_transfer(loss, p, ratio_cap=50.0)
    assert info["feasible"]
    assert _ratio(out) <= info["ratio_cap_used"] * (1 + 1e-5)
    assert np.isfinite(info["cert_loss"])


def test_certify_transfer_batched_fallback():
    """Mode 0 feasible, mode 1 infeasible at any cap -> mode 1 falls back
    to the provided standard init."""
    p = {
        "log_variance": jnp.asarray([math.log(1e4), math.log(1e4)],
                                    jnp.float32),
        "log_noise_variance": jnp.zeros(2, jnp.float32),
    }
    fallback = {
        "log_variance": jnp.asarray([0.5, 0.7], jnp.float32),
        "log_noise_variance": jnp.asarray([-1.0, -1.2], jnp.float32),
    }

    def loss(pp, i):
        if i == 1:
            return float("nan")
        r = float(np.exp(np.asarray(pp["log_variance"])))
        return r if r <= 30.0 else float("nan")

    out, info = warmstart.certify_transfer_batched(loss, p, fallback,
                                                   ratio_cap=50.0)
    assert info["fell_back_modes"] == [1]
    assert float(out["log_variance"][1]) == pytest.approx(0.7)
    assert float(out["log_noise_variance"][1]) == pytest.approx(-1.2)
    # mode 0 certified at 25 (50 -> NaN at >30? no: 50 > 30 -> halve -> 25)
    assert info["ratio_caps"][0] == pytest.approx(25.0)
    assert float(np.exp(out["log_variance"][0])) == pytest.approx(25.0,
                                                                  rel=1e-5)


def test_gpras_fit_warm_start_routes_through_protocol():
    """End-to-end: GPRAS.fit(warm_start_subsample=...) on an f32 exact model
    records the protocol info and produces a finite fitted model; the
    ``warm_ratio_cap`` knob reaches the clamp."""
    rng = np.random.default_rng(1)
    n, d = 600, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1).astype(
        np.float32) + 0.05 * rng.normal(size=(n, 2)).astype(np.float32)
    m = GPRAS("Matern52", model_type="exact", dtype=jnp.float32)
    m.fit(x, y, optimization_method="adam", max_iter=10,
          warm_start_subsample=128, warm_ratio_cap=25.0)
    assert m.warm_start_info is not None
    assert len(m.warm_start_info["ratio_caps"]) == 2
    assert all(c <= 25.0 for c in m.warm_start_info["ratio_caps"])
    assert m.warm_start_info["fell_back_modes"] == []
    for v in m.params.values():
        assert np.all(np.isfinite(np.asarray(v)))
    mean, var = m.predict(x[:32])
    assert np.all(np.isfinite(mean)) and np.all(var > 0)

"""gp.coldfit.fit_exact: the packaged cold-fit protocol (engine auto-select,
deterministic trajectory, stopping semantics) on tiny CPU problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpras_tpu.gp import coldfit, exact


def make_problem(n=384, d=3, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k1, (n, d), dtype=jnp.float32)
    y = jnp.sin(x[:, 0]) + 0.05 * jax.random.normal(k2, (n,),
                                                    dtype=jnp.float32)
    return x, y


def test_fit_exact_hutchinson_improves_and_contract():
    x, y = make_problem()
    p, info = coldfit.fit_exact("Matern52", x, y, max_iter=12, chunk=4)
    assert info["engine"] == "hutchinson"  # auto below the CG threshold
    assert info["stopped_by"] in ("max_iter", "plateau_rule")
    p0 = exact.init_params("Matern52", x, noise_variance=0.1)
    assert float(info["loss"]) < float(
        exact.training_loss("Matern52", p0, x, y))
    # the noise floor binds from below
    assert float(p["log_noise_variance"]) >= float(np.log(1e-4)) - 1e-5


def test_fit_exact_deterministic_trajectory():
    x, y = make_problem()
    _, a = coldfit.fit_exact("Matern52", x, y, max_iter=8, chunk=4)
    _, b = coldfit.fit_exact("Matern52", x, y, max_iter=8, chunk=4)
    np.testing.assert_array_equal(np.asarray(a["losses"]),
                                  np.asarray(b["losses"]))


def test_fit_exact_cg_engine_forced():
    x, y = make_problem(n=256)
    p, info = coldfit.fit_exact("Matern52", x, y, engine="cg", max_iter=6,
                                chunk=2, probes=16, cg_iters=16,
                                host_linesearch=False)
    assert info["engine"] == "cg"
    losses = np.asarray(info["losses"])
    finite = losses[np.isfinite(losses)]
    assert finite.size and finite.min() < finite[0]


def test_fit_exact_band_stop():
    x, y = make_problem()
    _, full = coldfit.fit_exact("Matern52", x, y, max_iter=16, chunk=4)
    target = float(np.nanmin(np.asarray(full["losses"])[:8]))
    _, banded = coldfit.fit_exact("Matern52", x, y, max_iter=16, chunk=4,
                                  stop_loss=target)
    assert banded["stopped_by"] == "stop_loss_band"
    assert int(banded["iterations"]) <= 12


def test_fit_exact_host_linesearch_path():
    """The giant-N shape (host strong-Wolfe linesearch over segmented CG
    value+grad dispatches) runs end-to-end and descends."""
    x, y = make_problem(n=256)
    p, info = coldfit.fit_exact("Matern52", x, y, engine="cg",
                                host_linesearch=True, max_iter=6,
                                probes=16, cg_iters=16, seg_iters=4)
    assert info["engine"] == "cg_hostls"
    assert info["evals"] >= int(info["iterations"]) + 1
    losses = np.asarray(info["losses"])
    finite = losses[np.isfinite(losses)]
    assert finite.size and finite.min() < finite[0]


def test_fit_exact_stop_decrease_truncates_identically():
    """The noise-plateau stop (stop_decrease) ends the CG host-linesearch
    fit earlier with a trajectory identical to the unstopped run — the
    protocol property the fit relies on at large N (same terminus,
    fewer evaluations)."""
    x, y = make_problem(n=256)
    kw = dict(engine="cg", host_linesearch=True, max_iter=10, probes=16,
              cg_iters=16, seg_iters=4)
    _, full = coldfit.fit_exact("Matern52", x, y, **kw)
    losses = np.asarray(full["losses"])
    fin = losses[np.isfinite(losses)]
    earns = fin[:-1] - fin[1:]
    assert earns.size >= 2
    thresh = float(earns[earns.size // 2]) + 1e-9
    expect = int(np.argmax(np.concatenate([[np.inf], earns]) < thresh)) + 1

    _, stopped = coldfit.fit_exact("Matern52", x, y, stop_decrease=thresh,
                                   **kw)
    assert stopped["stopped_by"] == "noise_plateau"
    assert int(stopped["iterations"]) == expect
    np.testing.assert_array_equal(np.asarray(stopped["losses"])[:expect],
                                  losses[:expect])


def test_fit_exact_host_linesearch_needs_cg():
    x, y = make_problem(n=128)
    with pytest.raises(ValueError, match="host_linesearch"):
        coldfit.fit_exact("Matern52", x, y, engine="hutchinson",
                          host_linesearch=True)


def test_fit_exact_rejects_unknown_engine():
    x, y = make_problem(n=128)
    with pytest.raises(ValueError, match="unknown engine"):
        coldfit.fit_exact("Matern52", x, y, engine="dense")

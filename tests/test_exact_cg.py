"""Matrix-free BBMM engine: CG solves, SLQ logdet, and gradient consistency."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpras_tpu.gp import exact
from gpras_tpu.gp.exact_cg import kmv, kmv_cross, make_cg_nlml, mbcg
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg


def make_data(n=96, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, d)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n))
    return x, y


def test_kmv_matches_dense():
    x, _ = make_data()
    params = exact.init_params("Matern52", x, noise_variance=0.3)
    v = jnp.asarray(np.random.default_rng(1).normal(size=(96, 5)))
    noise = jnp.exp(params["log_noise_variance"])
    got = np.asarray(kmv("Matern52", params, x, v, noise, row_panel=32))
    kd = np.asarray(K.gram("Matern52", params, x)) + float(noise) * np.eye(96)
    np.testing.assert_allclose(got, kd @ np.asarray(v), rtol=1e-10)


@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
@pytest.mark.parametrize("cross", [False, True])
def test_plain_kmv_matches_dense_product(kernel, cross):
    """The panel-loop matvec (the CPU path, and wide right-hand sides on
    a GPU) against the float64 dense product, at 100 rows: no panel of 32
    divides that, so the panel shrinks to 25. In float64 because the
    r-singular kernels (Matern12, Exponential) turn last-bit differences in
    a coincident pair's squared distance into sqrt-sized ones."""
    rng = np.random.default_rng(6)
    x1 = jnp.asarray(rng.normal(size=(100, 4)))
    x2 = jnp.asarray(rng.normal(size=(37, 4))) if cross else x1
    v = jnp.asarray(rng.normal(size=(x2.shape[0], 3)))
    params = exact.init_params(kernel, x1, noise_variance=0.2)
    if cross:
        got = kmv_cross(kernel, params, x1, x2, v, row_panel=32)
        noise = 0.0
    else:
        noise = float(jnp.exp(params["log_noise_variance"]))
        got = kmv(kernel, params, x1, v, noise, row_panel=32)
    kd = np.asarray(K.gram(kernel, params, x1, x2)) \
        + noise * np.eye(100, x2.shape[0])
    want = kd @ np.asarray(v)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=1e-7 * np.max(np.abs(want)))


@pytest.mark.parametrize("kernel", ["RBF", "Matern12", "Matern52"])
def test_plain_cotangent_grads_match_autodiff(kernel):
    """The Gram-vjp panel loop with the noise/jitter diagonal term == the
    autodiff vjp of the noisy Gram against the same rank-(m+1) cotangent,
    at 90 rows (a column panel of 32 shrinks to 30)."""
    from gpras_tpu.gp.exact_cg import _cotangent_grads

    rng = np.random.default_rng(8)
    n, m, g = 90, 4, 1.3
    x = jnp.asarray(rng.normal(size=(n, 3)))
    params = exact.init_params(kernel, x, noise_variance=0.1)
    w, v = (jnp.asarray(rng.normal(size=(n, m))) for _ in range(2))
    alpha = jnp.asarray(rng.normal(size=n))
    got = _cotangent_grads(kernel, params, x, alpha, w, v, g, 1.0 / m, 32)

    def noisy_gram(p):
        diag = jnp.exp(p["log_noise_variance"]) + linalg.default_jitter(
            x.dtype) * jnp.exp(p["log_variance"])
        return K.gram(kernel, p, x) + diag * jnp.eye(n)

    kbar = 0.5 * g * (w @ v.T / m - jnp.outer(alpha, alpha))
    _, pullback = jax.vjp(noisy_gram, params)
    (want,) = pullback(kbar)
    for k in want:
        # float64 both; the r-singular kernels' floor at r = 0 is met by
        # the panel and whole-Gram distance expansions a rounding apart
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("n,target,want", [
    (4096, 512, 512), (100, 32, 25), (97, 32, 1), (10, 512, 10)])
def test_fit_panel_is_largest_divisor(n, target, want):
    from gpras_tpu.gp.exact_cg import _fit_panel

    assert _fit_panel(n, target) == want


def test_mbcg_solves():
    x, y = make_data(seed=2)
    params = exact.init_params("RBF", x, noise_variance=0.5)
    noise = jnp.exp(params["log_noise_variance"])
    kd = np.asarray(K.gram("RBF", params, x)) + float(noise) * np.eye(96)
    b = jnp.asarray(np.random.default_rng(3).normal(size=(96, 4)))
    mv = lambda v: kmv("RBF", params, x, v, noise, row_panel=32)
    sol, alphas, betas, rz0 = mbcg(mv, b, max_iters=96)
    # CG stops at relative residual 1e-6 -> ~1e-5..1e-4 solution error
    np.testing.assert_allclose(np.asarray(sol), np.linalg.solve(kd, np.asarray(b)),
                               rtol=2e-4, atol=1e-6)


def test_cg_nlml_value_close_to_exact():
    """quad is CG-exact; logdet is SLQ — with generous probes/iters the value
    should match the Cholesky NLML to ~1%."""
    x, y = make_data(seed=4)
    params = exact.init_params("Matern52", x, noise_variance=0.3)
    nlml = make_cg_nlml("Matern52", probes=64, max_iters=96,
                        row_panel=32, col_panel=32)
    got = float(nlml(params, x, y, jax.random.PRNGKey(0)))
    want = float(exact.nlml("Matern52", params, x, y))
    assert abs(got - want) / abs(want) < 0.02, (got, want)


def test_cg_gradient_matches_exact_on_average():
    x, y = make_data(n=64, seed=5)
    params = exact.init_params("RBF", x, noise_variance=0.4)
    nlml = make_cg_nlml("RBF", probes=16, max_iters=64,
                        row_panel=32, col_panel=32)
    g_exact = jax.grad(lambda p: exact.nlml("RBF", p, x, y))(params)
    grad_fn = jax.jit(jax.grad(lambda p, k: nlml(p, x, y, k)))
    keys = jax.random.split(jax.random.PRNGKey(9), 32)
    acc = jax.tree.map(jnp.zeros_like, params)
    for k in keys:
        acc = jax.tree.map(jnp.add, acc, grad_fn(params, k))
    mean_g = jax.tree.map(lambda a: a / len(keys), acc)
    for name in g_exact:
        ge, gm = np.asarray(g_exact[name]), np.asarray(mean_g[name])
        scale = max(np.max(np.abs(ge)), 1.0)
        np.testing.assert_allclose(gm, ge, atol=0.1 * scale, err_msg=name)


def test_cg_y_gradient_is_exact():
    x, y = make_data(n=64, seed=6)
    params = exact.init_params("RBF", x, noise_variance=0.4)
    nlml = make_cg_nlml("RBF", probes=4, max_iters=64,
                        row_panel=32, col_panel=32)
    gy = jax.grad(lambda yy: nlml(params, x, yy, jax.random.PRNGKey(0)))(y)
    gy_exact = jax.grad(lambda yy: exact.nlml("RBF", params, x, yy))(y)
    np.testing.assert_allclose(np.asarray(gy), np.asarray(gy_exact),
                               rtol=1e-4, atol=1e-7)


def test_pivoted_cholesky_low_rank_recovery():
    """On an (almost) rank-k kernel matrix, the rank-k pivoted Cholesky
    reconstructs K to high accuracy."""
    from gpras_tpu.gp.exact_cg import pivoted_cholesky

    rng = np.random.default_rng(8)
    # long lengthscale -> fast spectral decay -> low numerical rank
    x = jnp.asarray(rng.normal(size=(80, 2)))
    params = {"log_variance": jnp.asarray(0.0),
              "log_lengthscales": jnp.asarray([1.5, 1.5])}
    kd = np.asarray(K.gram("RBF", params, x))
    l = np.asarray(pivoted_cholesky("RBF", params, x, 30))
    err = np.max(np.abs(kd - l @ l.T)) / np.max(np.abs(kd))
    assert err < 1e-4, err


def test_preconditioned_cg_nlml_matches_exact():
    """precond_rank > 0: value still matches the Cholesky NLML and the
    stochastic gradient still averages to the exact gradient."""
    x, y = make_data(n=64, seed=11)
    params = exact.init_params("RBF", x, noise_variance=0.05)
    nlml = make_cg_nlml("RBF", probes=32, max_iters=48, row_panel=32,
                        col_panel=32, precond_rank=12)
    keys = jax.random.split(jax.random.PRNGKey(2), 16)
    vals = [float(nlml(params, x, y, k)) for k in keys[:8]]
    want = float(exact.nlml("RBF", params, x, y))
    # logdet is SLQ-stochastic: 8 keys x 32 probes -> ~5% MC tolerance
    assert abs(np.mean(vals) - want) / abs(want) < 0.05, (np.mean(vals), want)

    g_exact = jax.grad(lambda p: exact.nlml("RBF", p, x, y))(params)
    grad_fn = jax.jit(jax.grad(lambda p, k: nlml(p, x, y, k)))
    acc = jax.tree.map(jnp.zeros_like, params)
    for k in keys:
        acc = jax.tree.map(jnp.add, acc, grad_fn(params, k))
    mean_g = jax.tree.map(lambda a: a / len(keys), acc)
    for name in g_exact:
        ge, gm = np.asarray(g_exact[name]), np.asarray(mean_g[name])
        scale = max(np.max(np.abs(ge)), 1.0)
        np.testing.assert_allclose(gm, ge, atol=0.15 * scale, err_msg=name)


def test_preconditioning_accelerates_convergence():
    """With small noise (ill-conditioned K), PCG reaches a given solve
    accuracy in far fewer iterations than plain CG."""
    from gpras_tpu.gp.exact_cg import kmv, make_woodbury_pinv, mbcg, pivoted_cholesky

    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.normal(size=(128, 2)))
    params = {"log_variance": jnp.asarray(0.0),
              "log_lengthscales": jnp.asarray([1.0, 1.0]),
              "log_noise_variance": jnp.asarray(np.log(1e-3))}
    noise = jnp.exp(params["log_noise_variance"])
    kd = np.asarray(K.gram("RBF", params, x)) + float(noise) * np.eye(128)
    b = jnp.asarray(rng.normal(size=(128, 1)))
    want = np.linalg.solve(kd, np.asarray(b))
    mv = lambda v: kmv("RBF", params, x, v, noise, row_panel=32)

    def err(iters, pinv):
        sol, _, _, _ = mbcg(mv, b, max_iters=iters, pinv=pinv)
        return float(np.linalg.norm(np.asarray(sol) - want) / np.linalg.norm(want))

    l_pc = pivoted_cholesky("RBF", params, x, 20)
    pinv, _ = make_woodbury_pinv(l_pc, noise)
    assert err(20, pinv) < 1e-4, err(20, pinv)
    assert err(20, None) > 10 * err(20, pinv)


def test_cg_predict_preconditioned_matches_dense_at_small_noise():
    """Matrix-free posterior with the preconditioner stays accurate where the
    plain-CG variance solves struggle (small fitted noise)."""
    from gpras_tpu.gp.exact_cg import cg_predict
    from gpras_tpu.ops import linalg

    rng = np.random.default_rng(15)
    x = jnp.asarray(rng.normal(size=(96, 2)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]))
    xq = jnp.asarray(rng.normal(size=(32, 2)))
    params = {"log_variance": jnp.asarray(0.0),
              "log_lengthscales": jnp.asarray([0.8, 0.8]),
              "log_noise_variance": jnp.asarray(np.log(1e-3))}
    noise = float(jnp.exp(params["log_noise_variance"])) + \
        float(linalg.default_jitter(x.dtype)) * 1.0
    kd = np.asarray(K.gram("RBF", params, x)) + noise * np.eye(96)
    ks = np.asarray(K.gram("RBF", params, x, xq))
    l = np.linalg.cholesky(kd)
    alpha = np.linalg.solve(kd, np.asarray(y))
    want_mean = ks.T @ alpha
    v = np.linalg.solve(l, ks)
    want_var = 1.0 - np.sum(v * v, axis=0) + float(jnp.exp(params["log_noise_variance"]))

    mean, var = cg_predict("RBF", params, x, y, xq, max_iters=48,
                           row_panel=32, var_chunk=32, precond_rank=24)
    np.testing.assert_allclose(np.asarray(mean), want_mean, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(var), want_var, rtol=1e-3, atol=1e-6)


def test_chunked_step_matches_monolithic():
    """make_cg_step_chunked (host-segmented dispatch for giant N: short
    programs with host early exits) must match the monolithic jitted
    value_and_grad exactly — the segment runner is the same mbcg state
    machine, so only jit-boundary fusion noise is allowed."""
    from gpras_tpu.gp.exact_cg import (make_cg_step_chunked,
                                       make_cg_training_loss)

    n, d = 256, 3
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.2)
    key = jax.random.PRNGKey(7)

    loss_fn = make_cg_training_loss("Matern52", probes=8, max_iters=12,
                                    col_panel=64)
    v_mono, g_mono = jax.value_and_grad(loss_fn)(params, x, y, key)
    step = make_cg_step_chunked("Matern52", probes=8, max_iters=12,
                                seg_iters=3, col_panel=64)
    v_chunk, g_chunk = step(params, x, y, key)
    np.testing.assert_allclose(float(v_chunk), float(v_mono), rtol=1e-5)
    for k in g_mono:
        np.testing.assert_allclose(np.asarray(g_chunk[k]),
                                   np.asarray(g_mono[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_chunked_step_preconditioned_matches_monolithic():
    """precond_rank > 0 mirrors make_cg_nlml's BBMM preconditioned
    estimator (same key splits, N(0, P) probes, Woodbury logdet, P^{-1} z
    trace) through the segmented dispatch."""
    from gpras_tpu.gp.exact_cg import (make_cg_step_chunked,
                                       make_cg_training_loss)

    n, d = 256, 3
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.2)
    key = jax.random.PRNGKey(3)

    loss_fn = make_cg_training_loss("Matern52", probes=8, max_iters=12,
                                    col_panel=64, precond_rank=16)
    v_mono, g_mono = jax.value_and_grad(loss_fn)(params, x, y, key)
    step = make_cg_step_chunked("Matern52", probes=8, max_iters=12,
                                seg_iters=4, col_panel=64, precond_rank=16)
    v_chunk, g_chunk = step(params, x, y, key)
    np.testing.assert_allclose(float(v_chunk), float(v_mono), rtol=1e-5)
    for k in g_mono:
        np.testing.assert_allclose(np.asarray(g_chunk[k]),
                                   np.asarray(g_mono[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_chunked_step_residual_gate():
    """The solver-validity gate: an unconverged solve (2 iterations) returns
    +inf; a converged one (generous iterations + loose gate) stays finite."""
    from gpras_tpu.gp.exact_cg import make_cg_step_chunked

    n, d = 192, 3
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.2)
    key = jax.random.PRNGKey(5)

    tight = make_cg_step_chunked("Matern52", probes=4, max_iters=2,
                                 seg_iters=2, col_panel=64,
                                 residual_gate=1e-6)
    v, _ = tight(params, x, y, key)
    assert np.isposinf(float(v))

    loose = make_cg_step_chunked("Matern52", probes=4, max_iters=64,
                                 seg_iters=8, col_panel=64, precond_rank=16,
                                 residual_gate=0.5)
    v, _ = loose(params, x, y, key)
    assert np.isfinite(float(v))


def test_monolithic_nlml_residual_gate():
    """make_cg_nlml's residual_gate mirrors the chunked step's solver-
    validity gate (gp/coldfit.py threads it through the device-linesearch
    path): an unreachable gate returns +inf, a loose gate the real value."""
    from gpras_tpu.gp.exact_cg import make_cg_training_loss

    n, d = 256, 3
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.2)
    key = jax.random.PRNGKey(11)

    ungated = make_cg_training_loss("Matern52", probes=8, max_iters=12,
                                    col_panel=64)
    v_ref = float(ungated(params, x, y, key))
    assert np.isfinite(v_ref)
    # 2 CG iterations cannot reach a 1e-6 relative residual: gate fires
    tight = make_cg_training_loss("Matern52", probes=8, max_iters=2,
                                  col_panel=64, residual_gate=1e-6)
    assert np.isposinf(float(tight(params, x, y, key)))
    # a loose gate leaves the value untouched (bit-identical estimator)
    loose = make_cg_training_loss("Matern52", probes=8, max_iters=12,
                                  col_panel=64, residual_gate=1e3)
    np.testing.assert_allclose(float(loose(params, x, y, key)), v_ref,
                               rtol=1e-6)
    # the gate rides through jax.grad (custom-VJP forward) unchanged
    v, _ = jax.value_and_grad(tight)(params, x, y, key)
    assert np.isposinf(float(v))


def test_chunked_step_early_exit_bit_identical():
    """Host early exit stops dispatching segments once every mbcg column is
    frozen at ``tol``. A fully-frozen carry is a fixed point of the mbcg
    body on everything finish() reads (alpha/beta forced to 0, x/res and
    the Lanczos coefficients unchanged), so (loss, grads) must match the
    full-budget dispatch BITWISE while running strictly fewer segments."""
    from gpras_tpu.gp.exact_cg import make_cg_step_chunked

    n, d = 256, 3
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.5)
    key = jax.random.PRNGKey(9)

    kw = dict(probes=8, max_iters=64, seg_iters=4, col_panel=64,
              precond_rank=16, tol=0.02)
    full = make_cg_step_chunked("Matern52", early_exit=False, **kw)
    fast = make_cg_step_chunked("Matern52", early_exit=True, **kw)
    v_full, g_full = full(params, x, y, key)
    v_fast, g_fast = fast(params, x, y, key)
    assert full.last_segments == 16
    assert fast.last_segments < full.last_segments
    assert float(v_fast) == float(v_full)
    for k in g_full:
        np.testing.assert_array_equal(np.asarray(g_fast[k]),
                                      np.asarray(g_full[k]), err_msg=k)


def test_slq_logdet_rr_unbiased_for_deep_quadrature():
    """Russian-roulette SLQ (randomized truncation over Lanczos depth):
    E[estimate] is EXACTLY the deep-budget quadrature, at a shallow
    expected depth. Paired against the deep fixed run with the SAME probe
    key (probe noise cancels), the RR mean must sit at zero within Monte
    Carlo error, while a fixed run at the RR's expected depth (base +
    seg*q/(1-q) = 14 iterations here) carries a truncation bias two
    orders of magnitude beyond its own standard error. Everything is
    seeded, so this test is deterministic."""
    from functools import partial

    from gpras_tpu.gp.exact_cg import (_slq_logdet_from_coeffs, kmv, mbcg,
                                       slq_logdet_rr)
    from gpras_tpu.ops import linalg

    n, d = 128, 2
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, d)))  # f64 on the CPU conftest
    params = exact.init_params("Matern52", x, noise_variance=1e-3)
    noise = jnp.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
    base, seg, n_tail, q = 8, 4, 10, 0.6

    @partial(jax.jit, static_argnames=("depth",))
    def fixed(key, depth):
        _, kp = jax.random.split(key)  # slq_logdet_rr's probe-key split
        z = jax.random.rademacher(kp, (n, 8), dtype=x.dtype)
        mv = lambda v: kmv("Matern52", params, x, v, noise)
        _, a, b, rz0 = mbcg(mv, z, max_iters=depth, tol=1e-12)
        return _slq_logdet_from_coeffs(a, b, rz0)

    m = 64
    rr = np.array([float(slq_logdet_rr(
        "Matern52", params, x, jax.random.PRNGKey(i), probes=8,
        base_iters=base, seg_iters=seg, n_tail=n_tail, q=q))
        for i in range(m)])
    deep = np.array([float(fixed(jax.random.PRNGKey(i), 48))
                     for i in range(m)])
    shallow = np.array([float(fixed(jax.random.PRNGKey(i), 14))
                        for i in range(m)])

    d_rr = rr - deep
    se_rr = d_rr.std(ddof=1) / np.sqrt(m)
    assert abs(d_rr.mean()) < 3.0 * se_rr  # unbiased for the deep target
    d_sh = shallow - deep
    se_sh = d_sh.std(ddof=1) / np.sqrt(m)
    assert d_sh.mean() > 30.0  # fixed truncation at E[RR depth]: biased
    assert d_sh.mean() > 50.0 * se_sh
    # deterministic given the key (fixed-key linesearch caveat in the doc)
    again = float(slq_logdet_rr("Matern52", params, x, jax.random.PRNGKey(5),
                                probes=8, base_iters=base, seg_iters=seg,
                                n_tail=n_tail, q=q))
    assert again == rr[5]


def test_slq_logdet_rr_preconditioned():
    """The preconditioned RR path (N(0, P) probes + Woodbury logdet_P)
    matches the f64 dense logdet closely at full n_tail support — the
    preconditioner shrinks the spectrum so the deep quadrature itself is
    near-exact at modest depth."""
    from gpras_tpu.gp.exact_cg import slq_logdet_rr
    from gpras_tpu.ops import kernels as KK
    from gpras_tpu.ops import linalg

    n, d = 128, 2
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(n, d)))
    params = exact.init_params("Matern52", x, noise_variance=1e-3)
    noise = jnp.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
    kmat = KK.gram("Matern52", params, x, x) + \
        noise * jnp.eye(n, dtype=x.dtype)
    gold = float(jnp.linalg.slogdet(kmat)[1])

    m = 24
    ests = np.array([float(slq_logdet_rr(
        "Matern52", params, x, jax.random.PRNGKey(100 + i), probes=16,
        base_iters=16, seg_iters=8, n_tail=4, q=0.7, precond_rank=64))
        for i in range(m)])
    se = ests.std(ddof=1) / np.sqrt(m)
    assert abs(ests.mean() - gold) < max(4.0 * se, 0.02 * abs(gold))


def test_gate_abort_decision_rule():
    """The pure gate-abort predicate (exact_cg.gate_abort_decision): aborts
    only near-stalled decay that cannot reach the gate, and never a solve
    whose decay ever beat 0.9/segment — CG accelerates late (superlinear as
    Ritz values converge), so an early fast segment means the back half may
    be faster still (the advisor-flagged misprediction this rule closes)."""
    from gpras_tpu.gp.exact_cg import gate_abort_decision

    gate = 0.05
    # stalled bias-region trial (measured shape: residuals O(1), ratios ~1)
    stalled = [5.0, 4.8, 4.7, 4.6, 4.6]
    assert gate_abort_decision(stalled, 4.6, 5, 16, gate)
    # healthy decay, currently above gate: one 0.5x segment forbids abort
    # even though the naive projection from later stalled segments would fire
    healthy = [5.0, 2.5, 2.4, 2.3, 2.3]
    assert not gate_abort_decision(healthy, 2.3, 5, 16, gate)
    # too little history: never abort before 4 segments
    assert not gate_abort_decision([5.0, 4.9], 4.9, 2, 16, gate)
    # stalled but already projectable into the gate (rel close to gate and
    # enough remaining budget at the best ratio): no abort
    nearly = [0.5, 0.48, 0.46, 0.44, 0.42]
    assert not gate_abort_decision(nearly, 0.42, 5, 32, gate)
    # same history with almost no budget left: the outcome is decided
    assert gate_abort_decision(nearly, 0.42, 30, 32, gate)


def test_chunked_step_gate_abort_spares_healthy_decay():
    """End-to-end: a solve with healthy (sub-0.9/segment) residual decay
    runs its FULL budget even when the gate is unreachable — gate_abort no
    longer mispredicts accelerating CG (it used to abort this exact solve).
    The returned loss is the same +inf either way; production relies on
    early_exit (not the abort) to stop frozen/converged solves."""
    from gpras_tpu.gp.exact_cg import make_cg_step_chunked

    n, d = 256, 3
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=1e-6)
    key = jax.random.PRNGKey(13)

    kw = dict(probes=8, max_iters=64, seg_iters=4, col_panel=64,
              tol=1e-15, residual_gate=1e-12)
    full = make_cg_step_chunked("Matern52", gate_abort=False,
                                early_exit=False, **kw)
    fast = make_cg_step_chunked("Matern52", gate_abort=True,
                                early_exit=False, **kw)
    v_full, _ = full(params, x, y, key)
    v_fast, _ = fast(params, x, y, key)
    assert np.isposinf(float(v_full))
    assert np.isposinf(float(v_fast))
    assert full.last_segments == 16
    assert fast.last_segments == 16  # healthy decay: no abort

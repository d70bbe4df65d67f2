"""Distributed components on a virtual 8-device CPU mesh: sharded Gram,
distributed blocked Cholesky/solves, distributed NLML + custom VJP, sharded PCA."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpras_tpu.gp import exact
from gpras_tpu.ops import kernels as K
from gpras_tpu.parallel import make_mesh
from gpras_tpu.parallel.pcholesky import (
    dist_cho_solve,
    dist_cholesky,
    dist_logdet_from_chol,
)
from gpras_tpu.parallel.pexact import make_dist_fit_step, make_dist_nlml
from gpras_tpu.parallel.pgram import pgram_2d, pgram_rows
from gpras_tpu.parallel.ppca import ppca_fit, ppca_inverse, ppca_transform

N, D, B = 64, 3, 8


def make_spd(n=N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return jnp.asarray(a @ a.T + n * np.eye(n))


def make_xy(n=N, seed=1):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, D)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n))
    return x, y


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_pgram_rows_matches_single_device():
    mesh = make_mesh()
    x, _ = make_xy()
    params = K.init_params("Matern52", D, variance=1.3, lengthscales=0.8,
                           dtype=jnp.float64)
    got = np.asarray(pgram_rows(mesh, "Matern52", params, x, noise=0.25))
    want = np.asarray(K.gram("Matern52", params, x)) + 0.25 * np.eye(N)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_pgram_2d_matches_single_device():
    mesh = make_mesh((4, 2), ("i", "j"))
    x, _ = make_xy()
    params = K.init_params("RBF", D, dtype=jnp.float64)
    got = np.asarray(pgram_2d(mesh, "RBF", params, x))
    want = np.asarray(K.gram("RBF", params, x))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_dist_cholesky_matches_dense():
    mesh = make_mesh()
    k = make_spd()
    got = np.asarray(dist_cholesky(mesh, k, b=B))
    want = np.linalg.cholesky(np.asarray(k))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_dist_cholesky_block_spanning_devices():
    """Block size larger than one device's rows (b=16, nr=8) still works when
    panels align with device boundaries."""
    mesh = make_mesh((4,), ("i",))
    k = make_spd()
    got = np.asarray(dist_cholesky(mesh, k, b=16))
    want = np.linalg.cholesky(np.asarray(k))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_dist_solve_matches_dense():
    mesh = make_mesh()
    k = make_spd(seed=2)
    rng = np.random.default_rng(3)
    rhs = jnp.asarray(rng.normal(size=(N, 4)))
    l = dist_cholesky(mesh, k, b=B)
    got = np.asarray(dist_cho_solve(mesh, l, rhs, b=B))
    want = np.linalg.solve(np.asarray(k), np.asarray(rhs))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    # 1-D rhs path
    got1 = np.asarray(dist_cho_solve(mesh, l, rhs[:, 0], b=B))
    np.testing.assert_allclose(got1, want[:, 0], rtol=1e-8, atol=1e-8)


def test_dist_logdet_matches_dense():
    mesh = make_mesh()
    k = make_spd(seed=4)
    l = dist_cholesky(mesh, k, b=B)
    got = float(dist_logdet_from_chol(mesh, l))
    want = float(np.linalg.slogdet(np.asarray(k))[1])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_dist_nlml_matches_single_device():
    mesh = make_mesh()
    x, y = make_xy()
    params = exact.init_params("RBF", x, noise_variance=0.2)
    nlml = make_dist_nlml(mesh, "RBF", b=B)
    got = float(nlml(params, x, y))
    want = float(exact.nlml("RBF", params, x, y))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_dist_nlml_gradient_matches_single_device():
    mesh = make_mesh()
    x, y = make_xy(seed=5)
    params = exact.init_params("Matern32", x, noise_variance=0.3)
    nlml = make_dist_nlml(mesh, "Matern32", b=B, col_batch=16)
    g_dist = jax.grad(nlml)(params, x, y)
    g_ref = jax.grad(lambda p: exact.nlml("Matern32", p, x, y))(params)
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g_dist[k]), np.asarray(g_ref[k]),
                                   rtol=1e-7, atol=1e-9)


def test_dist_fit_step_decreases_loss():
    mesh = make_mesh()
    x, y = make_xy(seed=6)
    params = exact.init_params("RBF", x, noise_variance=0.5)
    init, step = make_dist_fit_step(mesh, "RBF", b=B, learning_rate=0.05)
    opt_state = init(params)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_ppca_matches_single_device():
    from gpras_tpu.eof.pca import pca_fit

    mesh = make_mesh()
    rng = np.random.default_rng(7)
    s, c, k = 24, 64, 5
    x = rng.normal(size=(s, c))
    x = x - x.mean(axis=0)
    xj = jnp.asarray(x)
    comps_d, expl_d = ppca_fit(mesh, xj, k)
    comps_s, expl_s = pca_fit(xj, k)
    np.testing.assert_allclose(np.asarray(expl_d), np.asarray(expl_s)[:k],
                               rtol=1e-8)
    # same subspace up to sign
    for i in range(k):
        dot = abs(np.dot(np.asarray(comps_d)[i], np.asarray(comps_s)[i]))
        np.testing.assert_allclose(dot, 1.0, atol=1e-8)
    # transform + inverse round trip against dense ops
    modes = ppca_transform(mesh, xj, comps_d)
    np.testing.assert_allclose(np.asarray(modes), x @ np.asarray(comps_d).T,
                               rtol=1e-8, atol=1e-8)
    recon = ppca_inverse(mesh, modes, comps_d)
    np.testing.assert_allclose(np.asarray(recon),
                               np.asarray(modes) @ np.asarray(comps_d),
                               rtol=1e-8, atol=1e-8)


def test_sharded_multi_start_improves_loss():
    from gpras_tpu.gp import sgpr
    from gpras_tpu.parallel.pfit import sharded_multi_start

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(32, 2)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.05 * rng.normal(size=32))
    params = sgpr.init_params("RBF", x, x[:6], noise_variance=0.5)

    def loss_fn(p):
        return sgpr.training_loss("RBF", p, x, y)

    mesh = make_mesh()
    before = float(loss_fn(params))
    fitted, info = sharded_multi_start(mesh, loss_fn, params, x=x,
                                       n_starts=8, iter_initial=5, iter_final=20)
    assert float(info["loss"]) < before
    assert info["restart_losses"].shape == (8,)


def test_dist_cg_nlml_matches_single_chip():
    """Row-sharded matrix-free CG NLML == the single-chip CG engine (same key),
    and its gradient matches the exact dense gradient to MC tolerance."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpras_tpu.gp import exact
    from gpras_tpu.gp.exact_cg import make_cg_nlml
    from gpras_tpu.parallel import make_mesh
    from gpras_tpu.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    n, d = 128, 3
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, d)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n))
    params = exact.init_params("Matern52", x, noise_variance=0.3)
    key = jax.random.PRNGKey(3)

    nlml_d, loss_d = make_dist_cg_nlml(mesh, "Matern52", probes=8,
                                       max_iters=96, row_panel=8)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("i")))
    got = float(nlml_d(params, x_sh, y, key))
    ref_nlml = make_cg_nlml("Matern52", probes=8, max_iters=96,
                            row_panel=16, col_panel=16)
    want = float(ref_nlml(params, x, y, key))
    np.testing.assert_allclose(got, want, rtol=1e-4)

    # PRECONDITIONED path: same key => identical probe draws and identical
    # pivoted-Cholesky factor, so value AND gradient must match the
    # single-chip preconditioned engine tightly (not an MC tolerance)
    nlml_pc, _ = make_dist_cg_nlml(mesh, "Matern52", probes=8, max_iters=32,
                                   row_panel=8, precond_rank=16)
    ref_pc = make_cg_nlml("Matern52", probes=8, max_iters=32,
                          row_panel=16, col_panel=16, precond_rank=16)
    np.testing.assert_allclose(float(nlml_pc(params, x_sh, y, key)),
                               float(ref_pc(params, x, y, key)), rtol=1e-6)
    g_dist = jax.grad(lambda p: nlml_pc(p, x_sh, y, key))(params)
    g_single = jax.grad(lambda p: ref_pc(p, x, y, key))(params)
    for name in g_single:
        np.testing.assert_allclose(np.asarray(g_dist[name]),
                                   np.asarray(g_single[name]),
                                   rtol=1e-4, atol=1e-10, err_msg=name)
    # and the stochastic gradient estimates the exact dense gradient
    g_exact = jax.grad(lambda p: exact.nlml("Matern52", p, x, y))(params)
    for name in g_exact:
        ge, gd = np.asarray(g_exact[name]), np.asarray(g_dist[name])
        scale = max(np.max(np.abs(ge)), 1.0)
        np.testing.assert_allclose(gd, ge, atol=0.2 * scale, err_msg=name)


def test_dist_cg_preconditioner_survives_small_noise():
    """At fitted-noise scales (1e-3) plain distributed CG stalls within the
    iteration budget while the rank-k preconditioned path converges — the
    regime every successful fit ends in."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpras_tpu.gp import exact
    from gpras_tpu.parallel import make_mesh
    from gpras_tpu.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    n, d = 128, 2
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(n, d)))
    y = jnp.asarray(np.sin(2.0 * np.asarray(x)[:, 0]) + 0.03 * rng.normal(size=n))
    params = exact.init_params("RBF", x, noise_variance=1e-3)
    key = jax.random.PRNGKey(11)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("i")))

    want = float(exact.nlml("RBF", params, x, y))
    nlml_plain, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16,
                                      row_panel=8)
    nlml_pc, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16,
                                   row_panel=8, precond_rank=64)
    err_plain = abs(float(nlml_plain(params, x_sh, y, key)) - want)
    err_pc = abs(float(nlml_pc(params, x_sh, y, key)) - want)
    assert err_pc < abs(want) * 0.02, (err_pc, want)
    assert err_pc < 0.25 * err_plain, (err_pc, err_plain)


def test_sharded_predict_matches_single_device():
    """Event-sharded posterior == single-device GPRAS.predict for both
    backends (queries row-sharded, factors replicated, zero collectives)."""
    import numpy as np
    import jax.numpy as jnp

    from gpras_tpu.gp.model import GPRAS
    from gpras_tpu.parallel import make_mesh
    from gpras_tpu.parallel.ppredict import sharded_predict

    mesh = make_mesh((8,), ("i",))
    rng = np.random.default_rng(17)
    x = rng.normal(size=(96, 2)).astype(np.float64)
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1)
    xq = rng.normal(size=(64, 2)).astype(np.float64)

    for backend, kwargs in (("sgpr", {"n_inducing": 12}), ("exact", {})):
        m = GPRAS("RBF", model_type=backend, dtype=jnp.float64)
        m.fit(x, y, optimization_method="adam", max_iter=5, **kwargs)
        want_mean, want_var = m.predict(xq)
        got_mean, got_var = sharded_predict(mesh, m, xq)
        np.testing.assert_allclose(np.asarray(got_mean), want_mean, rtol=1e-8,
                                   err_msg=backend)
        np.testing.assert_allclose(np.asarray(got_var), want_var, rtol=1e-8,
                                   err_msg=backend)


@pytest.mark.skipif(os.environ.get("GPRAS_SLOW_TESTS") != "1",
                    reason="multi-minute: N=8192 distributed NLML on the "
                           "8-virtual-device mesh (set GPRAS_SLOW_TESTS=1)")
def test_dist_nlml_at_8k_matches_dense():
    """Scale evidence for the distributed exact-GP NLML beyond toy sizes:
    N=8192 on the virtual mesh, value vs the dense
    single-device NLML."""
    import math
    from gpras_tpu.ops import linalg

    n = 8192
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, D)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n))
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    mesh = make_mesh()
    got = float(dist_nlml_value(mesh, params, x, y, b=256))
    # dense reference (float64 CPU)
    k = np.array(K.gram("Matern52", params, x))  # writable host copy
    noise = float(np.exp(params["log_noise_variance"]))
    jit = linalg.default_jitter(x.dtype) * float(np.exp(params["log_variance"]))
    k += (noise + jit) * np.eye(n)
    l = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, np.asarray(y))
    want = (0.5 * float(np.dot(np.asarray(y), alpha))
            + float(np.sum(np.log(np.diag(l))))
            + 0.5 * n * math.log(2.0 * math.pi))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def dist_nlml_value(mesh, params, x, y, b):
    from gpras_tpu.parallel.pexact import dist_nlml_forward

    return dist_nlml_forward(mesh, "Matern52", params, x, y, b=b)[0]


def test_dist_fit_step_2d_default_suite():
    """The SAME 2-D distributed forward+backward code path as the slow-gated
    16k test, sized to run in the default suite: one full Adam step at
    N=2,048 with b=128 on the (4, 2) mesh —
    resolve_layout picks the 2-D P(i, j) engine — with the loss checked
    against the dense f64 NLML and every parameter moved finitely. The
    flagship distributed evidence now executes on every test run, not only
    under GPRAS_SLOW_TESTS=1."""
    import math
    from gpras_tpu.ops import linalg
    from gpras_tpu.parallel.pexact import make_dist_fit_step, resolve_layout

    n = 2048
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, D)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n))
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    mesh = make_mesh((4, 2), ("i", "j"))
    assert resolve_layout(mesh) == "2d"
    init, step = make_dist_fit_step(mesh, "Matern52", b=128,
                                    learning_rate=0.05)
    p1, _, loss = step(params, init(params), x, y)
    k = np.array(K.gram("Matern52", params, x), dtype=np.float64)
    noise = float(np.exp(params["log_noise_variance"]))
    jit = linalg.default_jitter(x.dtype) * float(np.exp(params["log_variance"]))
    k += (noise + jit) * np.eye(n)
    l = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, np.asarray(y, np.float64))
    want = (0.5 * float(np.dot(np.asarray(y, np.float64), alpha))
            + float(np.sum(np.log(np.diag(l))))
            + 0.5 * n * math.log(2.0 * math.pi))
    np.testing.assert_allclose(float(loss), want, rtol=1e-9)
    for name, v in p1.items():
        arr = np.asarray(v)
        assert np.all(np.isfinite(arr)), f"{name} non-finite after step"
        assert np.any(arr != np.asarray(params[name])), f"{name} did not move"


def test_dist_fit_step_2d_at_4k_f32_loss_vs_dense():
    """The 16k slow-gated evidence, shrunk onto a default-suite schedule:
    one full forward+backward Adam step at N=4,096 in
    FLOAT32 on the (4, 2) mesh, loss checked against the dense f64 NLML —
    the flagship distributed loss-vs-dense claim now executes on every
    test run (the 16k variant stays under GPRAS_SLOW_TESTS=1)."""
    import math
    from gpras_tpu.ops import linalg
    from gpras_tpu.parallel.pexact import resolve_layout

    n = 4096
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, D)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    mesh = make_mesh((4, 2), ("i", "j"))
    assert resolve_layout(mesh) == "2d"
    init, step = make_dist_fit_step(mesh, "Matern52", b=256,
                                    learning_rate=0.05)
    p1, _, loss = step(params, init(params), x, y)
    k = np.array(K.gram("Matern52", params, x), dtype=np.float64)
    noise = float(np.exp(params["log_noise_variance"]))
    jit = linalg.default_jitter(x.dtype) * float(np.exp(params["log_variance"]))
    k += (noise + jit) * np.eye(n)
    l = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, np.asarray(y, np.float64))
    want = (0.5 * float(np.dot(np.asarray(y, np.float64), alpha))
            + float(np.sum(np.log(np.diag(l))))
            + 0.5 * n * math.log(2.0 * math.pi))
    np.testing.assert_allclose(float(loss), want, rtol=2e-4)
    for name, v in p1.items():
        arr = np.asarray(v)
        assert np.all(np.isfinite(arr)), f"{name} non-finite after step"
        assert np.any(arr != np.asarray(params[name])), f"{name} did not move"


@pytest.mark.skipif(os.environ.get("GPRAS_SLOW_TESTS") != "1",
                    reason="many-minute: N=16384 2-D distributed fit step on "
                           "the 8-virtual-device mesh (set GPRAS_SLOW_TESTS=1)")
def test_dist_fit_step_2d_at_16k():
    """Scale evidence for the DEFAULT (auto -> 2-D) distributed training
    step beyond N=8k: one full forward+backward Adam
    step at N=16,384 on a (4, 2) mesh, float32; the loss must match the
    dense f64 NLML and the step must move every parameter finitely."""
    import math
    from gpras_tpu.ops import linalg
    from gpras_tpu.parallel.pexact import make_dist_fit_step, resolve_layout

    n = 16384
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, D)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0])
                    + 0.1 * rng.normal(size=n), jnp.float32)
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    mesh = make_mesh((4, 2), ("i", "j"))
    assert resolve_layout(mesh) == "2d"
    init, step = make_dist_fit_step(mesh, "Matern52", b=512,
                                    learning_rate=0.05)
    p1, _, loss = step(params, init(params), x, y)
    # dense float64 reference NLML at the initial params
    k = np.array(K.gram("Matern52", params, x), dtype=np.float64)
    noise = float(np.exp(params["log_noise_variance"]))
    jit = linalg.default_jitter(x.dtype) * float(np.exp(params["log_variance"]))
    k += (noise + jit) * np.eye(n)
    l = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, np.asarray(y, np.float64))
    want = (0.5 * float(np.dot(np.asarray(y, np.float64), alpha))
            + float(np.sum(np.log(np.diag(l))))
            + 0.5 * n * math.log(2.0 * math.pi))
    np.testing.assert_allclose(float(loss), want, rtol=2e-4)
    for name, v in p1.items():
        arr = np.asarray(v)
        assert np.all(np.isfinite(arr)), f"{name} non-finite after step"
        assert np.any(arr != np.asarray(params[name])), f"{name} did not move"


def test_pgram_2d_noise_diagonal():
    mesh = make_mesh((4, 2), ("i", "j"))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(N, D)))
    params = K.init_params("RBF", D, dtype=jnp.float64)
    got = np.asarray(pgram_2d(mesh, "RBF", params, x, noise=0.37))
    want = np.asarray(K.gram("RBF", params, x)) + 0.37 * np.eye(N)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_dist_stochastic_backward_matches_exact():
    """The distributed Hutchinson backward (make_dist_nlml_stochastic) is an
    unbiased estimator of the exact distributed gradient: with many probes
    the trace term concentrates, and the deterministic parts (quad term,
    y_bar) match exactly. Checked on both mesh layouts."""
    from gpras_tpu.parallel.pexact import (make_dist_nlml,
                                           make_dist_nlml_stochastic)

    n = 64
    x, y = make_xy(n)
    x, y = x.astype(jnp.float64), y.astype(jnp.float64)
    params = exact.init_params("Matern52", x, noise_variance=0.3)

    for mesh, layout in ((make_mesh((8,), ("i",)), "1d"),
                         (make_mesh((4, 2), ("i", "j")), "2d")):
        nlml_e = make_dist_nlml(mesh, "Matern52", b=8, col_batch=16,
                                layout=layout)
        val_e, grads_e = jax.value_and_grad(nlml_e)(params, x, y)
        nlml_s = make_dist_nlml_stochastic(mesh, "Matern52", b=8,
                                           col_batch=16, layout=layout,
                                           probes=1024)
        val_s, grads_s = jax.value_and_grad(nlml_s)(
            params, x, y, jax.random.PRNGKey(7))
        # forward value is the same deterministic factorization
        np.testing.assert_allclose(float(val_s), float(val_e), rtol=1e-12,
                                   err_msg=layout)
        for k in grads_e:
            ge, gs = np.asarray(grads_e[k]), np.asarray(grads_s[k])
            scale = max(np.max(np.abs(ge)), 1e-3)
            np.testing.assert_allclose(gs, ge, atol=0.15 * scale,
                                       err_msg=f"{layout}:{k}")

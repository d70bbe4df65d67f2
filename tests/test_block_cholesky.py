"""In-place blocked Cholesky + panel solves vs dense references."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpras_tpu.ops.block_cholesky import (
    blocked_cho_solve,
    blocked_cholesky,
    blocked_solve_lower,
    blocked_solve_upper,
)


def make_spd(n=96, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return jnp.asarray(a @ a.T + n * np.eye(n))


@pytest.mark.parametrize("b", [8, 16, 32, 96])
def test_blocked_cholesky_matches_dense(b):
    k = make_spd()
    got = np.asarray(blocked_cholesky(k, b))
    want = np.linalg.cholesky(np.asarray(k))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_blocked_solves_match_dense():
    k = make_spd(seed=1)
    l = blocked_cholesky(k, 16)
    rng = np.random.default_rng(2)
    rhs = jnp.asarray(rng.normal(size=(96, 5)))
    ln = np.asarray(l)
    np.testing.assert_allclose(np.asarray(blocked_solve_lower(l, rhs, 16)),
                               np.linalg.solve(ln, np.asarray(rhs)),
                               rtol=1e-8, atol=1e-8)
    y = blocked_solve_lower(l, rhs, 16)
    np.testing.assert_allclose(np.asarray(blocked_solve_upper(l, y, 16)),
                               np.linalg.solve(ln.T, np.asarray(y)),
                               rtol=1e-8, atol=1e-8)
    got = np.asarray(blocked_cho_solve(l, rhs, 16))
    want = np.linalg.solve(np.asarray(k), np.asarray(rhs))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    # 1-D rhs path
    got1 = np.asarray(blocked_cho_solve(l, rhs[:, 0], 16))
    np.testing.assert_allclose(got1, want[:, 0], rtol=1e-7, atol=1e-7)


def test_bad_block_size_raises():
    with pytest.raises(ValueError):
        blocked_cholesky(make_spd(), 7)


def test_super_cholesky_matches_xla():
    """Shrinking-panel two-level factorization: exact agreement incl. ragged
    strips (strip not aligned to the panel width) and both precision modes."""
    from gpras_tpu.ops.block_cholesky import super_cholesky

    rng = np.random.default_rng(3)
    for n, w, strip in [(96, 32, 48), (128, 32, 128), (64, 64, 64)]:
        a = rng.normal(size=(n, 16))
        k = jnp.asarray(a @ a.T + n * np.eye(n))
        ref = np.asarray(jnp.linalg.cholesky(k))
        for fast in (True, False):
            got = np.asarray(super_cholesky(k, w, strip, fast))
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9,
                                       err_msg=f"n={n} w={w} strip={strip} fast={fast}")


def test_super_cholesky_ignores_stale_upper_triangle():
    """Regression: the strip updates only maintain the lower triangle, so the
    factorization must never read the (stale) upper part. Feeding a matrix
    with garbage above the diagonal must still factor the lower part right."""
    from gpras_tpu.ops.block_cholesky import super_cholesky

    rng = np.random.default_rng(4)
    a = rng.normal(size=(96, 16))
    k = a @ a.T + 96 * np.eye(96)
    garbage = np.triu(rng.normal(size=(96, 96)) * 100.0, k=1)
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(k)))
    got = np.asarray(super_cholesky(jnp.asarray(k + garbage), 32, 48, True))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_super_cholesky_bad_width_raises():
    from gpras_tpu.ops.block_cholesky import super_cholesky

    with pytest.raises(ValueError):
        super_cholesky(make_spd(), 7)


def test_tri_inverse_matches_inv():
    from gpras_tpu.ops import linalg

    rng = np.random.default_rng(3)
    a = rng.normal(size=(48, 48))
    l = np.linalg.cholesky(a @ a.T + 48 * np.eye(48))
    got = np.asarray(linalg.tri_inverse(jnp.asarray(l)))
    np.testing.assert_allclose(got, np.linalg.inv(l), rtol=1e-9, atol=1e-9)
    assert np.allclose(np.triu(got, 1), 0.0)
    # stale upper-triangle values must not leak into the result
    garbage = np.triu(np.full((48, 48), 1e6), 1)
    got2 = np.asarray(linalg.tri_inverse(jnp.asarray(l + garbage)))
    np.testing.assert_allclose(got2, got, rtol=1e-12)


def test_blocked_engines_survive_high_condition_f32():
    """cond(K) ~ 3e5 in float32: XLA's cholesky survives this easily; the
    blocked engines must too (they NaN'd at cond ~1e4 before the
    controlled-precision panel solves with a 1-pass low-precision product;
    exercised here in f32 on CPU)."""
    from gpras_tpu.ops.block_cholesky import super_cholesky

    rng = np.random.default_rng(0)
    n = 512
    x = rng.normal(size=(n, 3))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2 / 4.0) + 2e-4 * np.eye(n)
    k32 = jnp.asarray(k, jnp.float32)
    for fn in (lambda: blocked_cholesky(k32, 64),
               lambda: super_cholesky(k32, 128, 256, "high")):
        got = np.tril(np.asarray(fn(), np.float64))
        assert np.all(np.isfinite(got))
        # factor quality = reconstruction error (elementwise comparison of
        # tiny trailing pivots is meaningless at this conditioning)
        recon = np.abs(got @ got.T - k).max()
        assert recon < 1e-5 * np.abs(k).max(), recon

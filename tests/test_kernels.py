"""Kernel Gram builders vs closed-form values and naive O(N^2 D) references."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpras_tpu.ops import kernels as K


def naive_gram(kernel, params, x1, x2):
    """Straightforward per-pair evaluation (float64 numpy) as ground truth."""
    p = {k: np.asarray(v, dtype=np.float64) for k, v in params.items()}
    s2 = np.exp(p["log_variance"])
    out = np.zeros((x1.shape[0], x2.shape[0]))
    for i in range(x1.shape[0]):
        for j in range(x2.shape[0]):
            a, b = x1[i], x2[j]
            if kernel in K.STATIONARY_KERNELS:
                ls = np.exp(p["log_lengthscales"])
                r2 = np.sum(((a - b) / ls) ** 2)
                r = np.sqrt(r2)
                if kernel == "RBF":
                    out[i, j] = s2 * np.exp(-0.5 * r2)
                elif kernel == "Matern12":
                    out[i, j] = s2 * np.exp(-r)
                elif kernel == "Matern32":
                    out[i, j] = s2 * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)
                elif kernel == "Matern52":
                    out[i, j] = s2 * (1 + np.sqrt(5) * r + 5 / 3 * r2) * np.exp(-np.sqrt(5) * r)
                elif kernel == "Exponential":
                    out[i, j] = s2 * np.exp(-0.5 * r)
            elif kernel == "Linear":
                out[i, j] = s2 * a @ b
            elif kernel == "Polynomial":
                out[i, j] = (s2 * a @ b + np.exp(p["log_offset"])) ** p["degree"]
            elif kernel == "Periodic":
                ls = np.exp(p["log_lengthscales"])
                period = np.exp(p["log_period"])
                r2 = np.sum((2 * np.sin(np.pi * (a - b) / period) / ls) ** 2)
                out[i, j] = s2 * np.exp(-0.5 * r2)
    return out


@pytest.mark.parametrize("kernel", K.KERNEL_NAMES)
def test_gram_matches_naive(kernel):
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(7, 3))
    x2 = rng.normal(size=(5, 3))
    params = K.init_params(kernel, 3, variance=1.7, lengthscales=np.array([0.5, 1.0, 2.0]),
                           period=1.3, offset=0.7, degree=3.0, dtype=jnp.float64)
    got = np.asarray(K.gram(kernel, params, jnp.asarray(x1), jnp.asarray(x2)))
    want = naive_gram(kernel, params, x1, x2)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kernel", K.KERNEL_NAMES)
def test_kdiag_matches_gram_diagonal(kernel):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(6, 2)))
    params = K.init_params(kernel, 2, variance=0.9, lengthscales=1.4, dtype=jnp.float64)
    full = np.diag(np.asarray(K.gram(kernel, params, x)))
    diag = np.asarray(K.kdiag(kernel, params, x))
    np.testing.assert_allclose(diag, full, rtol=1e-8, atol=1e-10)


def test_gram_symmetry_and_psd():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(20, 4)))
    for kernel in K.STATIONARY_KERNELS:
        params = K.init_params(kernel, 4, dtype=jnp.float64)
        g = np.asarray(K.gram(kernel, params, x))
        np.testing.assert_allclose(g, g.T, atol=1e-12)
        evals = np.linalg.eigvalsh(g)
        assert evals.min() > -1e-8


def test_constrain_roundtrip():
    params = K.init_params("Periodic", 3, variance=2.0, lengthscales=0.3, period=1.1,
                           dtype=jnp.float64)
    back = K.unconstrain(K.constrain(params))
    for k in params:
        np.testing.assert_allclose(np.asarray(back[k]), np.asarray(params[k]), rtol=1e-12)


def test_gram_gradients_finite_at_coincident_points():
    """Matern gradients must not NaN when x1 == x2 rows coincide (r=0)."""
    import jax

    x = jnp.asarray(np.ones((4, 2)))  # all points identical: worst case
    for kernel in K.KERNEL_NAMES:
        params = K.init_params(kernel, 2, dtype=jnp.float64)

        def f(p):
            return jnp.sum(K.gram(kernel, p, x))

        grads = jax.grad(f)(params)
        for leaf in jax.tree.leaves(grads):
            assert np.all(np.isfinite(np.asarray(leaf))), kernel


def _fused_case(seed, n1, n2, d, r):
    rng = np.random.default_rng(seed)
    params = {"log_variance": jnp.asarray(0.3, jnp.float32),
              "log_lengthscales": jnp.asarray(
                  np.log(rng.uniform(0.5, 2.0, d)), jnp.float32)}
    x1 = jnp.asarray(rng.normal(size=(n1, d)), jnp.float32)
    x2 = None if n2 is None else jnp.asarray(rng.normal(size=(n2, d)),
                                             jnp.float32)
    v = jnp.asarray(rng.normal(size=(n1 if n2 is None else n2, r)),
                    jnp.float32)
    return params, x1, x2, v


def _f64(tree):
    return {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in tree.items()}


@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
@pytest.mark.parametrize("square", [True, False])
def test_fused_kmv_interpret_matches_f64(kernel, square):
    """The fused matvec (ops/fused.kmv, interpret mode) == the float64 dense
    K(x1, x2) @ v, square and rectangular, with every dimension padded
    (rows to the blocks, D and R to powers of two >= 16)."""
    from gpras_tpu.ops import fused

    params, x1, x2, v = _fused_case(7, 300, None if square else 77, 5, 3)
    got = np.asarray(fused.kmv(kernel, params, x1, v, x2, interpret=True))
    kd = np.asarray(K.gram(kernel, _f64(params),
                           jnp.asarray(np.asarray(x1), jnp.float64),
                           None if square else
                           jnp.asarray(np.asarray(x2), jnp.float64)))
    want = kd @ np.asarray(v, np.float64)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.max(np.abs(want)),
                               rtol=2e-4)


@pytest.mark.parametrize("n1,r,block_m,block_n", [
    (1, 1, 16, 16),       # one row, one column of V
    (129, 16, 32, 16),    # one row past a block, R already a power of two
    (64, 33, 64, 32),     # rows exactly one block, R just past one
    (40, 130, 16, 16),    # R past one 128-column chunk: a 2-D grid
])
def test_fused_kmv_padding_and_blocks(n1, r, block_m, block_n):
    """Block sizes and paddings never change the product: padded V rows are
    zero and padded output rows are cropped."""
    from gpras_tpu.ops import fused

    params, x1, x2, v = _fused_case(11, n1, 50, 3, r)
    got = np.asarray(fused.kmv("Matern32", params, x1, v, x2, interpret=True,
                               block_m=block_m, block_n=block_n))
    want = np.asarray(K.gram("Matern32", params, x1, x2)) @ np.asarray(v)
    assert got.shape == (n1, r)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fused_kmv_under_vmap():
    """The matrix-free predict vmaps the matvec over EOF modes."""
    import jax

    from gpras_tpu.ops import fused

    params, x1, _, v = _fused_case(3, 96, None, 4, 2)
    batched = jax.tree.map(lambda a: jnp.stack([a, a + 0.2]), params)
    got = np.asarray(jax.vmap(
        lambda p: fused.kmv("RBF", p, x1, v, interpret=True))(batched))
    for i in range(2):
        p_i = jax.tree.map(lambda a: a[i], batched)
        want = np.asarray(K.gram("RBF", p_i, x1)) @ np.asarray(v)
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-5)


def test_fused_kmv_under_shard_map():
    """Sharded prediction runs the fused matvec inside ``shard_map`` with
    its default ``check_vma=True``; each device's block of the result
    matches the kernel run on that device's rows alone."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gpras_tpu.ops import fused
    from gpras_tpu.parallel import make_mesh

    params, x1, x2, v = _fused_case(13, 64, 40, 3, 2)
    run = lambda xq: fused.kmv("Matern52", params, xq, v, x2, interpret=True)
    got = jax.shard_map(run, mesh=make_mesh((4,), ("i",)), in_specs=P("i"),
                        out_specs=P("i"))(x1)
    for i in range(4):
        rows = slice(16 * i, 16 * (i + 1))
        np.testing.assert_allclose(np.asarray(got[rows]),
                                   np.asarray(run(x1[rows])), rtol=1e-6)


@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
@pytest.mark.parametrize("n", [64, 200])   # one block; padded multi-block
def test_fused_kgrad_matches_f64_autodiff(kernel, n):
    """Fused gradient contraction (ops/fused.kgrad, interpret mode) == the
    FLOAT64 autodiff vjp of the dense Gram contracted with the same
    rank-(m+1) cotangent, for every stationary kernel.

    The reference is f64 deliberately: for the r-singular kernels
    (Matern12/Exponential) the f32 autodiff path itself is visibly off the
    f64 truth near r = 0, while the fused kernel's exact-f32 distance
    keeps it close."""
    import jax

    from gpras_tpu.ops import fused

    rng = np.random.default_rng(5)
    d, m = 5, 8
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(n, m)), jnp.float32)
    z = jnp.asarray(rng.choice([-1.0, 1.0], size=(n, m)), jnp.float32)
    alpha = jnp.asarray(rng.normal(size=n), jnp.float32)
    params = {"log_variance": jnp.asarray(0.3, jnp.float32),
              "log_lengthscales": jnp.asarray(rng.normal(size=d) * 0.2,
                                              jnp.float32)}
    g, inv_m = 1.7, 1.0 / m
    w64, z64, a64 = (np.asarray(a, np.float64) for a in (w, z, alpha))
    kbar64 = 0.5 * g * (inv_m * (w64 @ z64.T) - np.outer(a64, a64))
    x64 = jnp.asarray(np.asarray(x), jnp.float64)
    _, pullback = jax.vjp(lambda p: K.gram(kernel, p, x64), _f64(params))
    (want,) = pullback(jnp.asarray(kbar64))
    got = fused.kgrad(kernel, params, x, w, z, alpha, g=g, inv_m=inv_m,
                      interpret=True, block_m=32, block_n=32)
    # both gradients are sums of n^2 f32 terms that largely cancel
    np.testing.assert_allclose(float(got["log_variance"]),
                               float(want["log_variance"]), rtol=2e-3)
    gl = np.asarray(got["log_lengthscales"], np.float64)
    wl = np.asarray(want["log_lengthscales"], np.float64)
    np.testing.assert_allclose(gl, wl, atol=2e-3 * np.max(np.abs(wl)),
                               rtol=2e-3)


class _FakeDevice:
    def __init__(self, platform, cc=None):
        self.platform = platform
        if cc is not None:
            self.compute_capability = cc


@pytest.mark.parametrize("platform,cc,kernel,dtype,want", [
    ("cpu", None, "Matern52", jnp.float32, False),    # CPU: plain path only
    ("gpu", "9.0", "Matern52", jnp.float32, True),    # Hopper
    ("gpu", "8.0", "RBF", jnp.float32, True),         # Ampere (TF32)
    ("gpu", "7.0", "Matern52", jnp.float32, False),   # no TF32 tensor cores
    ("gpu", "9.0", "Matern52", jnp.float64, False),   # f32 kernels only
    ("gpu", "9.0", "Periodic", jnp.float32, False),   # stationary only
])
def test_use_fused_dispatch(monkeypatch, platform, cc, kernel, dtype, want):
    import jax

    from gpras_tpu.ops import fused

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform, cc)])
    assert fused.use_fused(kernel, dtype) is want
    assert fused.use_fused(kernel, dtype, fused.FUSED_MAX_RHS) is want
    # wider right-hand sides go to XLA's panel loop, which shares one tile
    assert fused.use_fused(kernel, dtype, fused.FUSED_MAX_RHS + 1) is False
    with fused.plain_xla():
        assert fused.use_fused(kernel, dtype) is False


@pytest.mark.gpu
def test_fused_kernels_compiled_on_gpu(gpu_device):
    """The compiled kernels against the plain XLA path on the card (the
    same check chip_smoke.py's kernels phase makes at full width)."""
    import chip_smoke

    chip_smoke.phase_kernels(n_kmv=8192, r=17, n_kgrad=4096)

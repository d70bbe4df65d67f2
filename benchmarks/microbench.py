"""On-device microbenchmarks for the hot linalg ops.

All operands are generated ON DEVICE so host->device transfers stay out of
the timings. Each op is timed with fresh (cheaply perturbed) inputs.

Usage: PYTHONPATH=. python benchmarks/microbench.py [op ...]
Ops: syrk chol_xla chol_blocked chol_super trsm kmv gram
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpras_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = int(os.environ.get("N", "16384"))
REPS = int(os.environ.get("REPS", "5"))


@jax.jit
def make_k(key):
    a = jax.random.normal(key, (N, 128), jnp.float32)
    return a @ a.T + N * jnp.eye(N, dtype=jnp.float32)


@jax.jit
def _perturb(x, out):
    # Data-depend each rep's input on the previous output: fresh buffers,
    # value-distinct inputs; relative 1e-6 keeps the perturbation above f32 ulp (value-distinct
    # inputs), while the data dependence also forces fresh buffers
    eps = jnp.tanh(jnp.asarray(out).ravel()[0]) * jnp.float32(1e-6)
    return jax.tree.map(lambda a: a + eps.astype(a.dtype), x)


def timeit(name, f, make_input, flops=None):
    keys = jax.random.split(jax.random.PRNGKey(0), REPS + 1)
    def sync(v):
        return jax.block_until_ready(v)

    x = make_input(keys[0])
    sync(x)
    out = f(x)
    sync(out)  # compile + exec
    x2 = _perturb(x, jax.tree.leaves(out)[0])
    sync(x2)   # compile perturb
    t0 = time.perf_counter()
    for i in range(REPS):
        x = _perturb(x, jax.tree.leaves(out)[0])
        out = f(x)
    sync(out)
    dt = (time.perf_counter() - t0) / REPS
    eff = f"  {flops / dt / 1e12:.1f} TFLOP/s" if flops else ""
    print(f"{name}: {dt*1e3:.1f} ms{eff}", flush=True)
    return dt


ops = sys.argv[1:] or ["syrk", "chol_xla", "chol_blocked"]

if "syrk" in ops:
    b = int(os.environ.get("B", "512"))
    for prec in ("default", "high", "highest"):
        def syrk(k, prec=prec):
            col = jax.lax.dynamic_slice(k, (0, 0), (N, b))
            return k - jnp.matmul(col, col.T, precision=prec,
                                  preferred_element_type=jnp.float32)
        timeit(f"syrk f32 {prec} (N,{b})x({b},N)", jax.jit(syrk), make_k,
               flops=2 * N * N * b)
    def syrk_bf16(k):
        col = jax.lax.dynamic_slice(k, (0, 0), (N, b)).astype(jnp.bfloat16)
        return k - jnp.matmul(col, col.T,
                              preferred_element_type=jnp.float32)
    timeit(f"syrk bf16 (N,{b})x({b},N)", jax.jit(syrk_bf16), make_k,
           flops=2 * N * N * b)

if "chol_xla" in ops:
    timeit("chol_xla", jax.jit(jnp.linalg.cholesky), make_k,
           flops=N**3 / 3)

if "chol_blocked" in ops:
    from gpras_tpu.ops.block_cholesky import blocked_cholesky
    for b in (512, 1024):
        timeit(f"chol_blocked b={b}", lambda k, b=b: blocked_cholesky(k, b),
               make_k, flops=N**3 / 3)

if "chol_super" in ops:
    from gpras_tpu.ops.block_cholesky import super_cholesky
    w = int(os.environ.get("W", "4096"))
    strip = int(os.environ.get("STRIP", "8192"))
    for prec in ("default", "high", "highest"):
        timeit(f"chol_super w={w} strip={strip} prec={prec}",
               lambda k, prec=prec: super_cholesky(k, w, strip, prec),
               make_k, flops=N**3 / 3)

if "trsm" in ops:
    m = int(os.environ.get("M", "2048"))
    def trsm(k):
        l = jnp.tril(k)
        rhs = jax.lax.dynamic_slice(k, (0, 0), (N, m))
        return jax.scipy.linalg.solve_triangular(l, rhs, lower=True)
    timeit(f"trsm (N,N)\\(N,{m})", jax.jit(trsm), make_k, flops=N * N * m)

if "kmv" in ops:
    from gpras_tpu.gp.exact_cg import kmv
    from gpras_tpu.ops import fused
    d = 8
    rr = int(os.environ.get("RHS", "128"))
    params = {"log_variance": jnp.zeros(()), "log_lengthscales": jnp.zeros((d,))}

    def make_xv(key):
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, (N, d), jnp.float32),
                jax.random.normal(k2, (N, rr), jnp.float32))

    # flops: distance build 2*N*N*d + the contraction 2*N*N*R
    timeit(f"fused kmv (N={N}, R={rr})",
           jax.jit(lambda xv: fused.kmv("Matern52", params, *xv)), make_xv,
           flops=2 * N * N * (d + rr))
    with fused.plain_xla():
        timeit(f"xla panel-loop kmv (N={N}, R={rr})",
               jax.jit(lambda xv: kmv("Matern52", params, *xv, 0.0)),
               make_xv, flops=2 * N * N * (d + rr))

if "gram" in ops:
    from gpras_tpu.ops import kernels as K
    d = 8
    def gram(key):
        x = jax.random.normal(key, (N, d), jnp.float32)
        return x
    params = {"log_variance": jnp.zeros(()),
              "log_lengthscales": jnp.zeros((d,))}
    timeit(f"gram matern52 ({N},{N})",
           jax.jit(lambda x: K.gram("Matern52", params, x)), gram,
           flops=2 * N * N * d)

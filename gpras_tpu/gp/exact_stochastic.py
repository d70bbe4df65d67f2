"""Stochastic-trace (Hutchinson) backward for the exact-GP NLML at large N.

The exact gradient needs tr(K^{-1} dK/dtheta), which costs a full O(N^3)
inverse reconstruction per step (gp/exact_lean.py). The BBMM/GPyTorch insight
(PAPERS.md: Gardner et al., "Blackbox Matrix-Matrix Gaussian Process
Inference") is that Adam-style optimizers tolerate an unbiased estimate:

    tr(K^{-1} dK) ~= (1/m) sum_i (K^{-1} z_i)^T dK z_i,   z_i Rademacher

With the factor already computed, the whole backward becomes:
- one (N, m) triangular solve   (W = K^{-1} Z),
- one pass over Gram tiles, contracting each tile against the **rank-(m+1)**
  cotangent  0.5 g [ (1/m) W Z^T - alpha alpha^T ]  assembled tile-by-tile.

Cost: O(N^2 (m + panel)) — for m = 16 probes that is ~1-2 extra Gram passes
instead of the O(N^3) inverse, which turns the backward from the dominant cost
into a rounding error on top of the forward Cholesky.

Loss values stay exact (logdet comes from the factor's diagonal); only the
trace term of the gradient is stochastic. Pass a fresh PRNG key per step for
unbiased noise; a fixed key gives deterministic (biased-like SAA) behavior.
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp

from gpras_tpu.gp.exact_cg import _cotangent_grads
from gpras_tpu.gp.priors import log_prior
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg

Array = jax.Array


def make_hutchinson_nlml(kernel: str, probes: int = 16, col_panel: int = 4096,
                         chol: str = "xla", chol_w: int = 2048,
                         chol_strip: int = 16384,
                         chol_precision: str | None = None):
    """Returns ``nlml(params, x, y, key)`` with the stochastic backward.

    ``chol`` picks the factorization/solve engine:
    - ``"xla"``: jnp.linalg.cholesky — fastest compile at small/moderate N,
      but it keeps separate K and L buffers and its compile time grows
      with N.
    - ``"super"``: ops.block_cholesky.super_cholesky (shrinking static
      trailing updates, in place, flat compile cost) + flat-compile panel
      solves. The large-N configuration. ``chol_precision`` sets the
      precision of its matmuls; the default (None) follows the package
      policy (gpras_tpu.__init__), which keeps f32-equivalent products.
    - ``"blocked"``: ops.block_cholesky.blocked_cholesky (fori_loop masked
      full-width updates) — kept for tiny-HLO debugging.

    The backward is exact_cg._cotangent_grads: the fused Pallas
    contraction where ops/fused.use_fused holds, the Gram-vjp panel loop
    otherwise.
    """

    if chol == "super":
        from gpras_tpu.ops.block_cholesky import (blocked_cho_solve, fit_block,
                                                  super_cholesky)
        # zero_upper=False: the tril is a second (N, N) buffer; the panel
        # solves and diag logdet below never read above the diagonal.
        # fit_block: the panel width must divide N (arbitrary event counts);
        # worst case w == N degenerates to one direct small factorization.
        chol_fn = lambda k: super_cholesky(
            k, fit_block(k.shape[0], chol_w), chol_strip,
            chol_precision, zero_upper=False)
        solve_fn = lambda l, r: blocked_cho_solve(l, r, 512)
    elif chol == "blocked":
        from gpras_tpu.ops.block_cholesky import (blocked_cho_solve,
                                                  blocked_cholesky, fit_block)
        chol_fn = lambda k: blocked_cholesky(k, fit_block(k.shape[0], chol_w))
        solve_fn = lambda l, r: blocked_cho_solve(l, r, 512)
    else:
        chol_fn = jnp.linalg.cholesky
        solve_fn = linalg.cho_solve

    def forward(params, x, y):
        n = x.shape[0]
        noise = jnp.exp(params["log_noise_variance"])
        jitter = linalg.default_jitter(x.dtype) * jnp.exp(params["log_variance"])
        k = K.gram(kernel, params, x)
        k = k + (noise + jitter) * jnp.eye(n, dtype=k.dtype)
        l = chol_fn(k)
        alpha = solve_fn(l, y[:, None])[:, 0]
        quad = 0.5 * jnp.vdot(y, alpha)
        logdet = linalg.logdet_from_chol(l)
        return quad + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi), (l, alpha)

    @jax.custom_vjp
    def nlml(params, x, y, key):
        return forward(params, x, y)[0]

    def fwd(params, x, y, key):
        out, (l, alpha) = forward(params, x, y)
        return out, (params, x, y, key, l, alpha)

    def bwd(res, g):
        params, x, y, key, l, alpha = res
        # upstream weak-f64 arithmetic on the loss (e.g. optax's zoom
        # linesearch under jax_enable_x64) can deliver a promoted cotangent;
        # the engine computes in the data dtype
        g = jnp.asarray(g, x.dtype)
        z = jax.random.rademacher(key, (x.shape[0], probes), dtype=x.dtype)
        w = solve_fn(l, z)  # (N, m): K^{-1} Z
        grads = _cotangent_grads(kernel, params, x, alpha, w, z, g,
                                 1.0 / probes, col_panel)
        return grads, jnp.zeros_like(x), g * alpha, None

    nlml.defvjp(fwd, bwd)
    return nlml


def make_hutchinson_training_loss(kernel: str, probes: int = 16,
                                  col_panel: int = 4096, **chol_kwargs):
    nlml = make_hutchinson_nlml(kernel, probes, col_panel, **chol_kwargs)

    def loss(params, x, y, key):
        return nlml(params, x, y, key) - log_prior(params)

    return loss


def default_chol_config(n: int) -> dict:
    """The factorization knobs for problem size ``n`` — the SINGLE source
    of truth shared by GPRAS._loss_fn, gp.coldfit, and bench.py.

    The in-place super-panel engine above 16k (XLA's cholesky keeps
    separate K and L buffers and its compile time grows with N); wide
    (w=2048, strip=16384) panels up to 32k, narrow (w=512, strip=2048)
    panels above, where the strip temporaries are O(N * strip) next to an
    (N, N) factor that already fills much of the device.
    """
    return {
        "chol": "super" if n > 16384 else "xla",
        "chol_strip": 16384 if n <= 32768 else 2048,
        "chol_w": 2048 if n < 32768 else 512,
    }


#: device bytes a dense exact engine needs per Gram entry. The compiled
#: Hutchinson value-and-gradient program holds two (N, N) f32 buffers (the
#: Gram and its factor: temporaries of 2.000 x 4 N^2 bytes at N=49,152 on an
#: H100, for narrow and wide panels alike), i.e. 8 bytes; one more byte
#: leaves room for the strips, the probes and the data
DENSE_BYTES_PER_ENTRY = 9


def device_bytes_limit() -> int:
    """Bytes the default device grants this process:
    ``memory_stats()["bytes_limit"]`` on an accelerator; the host's physical
    memory on the CPU, which reports no limit of its own."""
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def dense_n_max(bytes_limit: int | None = None) -> int:
    """Largest N the dense (factorizing) exact engines fit on one device:
    ``DENSE_BYTES_PER_ENTRY * N^2 <= bytes_limit``. Above it the exact
    backend goes matrix-free (gp/exact_cg.py), which stores no (N, N)
    buffer at all."""
    if bytes_limit is None:
        bytes_limit = device_bytes_limit()
    return math.isqrt(bytes_limit // DENSE_BYTES_PER_ENTRY)

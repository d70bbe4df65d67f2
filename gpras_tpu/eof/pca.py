"""PCA/EOF decomposition on device, replacing sklearn's (Incremental)PCA.

The reference fits ``IncrementalPCA`` on the centered, area-weighted wet-cell
field (gpras/preprocess.py:989-990) and on the precip grid
(gpras/preprocess.py:1235). Outputs consumed downstream are ``components_``,
``explained_variance_`` and ``n_samples_seen_`` (gpras/preprocess.py:1000-1002).

On device: instead of an SVD of the (samples, cells) matrix we eigendecompose
the smaller Gram side — for cells >> samples that is the (S, S) sample Gram
``x x^T`` (one matmul + small eigh), and the spatial EOFs come back via one
(C, S) @ (S, k) matmul. This scales to very large cell counts with O(S^2) device
memory for the decomposition; the sharded multi-chip variant lives in
``gpras_tpu.parallel.ppca``.

Sign convention: like sklearn's ``svd_flip``, each component's largest-|loading|
entry is made positive, so results are comparable across backends.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


@partial(jax.jit, static_argnums=(1,))
def pca_fit(x: Array, n_components: int | None = None) -> tuple[Array, Array]:
    """PCA of pre-centered ``x`` (samples, features).

    Returns (components (k, features), explained_variance (k,)) with
    ``explained_variance = eigenvalue / (n_samples - 1)`` (sklearn convention).
    ``n_components`` defaults to min(S, F) (all of them).
    """
    s, f = x.shape
    k = min(s, f) if n_components is None else min(n_components, min(s, f))
    if s <= f:
        # Gram trick: eigh of (S, S) sample Gram
        g = jnp.matmul(x, x.T, preferred_element_type=x.dtype)
        evals, evecs = jnp.linalg.eigh(g)  # ascending
        evals = evals[::-1][:k]
        u = evecs[:, ::-1][:, :k]  # (S, k)
        sigma = jnp.sqrt(jnp.maximum(evals, 1e-30))
        comps = (x.T @ (u / sigma[None, :])).T  # (k, F): V^T rows
        # centered input always has a ~0 eigenvalue (the ones direction);
        # dividing that column by sqrt(~0) would amplify float noise into a
        # garbage "component" — zero such rows instead (their explained
        # variance is ~0, so downstream mode selection drops them anyway)
        rank_ok = evals > 1e-12 * jnp.maximum(evals[0], 1e-30)
        comps = jnp.where(rank_ok[:, None], comps, 0.0)
    else:
        # covariance trick: eigh of (F, F)
        c = jnp.matmul(x.T, x, preferred_element_type=x.dtype)
        evals, evecs = jnp.linalg.eigh(c)
        evals = evals[::-1][:k]
        comps = evecs[:, ::-1][:, :k].T  # (k, F)
    explained = jnp.maximum(evals, 0.0) / (s - 1)
    # svd_flip sign convention: largest-|entry| positive per component
    idx = jnp.argmax(jnp.abs(comps), axis=1)
    signs = jnp.sign(comps[jnp.arange(comps.shape[0]), idx])
    signs = jnp.where(signs == 0, 1.0, signs)
    return comps * signs[:, None], explained


def pca_fit_reference(x, n_components: int | None = None):
    """Pure-numpy mirror of :func:`pca_fit` (same Gram/covariance trick, same
    rank guard and sign convention) — the host path for sub-threshold inputs
    (see eof.preprocessor) and the CPU test reference.

    Every distinct jitted program pays a compile and dispatch overhead; for
    the small matrices of a typical project-fitting session that overhead
    dwarfs the math, so tiny decompositions stay on the host.
    """
    import numpy as np

    x = np.asarray(x)
    s, f = x.shape
    k = min(s, f) if n_components is None else min(n_components, min(s, f))
    if s <= f:
        g = x @ x.T
        evals, evecs = np.linalg.eigh(g)
        evals = evals[::-1][:k]
        u = evecs[:, ::-1][:, :k]
        sigma = np.sqrt(np.maximum(evals, 1e-30))
        comps = (x.T @ (u / sigma[None, :])).T
        rank_ok = evals > 1e-12 * max(float(evals[0]) if k else 0.0, 1e-30)
        comps = np.where(rank_ok[:, None], comps, 0.0)
    else:
        c = x.T @ x
        evals, evecs = np.linalg.eigh(c)
        evals = evals[::-1][:k]
        comps = evecs[:, ::-1][:, :k].T
    explained = np.maximum(evals, 0.0) / (s - 1)
    idx = np.argmax(np.abs(comps), axis=1)
    signs = np.sign(comps[np.arange(comps.shape[0]), idx])
    signs = np.where(signs == 0, 1.0, signs)
    return comps * signs[:, None], explained

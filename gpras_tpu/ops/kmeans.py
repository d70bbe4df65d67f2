"""Jitted k-means (k-means++ seeding + Lloyd iterations) and grid inducing init.

Replaces the reference's inducing-point initializers (gpras/gpr.py:310-320):
``kmeans`` used sklearn's C implementation (KMeans(random_state=0, n_init="auto"),
gpras/gpr.py:312-315); ``grid`` builds a per-feature linspace between the feature
min and max (gpras/gpr.py:316-320 — note this is a stacked per-dimension linspace,
i.e. M points along the "diagonal" of the bounding box, not a mesh; we reproduce
that exact behavior).

On device: the assignment step is one matmul (pairwise distances in matmul
form) and the update step is a segment-sum; the whole Lloyd loop is a
``lax.while_loop`` in one jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


def _pairwise_sqdist(x: Array, c: Array) -> Array:
    x2 = jnp.sum(x * x, axis=1)[:, None]
    c2 = jnp.sum(c * c, axis=1)[None, :]
    return jnp.maximum(x2 + c2 - 2.0 * jnp.matmul(x, c.T, preferred_element_type=x.dtype), 0.0)


def _kmeans_pp_init(key: Array, x: Array, k: int) -> Array:
    """k-means++ seeding: sample centers proportional to squared distance."""
    n = x.shape[0]
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(x[first])
    d2 = _pairwise_sqdist(x, centers[:1])[:, 0]

    def body(i, carry):
        key, centers, d2 = carry
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-30)
        idx = jax.random.choice(sub, n, p=probs)
        centers = centers.at[i].set(x[idx])
        d2 = jnp.minimum(d2, _pairwise_sqdist(x, x[idx][None, :])[:, 0])
        return key, centers, d2

    _, centers, _ = jax.lax.fori_loop(1, k, body, (key, centers, d2))
    return centers


@partial(jax.jit, static_argnums=(1, 2))
def kmeans(
    x: Array, k: int, max_iter: int = 300, seed: int = 0
) -> tuple[Array, Array]:
    """Lloyd's algorithm; returns (centers (k, D), assignments (N,)).

    Deterministic for a given seed (the reference fixes random_state=0,
    gpras/gpr.py:313). Empty clusters keep their previous center.
    """
    key = jax.random.PRNGKey(seed)
    centers0 = _kmeans_pp_init(key, x, k)

    def assign(centers):
        return jnp.argmin(_pairwise_sqdist(x, centers), axis=1)

    def update(labels, centers):
        one_hot = jax.nn.one_hot(labels, k, dtype=x.dtype)  # (N, k)
        counts = jnp.sum(one_hot, axis=0)  # (k,)
        sums = one_hot.T @ x  # (k, D)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new, centers)

    def cond(state):
        i, centers, labels, changed = state
        return jnp.logical_and(i < max_iter, changed)

    def body(state):
        i, centers, labels, _ = state
        new_centers = update(labels, centers)
        new_labels = assign(new_centers)
        changed = jnp.any(new_labels != labels)
        return i + 1, new_centers, new_labels, changed

    labels0 = assign(centers0)
    _, centers, labels, _ = jax.lax.while_loop(
        cond, body, (0, centers0, labels0, jnp.asarray(True))
    )
    return centers, labels


def grid_inducing(x: Array, n_inducing: int) -> Array:
    """Per-feature linspace from min to max, stacked as columns (M, D) — the exact
    construction of the reference's "grid" initializer (gpras/gpr.py:316-320)."""
    lo = jnp.min(x, axis=0)
    hi = jnp.max(x, axis=0)
    t = jnp.linspace(0.0, 1.0, n_inducing, dtype=x.dtype)[:, None]
    return lo[None, :] + t * (hi - lo)[None, :]


def kmeans_inducing(x: Array, n_inducing: int, seed: int = 0) -> Array:
    """Inducing locations = k-means cluster centers (reference gpras/gpr.py:312-315)."""
    centers, _ = kmeans(x, n_inducing, seed=seed)
    return centers

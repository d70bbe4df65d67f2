"""Covariance-kernel zoo: pure-JAX Gram builders with ARD lengthscales.

Capability parity with the reference's ``KERNEL_FACTORY`` (reference gpras/gpr.py:21-37),
which exposes eight GPflow kernels: Matern12/32/52, RBF (SquaredExponential), Linear,
Polynomial, Periodic, Exponential.  Functional forms follow the GPflow conventions the
reference relies on:

- ``Matern12``:     k(r) = s2 * exp(-r)
- ``Matern32``:     k(r) = s2 * (1 + sqrt(3) r) exp(-sqrt(3) r)
- ``Matern52``:     k(r) = s2 * (1 + sqrt(5) r + 5/3 r^2) exp(-sqrt(5) r)
- ``RBF``:          k(r2) = s2 * exp(-r2 / 2)
- ``Exponential``:  k(r) = s2 * exp(-r / 2)
- ``Linear``:       k(x, x') = s2 * <x, x'>
- ``Polynomial``:   k(x, x') = (s2 * <x, x'> + offset) ** degree
- ``Periodic``:     k = s2 * exp(-0.5 * sum_d (2 sin(pi (x_d - x'_d) / p_d) / l_d)^2)

where ``r2 = sum_d ((x_d - x'_d) / l_d)^2`` and ``r = sqrt(r2)`` (ARD lengthscales).

Design notes:
- Everything is traceable/jittable; the scaled squared distance is computed as a
  single matmul plus rank-1 row/column norms (no (N, N, D) intermediates).
- Parameters are carried **unconstrained** (log-space) in a flat dict so optimizers
  work on a smooth domain; ``constrain``/``unconstrain`` convert.
- The matrix-free engines' Gram products have fused Pallas kernels in
  ``gpras_tpu.ops.fused``; this module is the reference implementation, and the Gram
  build itself stays plain XLA (it fuses the elementwise tail into one pass).
"""

from __future__ import annotations

import math
from typing import Any, Literal

import jax
import jax.numpy as jnp

Array = jax.Array

KernelName = Literal[
    "Matern12",
    "Matern32",
    "Matern52",
    "RBF",
    "Linear",
    "Polynomial",
    "Periodic",
    "Exponential",
]

KERNEL_NAMES: tuple[str, ...] = (
    "Matern12",
    "Matern32",
    "Matern52",
    "RBF",
    "Linear",
    "Polynomial",
    "Periodic",
    "Exponential",
)

#: Kernels whose Gram depends only on the scaled distance r (or r^2).
STATIONARY_KERNELS = ("Matern12", "Matern32", "Matern52", "RBF", "Exponential")

_R2_FLOOR = 1e-36  # keeps sqrt differentiable at coincident points


def init_params(
    kernel: str,
    dim: int,
    variance: float = 1.0,
    lengthscales: float | Array = 1.0,
    period: float = 1.0,
    offset: float = 1.0,
    degree: float = 3.0,
    dtype: Any = jnp.float32,
) -> dict[str, Array]:
    """Create the unconstrained (log-space) parameter dict for ``kernel``.

    Mirrors the reference's kernel construction defaults: variance=1 and
    lengthscales initialized by the caller to mean(|x|) (reference gpras/gpr.py:289-298).
    The Polynomial degree is a static (non-trainable) structural constant, matching
    GPflow's non-trainable default degree=3.
    """
    _check_kernel(kernel)
    ls = jnp.broadcast_to(jnp.asarray(lengthscales, dtype=dtype), (dim,))
    params: dict[str, Array] = {"log_variance": jnp.asarray(math.log(variance), dtype=dtype)}
    if kernel in STATIONARY_KERNELS or kernel == "Periodic":
        params["log_lengthscales"] = jnp.log(ls)
    if kernel == "Periodic":
        params["log_period"] = jnp.broadcast_to(
            jnp.asarray(math.log(period), dtype=dtype), (dim,)
        )
    if kernel == "Polynomial":
        params["log_offset"] = jnp.asarray(math.log(offset), dtype=dtype)
        params["degree"] = jnp.asarray(degree, dtype=dtype)
    return params


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"Unknown kernel {kernel!r}; expected one of {KERNEL_NAMES}")


def constrain(params: dict[str, Array]) -> dict[str, Array]:
    """Map unconstrained (log-space) params to their positive/constrained values."""
    out = {}
    for k, v in params.items():
        if k.startswith("log_"):
            out[k[4:]] = jnp.exp(v)
        else:
            out[k] = v
    return out


def unconstrain(params: dict[str, Array]) -> dict[str, Array]:
    """Inverse of :func:`constrain`."""
    out = {}
    for k, v in params.items():
        if k == "degree":
            out[k] = v
        else:
            out["log_" + k] = jnp.log(v)
    return out


def scaled_sqdist(x1: Array, x2: Array, lengthscales: Array) -> Array:
    """Pairwise squared distance of lengthscale-scaled points, shape (N1, N2).

    Computed as ||a||^2 + ||b||^2 - 2 a b^T so the O(N^2 D) work is one matmul.
    Clamped at zero (the matmul form can go slightly negative in floating point).
    """
    a = x1 / lengthscales
    b = x2 / lengthscales
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.matmul(a, b.T, preferred_element_type=a.dtype)
    r2 = a2[:, None] + b2[None, :] - 2.0 * ab
    return jnp.maximum(r2, 0.0)


def _safe_r(r2: Array) -> Array:
    return jnp.sqrt(jnp.maximum(r2, _R2_FLOOR))


def _stationary_from_r2(kernel: str, variance: Array, r2: Array) -> Array:
    if kernel == "RBF":
        return variance * jnp.exp(-0.5 * r2)
    r = _safe_r(r2)
    if kernel == "Matern12":
        return variance * jnp.exp(-r)
    if kernel == "Matern32":
        s3r = math.sqrt(3.0) * r
        return variance * (1.0 + s3r) * jnp.exp(-s3r)
    if kernel == "Matern52":
        s5r = math.sqrt(5.0) * r
        return variance * (1.0 + s5r + (5.0 / 3.0) * r2) * jnp.exp(-s5r)
    if kernel == "Exponential":
        return variance * jnp.exp(-0.5 * r)
    raise ValueError(f"{kernel} is not stationary")


def gram(kernel: str, params: dict[str, Array], x1: Array, x2: Array | None = None) -> Array:
    """Full covariance (Gram) matrix K(x1, x2) of shape (N1, N2).

    ``params`` are unconstrained (log-space), see :func:`init_params`.
    """
    _check_kernel(kernel)
    if x2 is None:
        x2 = x1
    variance = jnp.exp(params["log_variance"])
    if kernel in STATIONARY_KERNELS:
        ls = jnp.exp(params["log_lengthscales"])
        r2 = scaled_sqdist(x1, x2, ls)
        return _stationary_from_r2(kernel, variance, r2)
    if kernel == "Linear":
        return variance * jnp.matmul(x1, x2.T, preferred_element_type=x1.dtype)
    if kernel == "Polynomial":
        offset = jnp.exp(params["log_offset"])
        base = variance * jnp.matmul(x1, x2.T, preferred_element_type=x1.dtype) + offset
        return base ** params["degree"]
    if kernel == "Periodic":
        ls = jnp.exp(params["log_lengthscales"])
        period = jnp.exp(params["log_period"])
        # sum_d (2 sin(pi dx_d / p_d) / l_d)^2 needs per-dim differences; done as a
        # scan-free broadcast only over D (small), never materializing (N1, N2, D)
        # beyond one (N1, N2) accumulator per dim via fori_loop.
        d = x1.shape[-1]

        def body(i, acc):
            dx = x1[:, i][:, None] - x2[:, i][None, :]
            s = jnp.sin(jnp.pi * dx / period[i]) / ls[i]
            return acc + 4.0 * s * s

        r2 = jax.lax.fori_loop(0, d, body, jnp.zeros((x1.shape[0], x2.shape[0]), x1.dtype))
        return variance * jnp.exp(-0.5 * r2)
    raise AssertionError("unreachable")


def kdiag(kernel: str, params: dict[str, Array], x: Array) -> Array:
    """Diagonal of K(x, x), shape (N,) — avoids building the full Gram."""
    _check_kernel(kernel)
    variance = jnp.exp(params["log_variance"])
    n = x.shape[0]
    if kernel in STATIONARY_KERNELS or kernel == "Periodic":
        return jnp.full((n,), variance, dtype=x.dtype)
    if kernel == "Linear":
        return variance * jnp.sum(x * x, axis=-1)
    if kernel == "Polynomial":
        offset = jnp.exp(params["log_offset"])
        return (variance * jnp.sum(x * x, axis=-1) + offset) ** params["degree"]
    raise AssertionError("unreachable")


def trainable_param_names(kernel: str) -> tuple[str, ...]:
    """Unconstrained parameter names optimized during fitting.

    The Polynomial ``degree`` is structural (GPflow default: not trainable).
    """
    _check_kernel(kernel)
    if kernel in STATIONARY_KERNELS:
        return ("log_variance", "log_lengthscales")
    if kernel == "Linear":
        return ("log_variance",)
    if kernel == "Polynomial":
        return ("log_variance", "log_offset")
    if kernel == "Periodic":
        return ("log_variance", "log_lengthscales", "log_period")
    raise AssertionError("unreachable")

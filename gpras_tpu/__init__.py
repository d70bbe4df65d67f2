"""gpras_tpu — a JAX framework for GP surrogate modeling of HEC-RAS floods.

A ground-up rebuild of the capability set of ``fema-ffrd/gpras`` (see SURVEY.md):
HEC-RAS/HEC-HMS data extraction, EOF/PCA spatial reduction, multi-output exact and
sparse Gaussian-process regression, posterior prediction with variance propagation,
a flood-verification metric suite, config-driven pipelines, and cross-validation —
with the compute core designed for an accelerator:

- fused Pallas kernels for the matrix-free Gram products and a blocked
  in-place Cholesky (``ops/``),
- custom-VJP log-marginal-likelihood so hyperparameter optimization is fully
  jitted (``gp/``), with vmapped per-EOF-mode latent GPs,
- a jitted optimizer zoo (Adam with early stop, L-BFGS, staged schedules,
  vmapped multi-start and differential evolution) (``fit/``),
- 2-D sharded Gram + distributed blocked Cholesky via ``shard_map`` for
  N>=100k training points (``parallel/``).

Host-side I/O (HEC-RAS HDF5, flow/plan text files, parquet DBs) stays on CPU in
``data/``; orchestration lives in ``pipeline/``.
"""

__version__ = "0.1.0"


#: package matmul precision: full float32 products. On an NVIDIA GPU,
#: "high" lowers float32 dots to TF32 (10-bit mantissa), which is too coarse
#: for the kernel matrices' squared distances and the blocked Cholesky's
#: Schur updates; "highest" keeps every product f32-accurate.
MATMUL_PRECISION = "highest"


def _set_numerics_policy() -> None:
    """Default every matmul to ``MATMUL_PRECISION``.

    The package's numeric sites pass no ``precision=`` of their own, so this
    one setting governs them all. A value already set before import is
    respected, and a user may re-set ``jax_default_matmul_precision`` after
    importing gpras_tpu.
    """
    import logging

    import jax

    try:
        if jax.config.jax_default_matmul_precision is None:
            jax.config.update("jax_default_matmul_precision",
                              MATMUL_PRECISION)
            # process-global change: make it discoverable for co-resident
            # JAX code that didn't ask for it
            logging.getLogger(__name__).debug(
                "gpras_tpu set jax_default_matmul_precision=%r",
                MATMUL_PRECISION)
    except Exception as exc:  # noqa: BLE001
        # never block `import gpras_tpu` over a numerics preference (a jax
        # version may lack the knob or reject the value) — but leave a trail
        logging.getLogger(__name__).debug(
            "matmul precision policy not applied: %r", exc)


_set_numerics_policy()

__all__ = ["GPRAS", "PreProcessor", "HmsPreProcessor", "__version__"]

_LAZY = {
    "GPRAS": ("gpras_tpu.gp.model", "GPRAS"),
    "PreProcessor": ("gpras_tpu.eof.preprocessor", "PreProcessor"),
    "HmsPreProcessor": ("gpras_tpu.eof.preprocessor", "HmsPreProcessor"),
}


def __getattr__(name):
    # Lazy top-level exports keep `import gpras_tpu` light (no JAX compile on import).
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

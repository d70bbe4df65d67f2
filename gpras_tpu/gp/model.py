"""GPRAS: the high-level multi-output GP model (API parity with the reference).

Reference surface (gpras/gpr.py:217-384): ``GPRAS(kernel)`` with
``fit(x, y, n_inducing, inducing_initializer, optimization_method, **opt_kwargs)``,
``predict(x) -> (means, variances)``, ``to_file``/``from_file``.

Redesign for an accelerator:
- The reference trains **one GPflow SGPR per EOF mode in a serial Python loop**
  (gpras/gpr.py:272-274) and predicts mode-by-mode (gpras/gpr.py:336-339). Here the
  per-mode parameters are a **batched pytree** (leading axis = mode) and fit/predict
  are ``jax.vmap`` of a single jitted program — all modes train and predict
  simultaneously on one device.
- ``model_type="exact"`` adds a dense exact-GP backend (no inducing points) with a
  custom-VJP NLML — the reference has no exact-GP path; this is BASELINE.json's
  headline config.
- ``model_type="svgp"`` adds the minibatch (uncollapsed-bound) sparse backend
  (gp/svgp.py) — unbounded N at O(M^2) memory; fit knobs ``batch_size``,
  ``epochs``, ``learning_rate``, ``seed``; the reference has no streaming path.
- After ``fit`` the posterior factors are **precomputed once** (Cholesky factors and
  projected targets), so batched prediction over thousands of storm-event timesteps
  is matmul-only — the "storm-event predictions/sec" metric surface.
- Serialization is a structured npz (no pickle), keeping the reference's
  save -> load -> predict flow (production/analysis/pipeline.py:254-255).
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Any, Literal, Self

import jax
import jax.numpy as jnp
import numpy as np

from gpras_tpu.fit import optimizers as fitters
from gpras_tpu.gp import exact as exact_gp
from gpras_tpu.gp import sgpr, svgp, warmstart
from gpras_tpu.gp.exact_stochastic import dense_n_max
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import kmeans as km
from gpras_tpu.ops import linalg
from gpras_tpu.utils.serialization import load_artifact, save_artifact

Array = jax.Array

KernelType = K.KernelName
OptimizerType = Literal[
    "two-stage", "three-stage", "adam", "adadelta", "L-BFGS-B",
    "stochastic", "diffential_evolution", "differential_evolution",
]
InductionInitializerType = Literal["kmeans", "grid"]
ModelBackendType = Literal["sgpr", "svgp", "exact"]


@partial(jax.jit, static_argnums=(0,))
def _sgpr_posterior_cache(kernel: str, params: dict[str, Array], x: Array, y: Array):
    """Per-mode cached factors for fast repeated prediction: (L, LB, c)."""
    sigma, sigma2, l, a, lb = sgpr._common(kernel, params, x)
    c = linalg.solve_triangular(lb, a @ y[:, None], lower=True)[:, 0] / sigma
    return l, lb, c


@partial(jax.jit, static_argnums=(0,))
def _sgpr_predict_from_cache(kernel: str, params: dict[str, Array],
                             cache: tuple[Array, Array, Array], x_test: Array):
    l, lb, c = cache
    kus = K.gram(kernel, params, params["z"], x_test)
    tmp1 = linalg.solve_triangular(l, kus, lower=True)
    tmp2 = linalg.solve_triangular(lb, tmp1, lower=True)
    mean = tmp2.T @ c
    var = K.kdiag(kernel, params, x_test) - jnp.sum(tmp1 * tmp1, axis=0) + jnp.sum(tmp2 * tmp2, axis=0)
    var = jnp.maximum(var, 0.0) + jnp.exp(params["log_noise_variance"])
    return mean, var


@partial(jax.jit, static_argnums=(0,))
def _exact_posterior_cache(kernel: str, params: dict[str, Array], x: Array, y: Array):
    kmat = exact_gp.build_train_gram(kernel, params, x)
    # noise variance is already on the diagonal; escalate jitter only on NaN
    l = linalg.safe_cholesky(kmat, jitter=0.0)
    alpha = linalg.cho_solve(l, y[:, None])[:, 0]
    return l, alpha


@partial(jax.jit, static_argnums=(0,))
def _exact_predict_from_cache(kernel: str, params: dict[str, Array],
                              cache: tuple[Array, Array], x_train: Array, x_test: Array):
    l, alpha = cache
    ks = K.gram(kernel, params, x_test, x_train)
    mean = ks @ alpha
    v = linalg.solve_triangular(l, ks.T, lower=True)
    var = K.kdiag(kernel, params, x_test) - jnp.sum(v * v, axis=0)
    var = jnp.maximum(var, 0.0) + jnp.exp(params["log_noise_variance"])
    return mean, var


class GPRAS:
    """Multi-output GP for HEC-RAS upskilling/emulation (reference gpras/gpr.py:217)."""

    def __init__(
        self,
        kernel: KernelType,
        model_type: ModelBackendType = "sgpr",
        dtype: Any = jnp.float32,
        exact_engine: str = "auto",
    ) -> None:
        """``exact_engine`` picks the exact-GP training loss ("auto" scales
        with N: dense custom-VJP -> panel-scan lean backward (>8k) ->
        Hutchinson stochastic-trace over the in-place super-panel
        factorization (>16k) -> matrix-free batched-CG BBMM (>55k, no (N,N)
        buffer at all). Explicit values: "dense", "lean", "hutchinson",
        "cg". Ignored for the sparse backend."""
        if kernel not in K.KERNEL_NAMES:
            raise ValueError(f"Unknown kernel {kernel!r}")
        if model_type not in ("sgpr", "svgp", "exact"):
            raise ValueError(f"Unknown model_type {model_type!r}; "
                             "expected 'sgpr', 'svgp' or 'exact'")
        if exact_engine not in ("auto", "dense", "lean", "hutchinson", "cg"):
            raise ValueError(f"Unknown exact_engine {exact_engine!r}")
        self.kernel_str: str = kernel
        self.model_type: str = model_type
        self.exact_engine: str = exact_engine
        self.dtype = dtype
        self.params: dict[str, Array] | None = None  # batched: leading axis = mode
        self.fit_info: dict[str, Array] | None = None
        self.warm_start_info: dict[str, Any] | None = None
        self.x: Array | None = None
        self.y: Array | None = None
        self.n_inducing: int = 0
        self._cache: tuple[Array, ...] | None = None

    # ------------------------------------------------------------------ fitting

    def fit(
        self,
        x: np.ndarray | Array,
        y: np.ndarray | Array,
        n_inducing: int = 0,
        inducing_initializer: InductionInitializerType = "kmeans",
        optimization_method: OptimizerType = "two-stage",
        initial_params: dict[str, Array] | None = None,
        warm_start_subsample: int = 0,
        mesh: Any = None,
        **opt_kwargs: Any,
    ) -> None:
        """Fit one latent GP per output column of ``y``, all modes vmapped.

        Mirrors the reference's signature and defaults (gpras/gpr.py:237-275);
        ``n_inducing`` is ignored for the exact backend.

        ``mesh`` routes the exact backend's fit through the DISTRIBUTED
        engine ladder (parallel/pexact dense/hutchinson, parallel/pcg above
        the dense per-mesh ceiling) — the one-call multi-chip fit extending
        the reference's single-call contract (gpras/gpr.py:237). Accepts a
        ``jax.sharding.Mesh`` (axes "i" or ("i", "j"); 2-D meshes run the
        P(i, j) engine via ``pexact.resolve_layout``) or ``"auto"`` to build
        the largest 2-D mesh over every visible device. Checkpoint format is
        unchanged: hyperparameters come back replicated and ``to_file`` /
        ``from_file`` / ``predict`` work exactly as for a single-chip fit.
        Distributed knobs (all optional, via ``**opt_kwargs``):
        ``dist_block`` (Cholesky block size), ``probes`` (stochastic-trace /
        SLQ probes), ``cg_iters``, ``precond_rank``.

        ``initial_params`` warm-starts the optimization from a batched
        per-mode parameter pytree — e.g. ``model.params`` of a previous fit
        or of a checkpoint loaded with ``from_file`` — enabling resumed /
        staged training across sessions (the reference's monolithic optimizer
        runs have no equivalent).

        ``warm_start_subsample`` (exact backend) first runs the SAME
        optimization on a uniform subsample of that size, then starts the
        full-N fit from the subsample optimum. At N=49k the warm-started fit
        opens BELOW the loss 600 cold full-N Adam steps reach, and converges
        (reference early-stop semantics) in ~250 steps where the cold fit
        had not converged by 600 — subsampled hyperparameter surfaces are
        near-identical at a fraction of the per-step cost.

        The float32 transfer is routed through the warm-start protocol
        (gp/warmstart.py): the rung's kernel variance is clamped to
        ``warm_ratio_cap`` x noise (default 50 — the measured f32
        feasibility envelope at 49k; a subsample over-inflates the variance
        along the flat var-vs-nuisance-lengthscale NLML ridge and an
        unclamped transfer NaNs the full-N factorization), then ONE forward
        NLML evaluation per mode certifies the clamped parameters, halving
        the cap until feasible or falling back to standard init for that
        mode. ``self.warm_start_info`` records the per-mode caps/cert
        losses. The full-N fit from the certified parameters is the polish
        stage — it stops by the reference's own early-stop rule.
        """
        if self.model_type in ("sgpr", "svgp") and n_inducing <= 0:
            raise ValueError("sparse backends require n_inducing > 0 "
                             "(use model_type='exact' for a dense GP)")
        if mesh is not None and self.model_type != "exact":
            raise ValueError(
                "mesh-distributed fitting supports model_type='exact' (the "
                "distributed engine ladder); for data-parallel SVGP use "
                "parallel/psvgp.py, for sharded hyperparameter search "
                "parallel/pfit.py")
        if optimization_method not in fitters.FITTERS:
            raise ValueError(
                f"Unknown optimizer {optimization_method!r}; expected one of "
                f"{sorted(fitters.FITTERS)}")
        # invalidate BEFORE mutating: a fit that raises mid-way must not
        # leave stale posterior factors paired with the new training data
        self._cache = None
        self.params = None
        self.fit_info = None
        self.x = jnp.asarray(x, dtype=self.dtype)
        self.y = jnp.asarray(y, dtype=self.dtype)
        if self.y.ndim == 1:
            self.y = self.y[:, None]
        self.n_inducing = int(n_inducing)
        p_modes = self.y.shape[1]
        # engine closures are configured for a specific N (chol engine,
        # panel sizes); refitting with different data must rebuild them
        self._cg_loss = None
        self._hutch_loss = None
        self._lean_loss = None

        warm_ratio_cap = float(opt_kwargs.pop(
            "warm_ratio_cap", warmstart.DEFAULT_RATIO_CAP))
        self.warm_start_info = None
        if (warm_start_subsample > 0 and self.model_type == "exact"
                and initial_params is None
                and self.x.shape[0] >= 2 * warm_start_subsample):
            # ceil-division stride keeps the warm stage <= subsample points;
            # floor would silently run the warm fit on (nearly) the full set
            # for subsample < N < 2*subsample — the >= 2x gate above plus
            # ceil makes the two-stage cost model always hold
            stride = -(-self.x.shape[0] // warm_start_subsample)
            warm = GPRAS(self.kernel_str, model_type="exact",
                         dtype=self.dtype, exact_engine=self.exact_engine)
            warm.fit(self.x[::stride], self.y[::stride],
                     optimization_method=optimization_method, **opt_kwargs)
            initial_params = warm.params
            if jnp.dtype(self.dtype) == jnp.float32:
                # f32 conditioning-envelope transfer: clamp + certify the
                # rung params against the FULL-N loss before polishing
                # (gp/warmstart.py docstring has the measured failure mode)
                fallback = jax.tree.map(
                    lambda leaf: jnp.broadcast_to(
                        leaf, (p_modes,) + leaf.shape),
                    self._init_params(inducing_initializer))
                initial_params, self.warm_start_info = \
                    warmstart.certify_transfer_batched(
                        lambda p, i: self._loss_fn(p, self.y[:, i]),
                        initial_params, fallback,
                        ratio_cap=warm_ratio_cap)

        if initial_params is not None:
            lead = jax.tree.leaves(initial_params)[0].shape[0]
            if lead != p_modes:
                raise ValueError(
                    f"initial_params has {lead} modes, y has {p_modes}")
            batched0 = jax.tree.map(
                lambda leaf: jnp.asarray(leaf, self.dtype), initial_params)
        else:
            params0 = self._init_params(inducing_initializer)
            # broadcast identical init across modes (leading axis = mode)
            batched0 = jax.tree.map(
                lambda leaf: jnp.broadcast_to(leaf, (p_modes,) + leaf.shape),
                params0)

        if mesh is not None:
            self._fit_distributed(mesh, batched0, optimization_method,
                                  opt_kwargs)
            return

        if self.model_type == "svgp":
            # Minibatch engine: the whole per-mode fit is ONE jitted scan
            # program (gp/svgp.py make_minibatch_fit), vmapped over modes
            # with per-mode shuffle keys. The optimizer-zoo full-batch
            # fitters don't apply here — minibatch Adam is the method.
            if optimization_method != "adam":
                raise ValueError(
                    "model_type='svgp' trains with minibatch Adam; pass "
                    "optimization_method='adam' (got "
                    f"{optimization_method!r})")
            bs = int(opt_kwargs.pop("batch_size",
                                    min(4096, self.x.shape[0])))
            epochs = int(opt_kwargs.pop("epochs",
                                        opt_kwargs.pop("max_iter", 100)))
            lr = float(opt_kwargs.pop("learning_rate", 0.01))
            seed = int(opt_kwargs.pop("seed", 0))
            ng = opt_kwargs.pop("natgrad", None)
            if opt_kwargs:
                raise ValueError(
                    f"unsupported svgp fit options: {sorted(opt_kwargs)}")
            fit_fn = svgp.make_minibatch_fit(
                self.kernel_str, batch_size=bs, epochs=epochs,
                learning_rate=lr,
                natgrad=None if ng is None else float(ng))
            keys = jax.random.split(jax.random.PRNGKey(seed), p_modes)
            fitted, hist = jax.vmap(
                lambda p, y_i, k: fit_fn(p, self.x, y_i, k),
                in_axes=(0, 1, 0))(batched0, self.y, keys)
            self.params = fitted
            self.fit_info = {"losses": hist}
            from gpras_tpu.utils.profiling import log_fit_losses

            log_fit_losses(self.fit_info,
                           name=f"GPRAS[{self.kernel_str}/svgp]")
            return

        fitter = fitters.FITTERS[optimization_method]
        if optimization_method == "stochastic":
            opt_kwargs.setdefault("x", self.x)
        if (self.model_type == "exact"
                and jnp.dtype(self.dtype) == jnp.float32
                and optimization_method in ("adam", "two-stage")):
            # float32 production guards (overridable): GPyTorch-style noise
            # floor + AMP-style non-finite step rejection — without them a
            # large-N exact fit NaNs once Adam overshoots the conditioning
            # the factorization can represent
            import math

            opt_kwargs.setdefault("lower_bounds",
                                  {"log_noise_variance": math.log(1e-4)})
            opt_kwargs.setdefault("reject_nonfinite", True)
        loss = self._loss_fn

        def fit_one(params_i: dict[str, Array], y_i: Array):
            return fitter(lambda p: loss(p, y_i), params_i, **opt_kwargs)

        if self.model_type == "exact" and self.x.shape[0] > self.SUPER_THRESHOLD:
            # No vmap above SUPER_THRESHOLD, even for one mode: (a) vmap
            # would hold one (N, N) factor PER MODE simultaneously, and
            # (b) batching turns the factorization's dynamic-update-slice
            # chain into scattered updates that XLA no longer aliases
            # in place — observed as a 2x-factor OOM at N=49k with a single
            # mode. lax.map scans modes one at a time, unbatched.
            fitted, info = jax.lax.map(
                lambda args: fit_one(args[0], args[1]),
                (batched0, jnp.moveaxis(self.y, 1, 0)))
        else:
            fitted, info = jax.vmap(fit_one, in_axes=(0, 1))(batched0, self.y)
        self.params = fitted
        self.fit_info = dict(info)
        if self.model_type == "exact":
            self.fit_info["engine"] = self._single_device_engine(
                self.x.shape[0])
        self._cache = None
        if "losses" in info and "evolution" not in optimization_method:
            # DE's info["losses"] is the final population's energies, not a
            # per-step history — logging it as one would mislead
            from gpras_tpu.utils.profiling import log_fit_losses

            log_fit_losses(info, name=f"GPRAS[{self.kernel_str}/{self.model_type}]")

    #: above this N the exact backend switches to the panel-scan backward
    #: (gp/exact_lean.py) so the backward never materializes O(N^2) cotangents
    LEAN_THRESHOLD = 8192
    #: above this N the factorization also switches to the in-place
    #: super-panel engine (ops/block_cholesky.py): the XLA cholesky lowering's
    #: compile time and its separate K+L buffers are both impractical there
    SUPER_THRESHOLD = 16384
    # above exact_stochastic.dense_n_max() (derived from the device's
    # memory) even one (N, N) buffer does not fit; the loss goes
    # matrix-free (gp/exact_cg.py, batched CG + SLQ)

    @staticmethod
    def _resolve_mesh(mesh: Any):
        """A Mesh passes through; ``"auto"`` builds the largest 2-D mesh
        (axes "i", "j", di >= dj) over every visible device — 2-D because
        the P(i, j) Cholesky engine is the measured-faster default
        (parallel/pexact.resolve_layout)."""
        import math

        from jax.sharding import Mesh

        from gpras_tpu.parallel.mesh import make_mesh

        if isinstance(mesh, Mesh):
            return mesh
        if mesh == "auto":
            n_dev = len(jax.devices())
            dj = int(math.floor(math.sqrt(n_dev)))
            while dj > 1 and n_dev % dj:
                dj -= 1
            if dj > 1:
                return make_mesh((n_dev // dj, dj), ("i", "j"))
            return make_mesh((n_dev,), ("i",))
        raise TypeError(f"mesh must be a jax.sharding.Mesh or 'auto', "
                        f"got {mesh!r}")

    @staticmethod
    def _dist_block(n: int, mesh: Any) -> int:
        """Largest Cholesky block <= 128 dividing every per-axis local
        extent (the pcholesky/pcholesky2d divisibility contract)."""
        b = 128
        for size in mesh.shape.values():
            local = n // size
            while b > 8 and local % b:
                b //= 2
        return b

    def _fit_distributed(self, mesh: Any, batched0: dict[str, Array],
                         optimization_method: str,
                         opt_kwargs: dict[str, Any]) -> None:
        """One-call distributed exact-GP fit over a device mesh.

        Engine ladder (per-mesh scaling of the single-chip one): dense
        exact-backward below SUPER_THRESHOLD, Hutchinson stochastic-trace
        backward above it, matrix-free distributed CG once even the
        mesh-sharded (N, N) Gram exceeds the aggregate dense ceiling
        (dense_n_max() * sqrt(n_devices): per-device tile memory is
        N^2/n_devices). Modes run sequentially (lax.map) — each mode's
        factorization already spans every device. The SAA fixed probe key
        makes stochastic losses deterministic, so the whole optimizer zoo
        (incl. linesearch-based L-BFGS) applies unchanged.
        """
        import math

        from jax.sharding import NamedSharding, PartitionSpec as P

        from gpras_tpu.gp.priors import log_prior

        mesh = self._resolve_mesh(mesh)
        n = self.x.shape[0]
        n_dev = int(mesh.devices.size)
        for ax, size in mesh.shape.items():
            if n % size:
                raise ValueError(
                    f"N={n} must divide by mesh axis {ax!r}={size}")
        engine = self.exact_engine
        if engine == "auto":
            if n > int(dense_n_max() * math.sqrt(n_dev)):
                engine = "cg"
            elif n > self.SUPER_THRESHOLD:
                engine = "hutchinson"
            else:
                engine = "dense"
        elif engine == "lean":
            engine = "dense"  # the panel-scan backward is single-chip-only
        key = jax.random.PRNGKey(0)  # SAA: fixed probes, pure objective
        x_dev = jax.device_put(self.x, NamedSharding(mesh, P("i")))
        if engine == "cg":
            from gpras_tpu.parallel.pcg import make_dist_cg_nlml

            if len(mesh.shape) > 1:
                # the matrix-free engine shards rows over ONE axis; flatten
                # a 2-D mesh so all devices hold rows instead of replicating
                # the whole solve over "j"
                from jax.sharding import Mesh as _Mesh

                mesh = _Mesh(mesh.devices.reshape(-1), ("i",))
                if n % n_dev:
                    raise ValueError(f"N={n} must divide by the flattened "
                                     f"mesh size {n_dev} for the cg engine")
                x_dev = jax.device_put(self.x,
                                       NamedSharding(mesh, P("i")))
            _, dloss = make_dist_cg_nlml(
                mesh, self.kernel_str,
                probes=int(opt_kwargs.pop("probes", 16)),
                max_iters=int(opt_kwargs.pop("cg_iters", 32)),
                precond_rank=int(opt_kwargs.pop("precond_rank", 64)))
            opt_kwargs.pop("dist_block", None)
            loss = lambda p, y_i: dloss(p, x_dev, y_i, key)
        else:
            b = int(opt_kwargs.pop("dist_block", 0)) or \
                self._dist_block(n, mesh)
            if engine == "hutchinson":
                from gpras_tpu.parallel.pexact import make_dist_nlml_stochastic

                dnlml = make_dist_nlml_stochastic(
                    mesh, self.kernel_str, b=b,
                    probes=int(opt_kwargs.pop("probes", 16)))
                loss = lambda p, y_i: dnlml(p, x_dev, y_i, key) - log_prior(p)
            elif engine == "dense":
                from gpras_tpu.parallel.pexact import make_dist_nlml

                dnlml = make_dist_nlml(mesh, self.kernel_str, b=b)
                loss = lambda p, y_i: dnlml(p, x_dev, y_i) - log_prior(p)
            else:
                raise ValueError(f"unknown distributed engine {engine!r}; "
                                 "expected auto|dense|hutchinson|cg")
        if jnp.dtype(self.dtype) == jnp.float32 \
                and optimization_method in ("adam", "two-stage"):
            import math as _m

            opt_kwargs.setdefault("lower_bounds",
                                  {"log_noise_variance": _m.log(1e-4)})
            opt_kwargs.setdefault("reject_nonfinite", True)
        fitter = fitters.FITTERS[optimization_method]

        def fit_one(params_i: dict[str, Array], y_i: Array):
            return fitter(lambda p: loss(p, y_i), params_i, **opt_kwargs)

        fitted, info = jax.lax.map(
            lambda args: fit_one(args[0], args[1]),
            (batched0, jnp.moveaxis(self.y, 1, 0)))
        self.params = jax.tree.map(
            lambda leaf: jax.device_get(leaf), fitted)
        self.params = jax.tree.map(jnp.asarray, self.params)
        self.fit_info = dict(info)
        self.fit_info["dist_engine"] = engine
        self.fit_info["dist_mesh_shape"] = tuple(mesh.shape.values())

    def _single_device_engine(self, n: int) -> str:
        """The exact engine ``exact_engine`` resolves to at size ``n``.

        ``auto``: dense (exact grads) -> lean (exact grads, panel-scan
        backward) -> hutchinson (stochastic trace: the lean backward's
        O(N^3) inverse reconstruction costs ~10x the forward above ~16k) ->
        matrix-free cg once one (N, N) buffer no longer fits the device
        (exact_stochastic.dense_n_max)."""
        if self.exact_engine != "auto":
            return self.exact_engine
        if n > dense_n_max():
            return "cg"
        if n > self.SUPER_THRESHOLD:
            return "hutchinson"
        if n > self.LEAN_THRESHOLD:
            return "lean"
        return "dense"

    def _loss_fn(self, params: dict[str, Array], y_i: Array) -> Array:
        if self.model_type == "sgpr":
            return sgpr.training_loss(self.kernel_str, params, self.x, y_i)
        if self.model_type == "svgp":
            # full-batch bound (diagnostics / CV scoring); training itself
            # goes through the minibatch path in fit()
            return svgp.training_loss(self.kernel_str, params, self.x, y_i,
                                      self.x.shape[0])
        n = self.x.shape[0]
        engine = self._single_device_engine(n)
        if engine == "cg":
            from gpras_tpu.gp.exact_cg import make_cg_training_loss

            if getattr(self, "_cg_loss", None) is None:
                # rank-64 pivoted-Cholesky preconditioner: in f32 the rank is
                # the conditioning dial (NOT max_iters — see exact_cg
                # docstring); rank 64 keeps the SLQ logdet within a few
                # percent down to noise ~1e-2 where dense f32 chol NaNs
                self._cg_loss = make_cg_training_loss(self.kernel_str,
                                                      precond_rank=64)
            # SAA: a fixed probe set makes the objective deterministic, so
            # every optimizer in the zoo (incl. L-BFGS line searches) works.
            return self._cg_loss(params, self.x, y_i, jax.random.PRNGKey(0))
        if engine == "hutchinson":
            from gpras_tpu.gp.exact_stochastic import make_hutchinson_training_loss

            if getattr(self, "_hutch_loss", None) is None:
                from gpras_tpu.gp.exact_stochastic import default_chol_config

                # measured factorization knobs, shared with gp.coldfit and
                # bench.py (see default_chol_config's docstring)
                self._hutch_loss = make_hutchinson_training_loss(
                    self.kernel_str, **default_chol_config(n))
            return self._hutch_loss(params, self.x, y_i, jax.random.PRNGKey(0))
        if engine == "lean":
            from gpras_tpu.gp.exact_lean import make_lean_training_loss

            if getattr(self, "_lean_loss", None) is None:
                lean_engine = "super" if n > self.SUPER_THRESHOLD else None
                strip = 16384 if n <= 32768 else 4096
                self._lean_loss = make_lean_training_loss(
                    self.kernel_str, engine=lean_engine, chol_strip=strip)
            return self._lean_loss(params, self.x, y_i)
        return exact_gp.training_loss(self.kernel_str, params, self.x, y_i)

    def _init_params(self, inducing_initializer: str) -> dict[str, Array]:
        if self.model_type == "exact":
            return exact_gp.init_params(self.kernel_str, self.x)
        z = self._create_inducing(self.x, self.n_inducing, inducing_initializer)
        if self.model_type == "svgp":
            return svgp.init_params(self.kernel_str, self.x, z)
        return sgpr.init_params(self.kernel_str, self.x, z)

    @staticmethod
    def _create_inducing(x: Array, n_inducing: int, method: str) -> Array:
        """kmeans cluster centers or per-feature grid (gpras/gpr.py:310-320)."""
        if method == "kmeans":
            return km.kmeans_inducing(x, n_inducing, seed=0)
        if method == "grid":
            return km.grid_inducing(x, n_inducing)
        raise ValueError(f"Unknown inducing initializer {method!r}")

    # --------------------------------------------------------------- prediction

    def _ensure_cache(self) -> None:
        if self._cache is not None:
            return
        if self.params is None:
            raise RuntimeError("fit() or from_file() must run before predict()")
        if self.model_type == "svgp":
            # the variational posterior IS the model state — nothing to cache
            self._cache = ()
        elif self.model_type == "sgpr":
            self._cache = jax.vmap(
                lambda p, y_i: _sgpr_posterior_cache(self.kernel_str, p, self.x, y_i),
                in_axes=(0, 1),
            )(self.params, self.y)
        elif self._matrix_free:
            # No (N, N) buffer fits: cache alpha (batched CG solve) plus the
            # per-mode rank-64 pivoted-Cholesky preconditioner (it depends
            # only on params/x — rebuilding it per predict call would cost
            # O(N k^2) per mode every time), matching the training rank.
            from gpras_tpu.gp.exact_cg import cg_posterior_alpha, pivoted_cholesky

            alphas = jax.vmap(
                lambda p, y_i: cg_posterior_alpha(self.kernel_str, p, self.x, y_i,
                                                  precond_rank=64),
                in_axes=(0, 1),
            )(self.params, self.y)
            l_pcs = jax.vmap(
                lambda p: pivoted_cholesky(self.kernel_str, p, self.x, 64)
            )(self.params)
            self._cache = (alphas, l_pcs)
        else:
            self._cache = jax.vmap(
                lambda p, y_i: _exact_posterior_cache(self.kernel_str, p, self.x, y_i),
                in_axes=(0, 1),
            )(self.params, self.y)

    def predict(self, x: np.ndarray | Array) -> tuple[np.ndarray, np.ndarray]:
        """Posterior predictive (mean, variance), each (n_samples, n_modes).

        Observation-space variance (includes likelihood noise), matching the
        reference's ``predict_y`` concat loop (gpras/gpr.py:322-342) — but batched
        over modes and samples in one jitted call from precomputed factors.
        """
        xq = jnp.asarray(x, dtype=self.dtype)
        self._ensure_cache()
        if self.model_type == "svgp":
            mean, var = jax.vmap(
                lambda p: svgp.predict(self.kernel_str, p, xq)
            )(self.params)
        elif self.model_type == "sgpr":
            mean, var = jax.vmap(
                lambda p, cache: _sgpr_predict_from_cache(self.kernel_str, p, cache, xq)
            )(self.params, self._cache)
        elif self._matrix_free:
            from gpras_tpu.gp.exact_cg import cg_predict

            mean, var = jax.vmap(
                lambda p, a, l_pc, y_i: cg_predict(self.kernel_str, p, self.x,
                                                   y_i, xq, alpha=a, l_pc=l_pc),
                in_axes=(0, 0, 0, 1),
            )(self.params, self._cache[0], self._cache[1], self.y)
        else:
            mean, var = jax.vmap(
                lambda p, cache: _exact_predict_from_cache(self.kernel_str, p, cache, self.x, xq)
            )(self.params, self._cache)
        return np.asarray(mean.T), np.asarray(var.T)

    @property
    def _matrix_free(self) -> bool:
        """True when the exact posterior must avoid any (N, N) buffer.

        Above SUPER_THRESHOLD the dense posterior cache is impossible no
        matter the training engine: it would hold one (N, N) Cholesky factor
        PER MODE (the XLA lowering is also impractical there), so prediction
        goes through the matrix-free CG path (O(N * modes) cache of alphas +
        chunked batched-CG variance solves)."""
        if self.model_type != "exact" or self.x is None:
            return False
        return self.exact_engine == "cg" or self.x.shape[0] > self.SUPER_THRESHOLD

    # ------------------------------------------------------------ serialization

    def to_file(self, path: str | Path, model_dir: str | Path | None = None) -> None:
        """Structured npz checkpoint (kernel, data, per-mode params) — same content
        as the reference's pickle (gpras/gpr.py:344-366) without pickle.

        ``model_dir`` is accepted for signature parity and ignored (everything
        lives in the one file).
        """
        if self.params is None:
            raise RuntimeError("Nothing to save: fit() first")
        meta = {
            "kernel": self.kernel_str,
            "model_type": self.model_type,
            "exact_engine": self.exact_engine,
            "n_inducing": self.n_inducing,
            "dtype": np.dtype(jnp.asarray(self.x).dtype).name,
            "param_names": sorted(self.params.keys()),
        }
        arrays = {"x": np.asarray(self.x), "y": np.asarray(self.y)}
        for k, v in self.params.items():
            arrays[f"param_{k}"] = np.asarray(v)
        save_artifact(path, meta, arrays)

    @classmethod
    def from_file(cls, path: str | Path) -> Self:
        meta, arrays = load_artifact(path)
        inst = cls(meta["kernel"], model_type=meta["model_type"],
                   dtype=jnp.dtype(meta["dtype"]),
                   exact_engine=meta.get("exact_engine", "auto"))
        inst.n_inducing = int(meta["n_inducing"])
        inst.x = jnp.asarray(arrays["x"], dtype=inst.dtype)
        inst.y = jnp.asarray(arrays["y"], dtype=inst.dtype)
        inst.params = {
            name: jnp.asarray(arrays[f"param_{name}"], dtype=inst.dtype)
            if name != "degree" else jnp.asarray(arrays[f"param_{name}"])
            for name in meta["param_names"]
        }
        return inst

    # ------------------------------------------------------------------- extras

    @property
    def models(self) -> list[dict[str, np.ndarray]]:
        """Per-mode constrained hyperparameters (diagnostic convenience; the
        reference exposes a list of SGPR objects, gpras/gpr.py:232)."""
        if self.params is None:
            return []
        p_modes = next(iter(self.params.values())).shape[0]
        out = []
        for i in range(p_modes):
            mode = {k: np.asarray(v[i]) for k, v in self.params.items()}
            out.append({k[4:] if k.startswith("log_") else k:
                        np.exp(v) if k.startswith("log_") else v
                        for k, v in mode.items()})
        return out

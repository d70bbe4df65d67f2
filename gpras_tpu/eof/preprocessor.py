"""EOF preprocessors: spatial-field reduction and HMS forcing feature engineering.

API and behavioral parity with the reference's ``PreProcessor``
(gpras/preprocess.py:866-1162) and ``HmsPreProcessor``
(gpras/preprocess.py:1165-1320), with the PCA and the big matmuls
(projection / reconstruction / variance propagation) running on device.

Pipeline (PreProcessor.fit, mirroring gpras/preprocess.py:947-1007):
wetness classification (AD/TF/AF vs wet_threshold) -> drop always-dry cells ->
mean-center -> cell-area weighting -> PCA -> mode count by North's rule + Kaiser
-> project -> standardize modes. ``reverse_transform`` reconstructs the full
field and propagates posterior variance through the squared linear inverse map
(gpras/preprocess.py:1081-1094).

State is kept as host numpy arrays (cheap, serializable without pickle); compute
dispatches to jitted JAX functions — EXCEPT for sub-threshold inputs, which
stay on the host: each distinct jitted program pays a compile and dispatch
overhead that dwarfs the math for small project fits.
``GPRAS_EOF_HOST_ELEMENTS`` (default 2^22
elements, ~16 MB float32) sets the crossover; 0 forces everything on device.
"""

from __future__ import annotations

import os
from functools import partial
from os import PathLike
from typing import Any, Literal

import jax
import jax.numpy as jnp
import numpy as np

from gpras_tpu.eof.pca import pca_fit, pca_fit_reference
from gpras_tpu.utils.serialization import load_artifact, save_artifact

Array = jax.Array
HydraulicParameterType = Literal["wse", "depth", "velocity"]


def _host_small(*arrays: np.ndarray) -> bool:
    """True when every operand is below the host/device crossover."""
    thresh = int(os.environ.get("GPRAS_EOF_HOST_ELEMENTS", str(1 << 22)))
    return all(a.size <= thresh for a in arrays)


def compute_norths_rule(eigenvalues: np.ndarray, n_samples: int) -> int:
    """Retained-mode count: Kaiser filter (eigenvalue > 1), then the first
    eigenvalue gap at or below the North et al. sampling error sqrt(2/n) * lambda
    (reference gpras/preprocess.py:1323-1353, same returns including the
    'no gap found -> keep all Kaiser modes' branch)."""
    eigenvalues = np.asarray(eigenvalues, dtype=np.float64)
    eigenvalues = eigenvalues[eigenvalues > 1]
    if len(eigenvalues) <= 1:
        # 0 or 1 Kaiser modes: no gaps to test (the reference crashes on the
        # single-mode case — np.argmax over an empty diff)
        return int(len(eigenvalues))
    d_eigen = np.abs(np.diff(eigenvalues))
    d_error = np.sqrt(2.0 / n_samples) * eigenvalues[:-1]
    ind = int(np.argmax(d_eigen <= d_error))
    if ind == 0:
        return int(len(eigenvalues))
    return ind


@jax.jit
def _project_device(x: Array, eofs: Array) -> Array:
    return jnp.matmul(x, eofs.T, preferred_element_type=x.dtype)


@jax.jit
def _reconstruct_device(modes: Array, eofs: Array) -> Array:
    return jnp.matmul(modes, eofs, preferred_element_type=modes.dtype)


def _project(x: np.ndarray, eofs: np.ndarray) -> np.ndarray:
    if _host_small(x, eofs):
        return np.asarray(x) @ np.asarray(eofs).T
    return np.asarray(_project_device(jnp.asarray(x), jnp.asarray(eofs)))


def _reconstruct(modes: np.ndarray, eofs: np.ndarray) -> np.ndarray:
    if _host_small(modes, eofs):
        return np.asarray(modes) @ np.asarray(eofs)
    return np.asarray(_reconstruct_device(jnp.asarray(modes),
                                          jnp.asarray(eofs)))


class PreProcessor:
    """Spatial-field EOF reduction (reference gpras/preprocess.py:866)."""

    def __init__(
        self,
        spatial_mode_count: int = 0,
        input_mean: np.ndarray | None = None,
        wet_threshold: float = 0.03,
        elevations: np.ndarray | None = None,
        hydraulic_parameter: HydraulicParameterType = "wse",
        wetness_classes: np.ndarray | None = None,
        weights: np.ndarray | None = None,
        eofs: np.ndarray | None = None,
        eigenvalues: np.ndarray | None = None,
        n_samples_fit: float = 0,
        x_mean: np.ndarray | None = None,
        x_std: np.ndarray | None = None,
    ) -> None:
        self.spatial_mode_count = spatial_mode_count
        self.input_mean = np.empty(0) if input_mean is None else np.asarray(input_mean)
        self.wet_threshold = wet_threshold
        self.elevations = np.empty(0) if elevations is None else np.asarray(elevations)
        self.hydraulic_parameter: HydraulicParameterType = hydraulic_parameter
        self.wetness_classes = (
            np.empty(0, dtype="<U2") if wetness_classes is None else np.asarray(wetness_classes)
        )
        # None or empty -> unweighted (the reference's `weights is not None` checks
        # are vacuous because it stores an empty array; we treat empty as None)
        self.weights = None if weights is None or np.size(weights) == 0 else np.asarray(weights)
        self.eofs = np.empty(0) if eofs is None else np.asarray(eofs)
        self.eigenvalues = np.empty(0) if eigenvalues is None else np.asarray(eigenvalues)
        self.n_samples_fit = n_samples_fit
        self.x_mean = np.empty(0) if x_mean is None else np.asarray(x_mean)
        self.x_std = np.empty(0) if x_std is None else np.asarray(x_std)
        self._var_transform_cache: np.ndarray | None = None

    # ------------------------------------------------------------------ fitting

    @property
    def dry_indices(self) -> np.ndarray:
        """Boolean mask of always-dry cells (gpras/preprocess.py:925-934)."""
        return np.equal(self.wetness_classes, "AD")

    @property
    def eof(self) -> np.ndarray:
        if self.eofs.size == 0:
            raise ValueError("EOFs have not been computed")
        return self.eofs

    def fit(
        self,
        x: np.ndarray,
        elevations: np.ndarray,
        weights: np.ndarray | None = None,
        spatial_mode_count: int | None = None,
    ) -> None:
        """Fit EOFs on (samples, cells) WSE data (gpras/preprocess.py:947-1007)."""
        x = np.asarray(x)
        self.elevations = np.asarray(elevations)
        if self.hydraulic_parameter == "depth":
            x = self.wse_2_depth(x)
            self.wetness_classes = self.classify_wetness_depth(x)
        elif self.hydraulic_parameter == "wse":
            self.wetness_classes = self.classify_wetness_wse(x, self.elevations)
        elif self.hydraulic_parameter == "velocity":
            self.wetness_classes = np.repeat("TF", x.shape[1])
        x = x[:, ~self.dry_indices]

        self.input_mean = x.mean(axis=0)
        x = x - self.input_mean

        if weights is not None:
            self.weights = np.asarray(weights)[~self.dry_indices]
            x = x * self.weights

        if _host_small(x):
            comps, explained = pca_fit_reference(x)
        else:
            comps, explained = pca_fit(jnp.asarray(x))
        comps = np.asarray(comps)
        explained = np.asarray(explained)
        n = x.shape[0]

        if spatial_mode_count is None:
            self.spatial_mode_count = compute_norths_rule(explained, n)
        else:
            self.spatial_mode_count = spatial_mode_count

        self.eofs = comps[: self.spatial_mode_count]
        self.eigenvalues = explained
        self.n_samples_fit = n

        xp = _project(x, self.eofs)
        self.x_mean = xp.mean(axis=0)
        x_std = xp.std(axis=0)
        # a rank-deficient field (or user-forced mode count beyond the rank)
        # yields zero-variance null modes; unit std keeps them as constant
        # zero features instead of NaN-ing the standardization
        self.x_std = np.where(x_std > 0, x_std, 1.0)
        self._var_transform_cache = None

    # ----------------------------------------------------------------- transform

    def transform(self, x: np.ndarray) -> np.ndarray:
        """(samples, cells) -> standardized EOF modes (samples, mode_count)
        (gpras/preprocess.py:1009-1039)."""
        x = np.asarray(x)
        if self.hydraulic_parameter == "depth":
            x = self.wse_2_depth(x)
        x = x[:, ~self.dry_indices]
        x = x - self.input_mean
        if self.weights is not None:
            x = x * self.weights
        xp = _project(x, self.eofs)
        return (xp - self.x_mean) / self.x_std

    def wse_2_depth(self, x: np.ndarray) -> np.ndarray:
        """WSE -> depth, clamped at zero (gpras/preprocess.py:1041-1045)."""
        d = np.asarray(x) - self.elevations
        return np.where(d < 0, 0.0, d)

    def reverse_transform(
        self, mean: np.ndarray, var: np.ndarray | None = None
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """EOF modes -> full cell field, dry cells filled with elevation (wse) or 0
        (depth); optional posterior-variance propagation through the squared
        linear inverse map (gpras/preprocess.py:1052-1094)."""
        mean = np.asarray(mean) * self.x_std + self.x_mean
        mean = _reconstruct(mean, self.eofs)
        if self.weights is not None:
            mean = mean / self.weights
        mean = mean + self.input_mean
        x_full = np.empty((mean.shape[0], self.dry_indices.shape[0]), dtype=mean.dtype)
        if self.hydraulic_parameter == "depth":
            x_full[:, self.dry_indices] = 0
        else:
            x_full[:, self.dry_indices] = self.elevations[self.dry_indices]
        x_full[:, ~self.dry_indices] = mean
        if var is None:
            return x_full
        var_prop = _reconstruct(np.asarray(var), self._linear_transform_for_var)
        var_full = np.empty((var_prop.shape[0], self.dry_indices.shape[0]), dtype=var_prop.dtype)
        var_full[:, self.dry_indices] = 0
        var_full[:, ~self.dry_indices] = var_prop
        return x_full, var_full

    @property
    def _linear_transform_for_var(self) -> np.ndarray:
        """Elementwise square of diag(x_std) @ eofs / weights — the exact error
        propagation matrix of the reference (gpras/preprocess.py:1087-1094)."""
        if self._var_transform_cache is None:
            a = self.x_std[:, None] * self.eofs
            if self.weights is not None:
                a = a / self.weights[None, :]
            self._var_transform_cache = a**2
        return self._var_transform_cache

    # -------------------------------------------------------------- wetness class

    def classify_wetness_wse(self, x: np.ndarray, elevations: np.ndarray) -> np.ndarray:
        max_depth = np.asarray(x).max(axis=0) - elevations
        min_depth = np.asarray(x).min(axis=0) - elevations
        return self._classify_depths(max_depth, min_depth)

    def classify_wetness_depth(self, x: np.ndarray) -> np.ndarray:
        max_depth = np.asarray(x).max(axis=0)
        min_depth = np.asarray(x).min(axis=0)
        return self._classify_depths(max_depth, min_depth)

    def _classify_depths(self, max_depth: np.ndarray, min_depth: np.ndarray) -> np.ndarray:
        """AD (always dry) / TF (transitionally flooded) / AF (always flooded),
        the threshold logic of gpras/preprocess.py:1128-1133 — with one
        deliberate deviation: the reference leaves cells with
        max_depth == wet_threshold (or NaN) UNINITIALIZED (np.empty garbage);
        here they default to TF, which keeps the cell in the EOF basis (the
        safe direction)."""
        classes = np.full(max_depth.shape, "TF", dtype="<U2")
        classes[max_depth < self.wet_threshold] = "AD"
        classes[min_depth > self.wet_threshold] = "AF"
        return classes

    # ------------------------------------------------------------- serialization

    def to_dict(self) -> dict[str, Any]:
        return {
            "spatial_mode_count": self.spatial_mode_count,
            "wet_threshold": self.wet_threshold,
            "hydraulic_parameter": self.hydraulic_parameter,
            "elevations": self.elevations,
            "wetness_classes": self.wetness_classes,
            "input_mean": self.input_mean,
            "weights": self.weights if self.weights is not None else np.empty(0),
            "eofs": self.eofs,
            "eigenvalues": self.eigenvalues,
            "n_samples_fit": self.n_samples_fit,
            "x_mean": self.x_mean,
            "x_std": self.x_std,
        }

    def to_file(self, out_path: str | PathLike[str]) -> None:
        d = self.to_dict()
        meta = {
            "class": "PreProcessor",
            "spatial_mode_count": int(d.pop("spatial_mode_count")),
            "wet_threshold": float(d.pop("wet_threshold")),
            "hydraulic_parameter": d.pop("hydraulic_parameter"),
            "n_samples_fit": float(d.pop("n_samples_fit")),
        }
        save_artifact(out_path, meta, d)

    @classmethod
    def from_file(cls, in_path: str | PathLike[str]) -> "PreProcessor":
        meta, arrays = load_artifact(in_path)
        return cls(
            spatial_mode_count=meta["spatial_mode_count"],
            wet_threshold=meta["wet_threshold"],
            hydraulic_parameter=meta["hydraulic_parameter"],
            n_samples_fit=meta["n_samples_fit"],
            **{k: v for k, v in arrays.items()},
        )


class HmsPreProcessor:
    """Forcing feature engineering from precip + inflow boundary conditions
    (reference gpras/preprocess.py:1165-1320)."""

    def __init__(
        self,
        precip_spatial_mode_count: int = 0,
        bc_mask: np.ndarray | None = None,
        precip_mask: np.ndarray | None = None,
        eofs: np.ndarray | None = None,
        eigenvalues: np.ndarray | None = None,
        n_samples_fit: float = 0,
        x_mean: np.ndarray | None = None,
        x_std: np.ndarray | None = None,
        input_mean: np.ndarray | None = None,
        event_reset: bool = False,
    ) -> None:
        #: When True, the antecedent-precipitation convolutions restart at
        #: every event boundary (``event_ids`` passed to fit/transform), so
        #: event N's decayed tail cannot leak into event N+1's features. Off by
        #: default for reference parity (gpras/preprocess.py:1251-1256 convolves
        #: across the concatenated frame).
        self.event_reset = bool(event_reset)
        self.precip_spatial_mode_count = precip_spatial_mode_count
        self.bc_mask = np.empty(0, dtype=bool) if bc_mask is None else np.asarray(bc_mask)
        self.precip_mask = np.empty(0, dtype=bool) if precip_mask is None else np.asarray(precip_mask)
        self.eofs = np.empty(0) if eofs is None else np.asarray(eofs)
        self.eigenvalues = np.empty(0) if eigenvalues is None else np.asarray(eigenvalues)
        self.n_samples_fit = n_samples_fit
        self.x_mean = np.empty(0) if x_mean is None else np.asarray(x_mean)
        self.x_std = np.empty(0) if x_std is None else np.asarray(x_std)
        self.input_mean = np.empty(0) if input_mean is None else np.asarray(input_mean)

    def fit(
        self,
        x: np.ndarray,
        bc_mask: np.ndarray,
        precip_mask: np.ndarray,
        precip_spatial_mode_count: int | None = None,
        event_ids: np.ndarray | None = None,
    ) -> None:
        """Center; PCA on the precip columns; derive mean-precip + two antecedent
        precipitation indices; standardize with nonzero-only std
        (gpras/preprocess.py:1208-1261)."""
        x = np.asarray(x)
        self.input_mean = x.mean(axis=0)
        x = x - self.input_mean
        self.bc_mask = np.asarray(bc_mask)
        self.precip_mask = np.asarray(precip_mask)
        x_precip = x[:, self.precip_mask]

        if _host_small(x_precip):
            comps, explained = pca_fit_reference(x_precip)
        else:
            comps, explained = pca_fit(jnp.asarray(x_precip))
        comps, explained = np.asarray(comps), np.asarray(explained)
        n = x_precip.shape[0]
        if precip_spatial_mode_count is None:
            self.precip_spatial_mode_count = compute_norths_rule(explained, n)
        else:
            self.precip_spatial_mode_count = precip_spatial_mode_count
        self.eofs = comps[: self.precip_spatial_mode_count]
        self.eigenvalues = explained
        self.n_samples_fit = n

        feats = self._features(x, event_ids=event_ids)
        self.x_mean = feats.mean(axis=0)
        # std over nonzero entries only (gpras/preprocess.py:1261)
        stds = []
        for i in range(feats.shape[1]):
            col = feats[feats[:, i] != 0, i]
            stds.append(np.std(col) if col.size else np.nan)
        self.x_std = np.asarray(stds)

    def _features(self, x_centered: np.ndarray,
                  event_ids: np.ndarray | None = None) -> np.ndarray:
        """bc columns ++ precip EOF modes ++ mean precip ++ API(k=0.85) ++ API(k=1)
        (gpras/preprocess.py:1251-1257)."""
        x_bc = x_centered[:, self.bc_mask]
        x_precip = x_centered[:, self.precip_mask]
        avg_precip = np.mean(x_precip, axis=1)
        ev = event_ids if self.event_reset else None
        api_1 = self.calc_antecedent_precipitation_index(avg_precip, event_ids=ev)
        api_2 = self.calc_antecedent_precipitation_index(avg_precip, k=1, event_ids=ev)
        precip_reduced = _project(x_precip, self.eofs)
        return np.concatenate([x_bc, precip_reduced, avg_precip[:, None], api_1, api_2], axis=1)

    def transform(self, x: np.ndarray,
                  event_ids: np.ndarray | None = None) -> np.ndarray:
        x = np.asarray(x) - self.input_mean
        feats = self._features(x, event_ids=event_ids)
        return (feats - self.x_mean) / self.x_std

    # NOTE (parity caveat): by default, like the reference
    # (gpras/preprocess.py:1251-1256), the API features are convolved across the
    # CONCATENATED multi-event frame, so a decayed tail of one event leaks into
    # the next event's first timesteps. Both training and inference stack events
    # the same way, so the treatment is at least consistent. Constructing the
    # preprocessor with ``event_reset=True`` (config ``api_event_reset``) and
    # passing ``event_ids`` restarts the convolution at each event boundary —
    # zero cross-event leakage. ``event_ids=None`` under the flag treats the
    # whole input as one event (the correct single-event serving semantics).
    @staticmethod
    def calc_antecedent_precipitation_index(
        x: np.ndarray, k: float = 0.85, window: int | None = None,
        event_ids: np.ndarray | None = None,
    ) -> np.ndarray:
        """Exponential-decay API convolution (gpras/preprocess.py:1284-1294);
        with ``event_ids``, a segment-reset convolution per contiguous event."""
        if event_ids is None:
            if window is None:
                window = len(x)
            weights = k ** np.arange(window)
            return np.convolve(x, weights, mode="full")[: len(x), np.newaxis]
        ev = np.asarray(event_ids)
        if len(ev) != len(x):
            raise ValueError(f"event_ids length {len(ev)} != data length {len(x)}")
        out = np.empty((len(x), 1), dtype=np.asarray(x).dtype)
        start = 0
        for i in range(1, len(x) + 1):
            if i == len(x) or ev[i] != ev[start]:
                seg = np.asarray(x)[start:i]
                w = k ** np.arange(window if window is not None else len(seg))
                out[start:i, 0] = np.convolve(seg, w, mode="full")[: len(seg)]
                start = i
        return out

    def to_dict(self) -> dict[str, Any]:
        return {
            "precip_spatial_mode_count": self.precip_spatial_mode_count,
            "event_reset": self.event_reset,
            "bc_mask": self.bc_mask,
            "precip_mask": self.precip_mask,
            "eofs": self.eofs,
            "eigenvalues": self.eigenvalues,
            "n_samples_fit": self.n_samples_fit,
            "x_mean": self.x_mean,
            "x_std": self.x_std,
            "input_mean": self.input_mean,
        }

    def to_file(self, out_path: str | PathLike[str]) -> None:
        d = self.to_dict()
        meta = {
            "class": "HmsPreProcessor",
            "precip_spatial_mode_count": int(d.pop("precip_spatial_mode_count")),
            "n_samples_fit": float(d.pop("n_samples_fit")),
            "event_reset": bool(d.pop("event_reset")),
        }
        save_artifact(out_path, meta, d)

    @classmethod
    def from_file(cls, in_path: str | PathLike[str]) -> "HmsPreProcessor":
        meta, arrays = load_artifact(in_path)
        return cls(
            precip_spatial_mode_count=meta["precip_spatial_mode_count"],
            n_samples_fit=meta["n_samples_fit"],
            event_reset=meta.get("event_reset", False),
            **{k: v for k, v in arrays.items()},
        )

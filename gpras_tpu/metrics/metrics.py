"""Flood-verification metrics over (timesteps, cells) arrays per event.

Full parity with the reference metric suite (gpras/metrics.py): RMSE/MAE/bias
family at three granularities (per event scalar / per timestep / per cell),
NSE-at-peaks, fidelity index with time+value tolerance, and peak contingency
scores (POD, RFA, CSI, F2, F3), plus mean predicted-sigma "confidence" columns.
Results export to the same three SQLite tables (``scalar_metrics``,
``timeseries_metrics``, ``cell_metrics``; gpras/metrics.py:79-82).

On device: a single jitted ``compute_event_metrics`` evaluates the entire suite
for one event in one fused program (the reference loops ~20 numpy calls per
event, gpras/metrics.py:27-76, re-scanning the arrays each time); the host loop
over events only handles ragged timestep counts and the SQLite write.

Convention (as in the reference): ``x`` is the observed/high-fidelity field,
``y`` is the model prediction, ``conf`` is the predicted standard deviation
field, ``*_mts`` are per-cell argmax-time indices cached once
(gpras/metrics.py:35-36).

Note: the reference calls ``f2_mts(x, y, x_mts, y_mts)`` positionally against a
``(x, y, depth_threshold, x_mts, y_mts)`` signature, accidentally binding the
argmax-index array as the detection threshold (gpras/metrics.py:52-53 vs 265-271).
We implement the documented intent: F2/F3 use the same ``depth_threshold`` as
POD/RFA/CSI.
"""

from __future__ import annotations

import contextlib
import sqlite3
from functools import partial
from pathlib import Path
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

if TYPE_CHECKING:  # the export path alone needs pandas
    import pandas as pd

Array = jax.Array


def _at_peaks(x: Array, y: Array, x_mts: Array, y_mts: Array) -> tuple[Array, Array]:
    cols = jnp.arange(x.shape[1])
    return x[x_mts, cols], y[y_mts, cols]


def rmse_aoi_toi(x: Array, y: Array) -> Array:
    """RMSE across all cells and timesteps (gpras/metrics.py:85-87)."""
    return jnp.sqrt(jnp.mean((x - y) ** 2))


def mae_aoi_toi(x: Array, y: Array) -> Array:
    """MAE across all cells and timesteps (gpras/metrics.py:90-92)."""
    return jnp.mean(jnp.abs(x - y))


def conf_aoi_toi(conf: Array) -> Array:
    """Mean predicted sigma over everything (gpras/metrics.py:95-97)."""
    return jnp.mean(conf)


def rmse_aoi_ts(x: Array, y: Array) -> Array:
    """Per-timestep RMSE over cells (gpras/metrics.py:100-102)."""
    return jnp.sqrt(jnp.mean((x - y) ** 2, axis=1))


def rmse_cell_toi(x: Array, y: Array) -> Array:
    """Per-cell RMSE over timesteps (gpras/metrics.py:105-107)."""
    return jnp.sqrt(jnp.mean((x - y) ** 2, axis=0))


def rmse_aoi_mts(x: Array, y: Array, x_mts: Array, y_mts: Array) -> Array:
    """RMSE of per-cell peaks (gpras/metrics.py:110-121)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return jnp.sqrt(jnp.mean((xp - yp) ** 2))


def err_cell_mts(x: Array, y: Array, x_mts: Array, y_mts: Array) -> Array:
    """Per-cell peak difference (gpras/metrics.py:124-135)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return xp - yp


def nse_aoi_mts(x: Array, y: Array, x_mts: Array, y_mts: Array) -> Array:
    """Nash-Sutcliffe efficiency between per-cell peaks (gpras/metrics.py:138-151)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    num = jnp.sum((xp - yp) ** 2)
    denom = jnp.sum((xp - jnp.mean(xp)) ** 2)
    return 1.0 - num / denom


def err_aoi_toi(x: Array, y: Array) -> Array:
    """Mean bias over everything (gpras/metrics.py:154-156)."""
    return jnp.mean(x - y)


def err_aoi_mts(x: Array, y: Array, x_mts: Array, y_mts: Array) -> Array:
    """Mean bias of per-cell peaks (gpras/metrics.py:159-171)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return jnp.mean(xp - yp)


def err_aoi_ts(x: Array, y: Array) -> Array:
    """Per-timestep mean bias over cells (gpras/metrics.py:174-176)."""
    return jnp.mean(x - y, axis=1)


def conf_aoi_ts(conf: Array) -> Array:
    """Per-timestep mean sigma (gpras/metrics.py:179-181)."""
    return jnp.mean(conf, axis=1)


def err_cell_toi(x: Array, y: Array) -> Array:
    """Per-cell mean bias over timesteps (gpras/metrics.py:184-186)."""
    return jnp.mean(x - y, axis=0)


def conf_cell_toi(conf: Array) -> Array:
    """Per-cell mean sigma (gpras/metrics.py:189-191)."""
    return jnp.mean(conf, axis=0)


def fi_aoi_toi(x: Array, y: Array, t_tol: int, v_tol: float) -> Array:
    """Fidelity index: fraction of (t, cell) points matched within a value
    tolerance at any time shift up to t_tol (gpras/metrics.py:194-203).
    ``t_tol`` is static (small), unrolled at trace time."""
    matching = jnp.abs(y - x) <= v_tol
    for i in range(1, t_tol + 1):
        tmp = jnp.abs(y[:-i, :] - x[i:, :]) <= v_tol
        matching = matching.at[:-i].set(tmp | matching[:-i])
    for i in range(1, t_tol + 1):
        tmp = jnp.abs(x[:-i, :] - y[i:, :]) <= v_tol
        matching = matching.at[:-i].set(tmp | matching[:-i])
    return jnp.sum(matching) / (matching.shape[0] * matching.shape[1])


def _contingency(x: Array, y: Array, threshold, x_mts: Array, y_mts: Array):
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    x_wet = xp >= threshold
    y_wet = yp >= threshold
    a = jnp.sum(x_wet & y_wet)        # detected
    b = jnp.sum(~x_wet & y_wet)       # false alarm
    c = jnp.sum(x_wet & ~y_wet)       # miss
    return a, b, c


def pod_mts(x, y, threshold, x_mts, y_mts) -> Array:
    """Probability of detection at per-cell peaks (gpras/metrics.py:206-224)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    return a / (a + c)


def rfa_mts(x, y, threshold, x_mts, y_mts) -> Array:
    """Rate of false alarm at per-cell peaks (gpras/metrics.py:227-245)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    return b / (a + b)


def csi_mts(x, y, threshold, x_mts, y_mts) -> Array:
    """Critical success index via 1/(1/POD + 1/(1-RFA) - 1) (gpras/metrics.py:248-262)."""
    pod = pod_mts(x, y, threshold, x_mts, y_mts)
    rfa = rfa_mts(x, y, threshold, x_mts, y_mts)
    return 1.0 / ((1.0 / pod) + (1.0 / (1.0 - rfa)) - 1.0)


def f2_mts(x, y, threshold, x_mts, y_mts) -> Array:
    """(a - c)/(a + b + c) at per-cell peaks; 1 when empty (gpras/metrics.py:265-290)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    denom = a + b + c
    return jnp.where(denom == 0, 1.0, (a - c) / jnp.where(denom == 0, 1, denom))


def f3_mts(x, y, threshold, x_mts, y_mts) -> Array:
    """(a - b)/(a + b + c) at per-cell peaks; 1 when empty (gpras/metrics.py:293-318)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    denom = a + b + c
    return jnp.where(denom == 0, 1.0, (a - b) / jnp.where(denom == 0, 1, denom))


@partial(jax.jit, static_argnames=("t_tol", "contingency"))
def compute_event_metrics(
    x: Array,
    y: Array,
    conf: Array,
    depth_threshold: float = 0.5,
    t_tol: int = 0,
    v_tol: float = 0.0,
    contingency: bool = True,
) -> dict[str, Array]:
    """The full per-event suite in one fused program.

    Returns scalars plus per-timestep and per-cell arrays; ``contingency=False``
    reproduces the reference's velocity special-case (POD/RFA/CSI = NaN,
    gpras/metrics.py:49-51).
    """
    x_mts = jnp.argmax(x, axis=0)
    y_mts = jnp.argmax(y, axis=0)
    out: dict[str, Array] = {
        "rmse_aoi_toi": rmse_aoi_toi(x, y),
        "mae_aoi_toi": mae_aoi_toi(x, y),
        "conf_aoi_toi": conf_aoi_toi(conf),
        "rmse_aoi_mts": rmse_aoi_mts(x, y, x_mts, y_mts),
        "nse_aoi_mts": nse_aoi_mts(x, y, x_mts, y_mts),
        "err_aoi_toi": err_aoi_toi(x, y),
        "err_aoi_mts": err_aoi_mts(x, y, x_mts, y_mts),
        "fi_aoi_toi": fi_aoi_toi(x, y, t_tol, v_tol),
        "f2_mts": f2_mts(x, y, depth_threshold, x_mts, y_mts),
        "f3_mts": f3_mts(x, y, depth_threshold, x_mts, y_mts),
        # timeseries
        "rmse_aoi_ts": rmse_aoi_ts(x, y),
        "err_aoi_ts": err_aoi_ts(x, y),
        "conf_aoi_ts": conf_aoi_ts(conf),
        # cells
        "rmse_cell_toi": rmse_cell_toi(x, y),
        "err_cell_mts": err_cell_mts(x, y, x_mts, y_mts),
        "err_cell_toi": err_cell_toi(x, y),
        "conf_cell_toi": conf_cell_toi(conf),
    }
    if contingency:
        out["pod_mts"] = pod_mts(x, y, depth_threshold, x_mts, y_mts)
        out["rfa_mts"] = rfa_mts(x, y, depth_threshold, x_mts, y_mts)
        out["csi_mts"] = csi_mts(x, y, depth_threshold, x_mts, y_mts)
    else:
        nan = jnp.asarray(jnp.nan, dtype=x.dtype)
        out["pod_mts"] = nan
        out["rfa_mts"] = nan
        out["csi_mts"] = nan
    return out


SCALAR_COLUMNS = (
    "rmse_aoi_toi", "mae_aoi_toi", "conf_aoi_toi", "rmse_aoi_mts", "nse_aoi_mts",
    "err_aoi_toi", "err_aoi_mts", "fi_aoi_toi", "pod_mts", "rfa_mts", "csi_mts",
    "f2_mts", "f3_mts",
)
TS_COLUMNS = ("rmse_aoi_ts", "err_aoi_ts", "conf_aoi_ts")
CELL_COLUMNS = ("rmse_cell_toi", "err_cell_mts", "err_cell_toi", "conf_cell_toi")


def export_metric_summary(
    x_all: pd.DataFrame,
    y_all: pd.DataFrame,
    conf_all: pd.DataFrame,
    out_path: str | Path,
    depth_threshold: float = 0.5,
    t_tol: int = 0,
    v_tol: float = 0,
    hydraulic_parameter: str = "depth",
) -> None:
    """Per-event metric tables -> SQLite, signature-compatible with the reference
    (gpras/metrics.py:11-82). Inputs are (event, timestep)-MultiIndexed frames
    with one column per cell."""
    import pandas as pd

    all_scalar, all_ts, all_cells = [], [], []
    # Events have ragged (clipped) timestep counts, so compute_event_metrics
    # recompiles per distinct length. The math is elementwise-cheap; pin it
    # to the host CPU backend so those compiles stay cheap and the (T, C)
    # frames read from SQLite-bound pandas never cross to the device.
    cpu = jax.devices("cpu")[0]
    for event in x_all.index.unique(level=0):
        with jax.default_device(cpu):
            x = jnp.asarray(x_all.loc[event].values)
            y = jnp.asarray(y_all.loc[event].values)
            conf = jnp.asarray(conf_all.loc[event].values)
            m = compute_event_metrics(
                x, y, conf,
                depth_threshold=depth_threshold, t_tol=t_tol, v_tol=v_tol,
                contingency=(hydraulic_parameter != "velocity"),
            )
        tsteps = x_all.loc[event].index.values
        m = {k: np.asarray(v) for k, v in m.items()}
        all_scalar.append(pd.DataFrame({"event": [event],
                                        **{c: [float(m[c])] for c in SCALAR_COLUMNS}}))
        all_ts.append(pd.DataFrame({
            "event": np.repeat(event, x.shape[0]), "timestep": tsteps,
            **{c: m[c] for c in TS_COLUMNS},
        }))
        all_cells.append(pd.DataFrame({
            "event": np.repeat(event, x.shape[1]), "cell_id": x_all.columns,
            **{c: m[c] for c in CELL_COLUMNS},
        }))
    with sqlite3.connect(out_path) as con:
        pd.concat(all_scalar).to_sql("scalar_metrics", con, index=False, if_exists="replace")
        pd.concat(all_ts).to_sql("timeseries_metrics", con, index=False, if_exists="replace")
        pd.concat(all_cells).to_sql("cell_metrics", con, index=False, if_exists="replace")

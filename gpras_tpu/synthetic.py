"""Seeded synthetic problems shared by the benchmark, the chip smoke test and
the tests: data is made from a seed, so every run sees the same problem.

- ``hard_problem``: the multi-scale exact-GP regression problem the large-N
  engines are measured on.
- ``flood_fields``: a full-field flood surrogate problem (high- and
  low-fidelity water-surface fields over a 2-D valley, many events, many
  timesteps per event), the shape of the pilot deployments the serving
  path is built for.
"""

from __future__ import annotations

import numpy as np


def hard_problem(n: int, d: int = 8, seed: int = 7):
    """Multi-scale anisotropic DGP with low EFFECTIVE dimension
    (EOF-storm-like: a handful of storm parameters drive the response, the
    remaining features are ARD-nuisance dims).

    Inputs are full-rank N(0,1)^d; the response varies along THREE dims at
    three scales (wavelengths ~6.3 / 3.1 / ~1.6) plus sigma=0.1 noise. The
    shortest wavelength needs ~3-D sample density that a few-thousand-point
    subsample does not have, so a coarse-stage fit must absorb that
    component into its noise estimate and a warm start must take full-N
    polish steps. Returns float32 numpy arrays (x (n, d), y (n,)).
    """
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0])
         + 0.5 * np.sin(2.0 * x[:, 1])
         + 0.4 * np.sin(4.0 * x[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def flood_fields(n_events: int, n_timesteps: int, grid: tuple[int, int],
                 seed: int = 0):
    """(hf_wse, lf_wse, elevations) for ``n_events`` storms of
    ``n_timesteps`` steps over a ``grid[0] x grid[1]`` cell valley.

    Each storm has five parameters (peak stage, cross- and down-valley
    tilt, peak time, hydrograph width); the stage rises and falls over the
    event and the water surface is clamped at the terrain, so cells wet and
    dry through the event. The low-fidelity field is a smoothed, biased copy
    of the stage on the same terrain. Arrays are float32 with shape
    (n_events * n_timesteps, cells) for the fields and (cells,) for the
    terrain; rows are event-major.
    """
    rng = np.random.default_rng(seed)
    ny, nx = grid
    sy, sx = np.meshgrid(np.linspace(0.0, 1.0, ny), np.linspace(0.0, 1.0, nx),
                         indexing="ij")
    sy, sx = sy.ravel().astype(np.float32), sx.ravel().astype(np.float32)
    # parabolic cross-section sloping down-valley, 0..~6 m
    elevations = 20.0 * (sx - 0.5) ** 2 + 1.5 * (1.0 - sy)

    peak = rng.gamma(4.0, 0.6, size=n_events)
    tilt_x = rng.normal(0.0, 0.4, size=n_events)
    tilt_y = rng.normal(0.0, 0.6, size=n_events)
    t_peak = rng.uniform(0.3, 0.7, size=n_events)
    width = rng.uniform(0.1, 0.3, size=n_events)
    t = np.linspace(0.0, 1.0, n_timesteps)
    hydro = np.exp(-0.5 * ((t[None, :] - t_peak[:, None]) / width[:, None])
                   ** 2).astype(np.float32)
    peak, tilt_x, tilt_y = (a.astype(np.float32) for a in (peak, tilt_x, tilt_y))

    def stage(bias: float, smooth: float) -> np.ndarray:
        level = (peak[:, None] * hydro)[:, :, None]                # (E, T, 1)
        slope = (tilt_x[:, None] * (sx - 0.5)[None, :]
                 + tilt_y[:, None] * (1.0 - sy)[None, :] * smooth)  # (E, C)
        return level + hydro[:, :, None] * slope[:, None, :] + bias

    cells = elevations.shape[0]
    hf = np.maximum(elevations, stage(0.0, 1.0)).reshape(-1, cells)
    lf = np.maximum(elevations, stage(0.05, 0.8)).reshape(-1, cells)
    return (hf.astype(np.float32), lf.astype(np.float32),
            elevations.astype(np.float32))

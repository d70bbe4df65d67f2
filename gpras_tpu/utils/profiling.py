"""Tracing/profiling: phase timers + jax.profiler hooks + per-step loss logs.

The reference's only observability is five perf_counter timestamps dumped to
``timers.json`` (production/analysis/pipeline.py:216-294) and bare prints. This
module keeps that phase-timer surface (same JSON keys, SURVEY.md section 5.1)
and adds the device layer: ``jax.profiler`` trace capture around any phase
(viewable in TensorBoard/XProf), and a loss-history recorder that turns the
optimizer's nan-padded ``losses`` array into step logs.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import numpy as np

log = logging.getLogger("gpras_tpu")


class PhaseTimers:
    """Named phase wall-clocks -> timers.json (reference pipeline.py:289-294)."""

    def __init__(self) -> None:
        self._starts: dict[str, float] = {}
        self.elapsed: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = self.elapsed.get(name, 0.0) + time.perf_counter() - t0

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.elapsed[name] = time.perf_counter() - self._starts.pop(name)

    def to_file(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.elapsed, f, indent=4)


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path | None):
    """Capture a jax.profiler trace for the enclosed block (no-op if dir None)."""
    if log_dir is None:
        yield
        return
    import jax

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_fit_losses(info: dict, name: str = "fit", every: int = 50) -> list[float]:
    """Expand an optimizer ``info`` dict (nan-padded losses array, possibly
    batched over modes) into logged per-step losses; returns the flat history."""
    if info.get("losses") is None:
        return []
    losses = np.asarray(info["losses"])
    if losses.ndim > 1:  # (modes, steps) -> mean over modes per step
        losses = np.nanmean(losses, axis=0)
    valid = losses[np.isfinite(losses)]
    for i in range(0, len(valid), max(every, 1)):
        log.info("%s step %d: loss=%.6g", name, i, valid[i])
    if len(valid):
        log.info("%s final: loss=%.6g after %d steps", name, valid[-1], len(valid))
    return valid.tolist()

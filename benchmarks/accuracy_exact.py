"""Exact-engine accuracy north star runner.

Runs the two sides of gpras_tpu.accuracy's exact-engine comparison in
subprocesses (they need different frozen platforms/precisions):

1. ``f32``: production GPRAS exact fit at N=32,768 (auto engine ladder ->
   Hutchinson super-panel training + matrix-free CG posterior) on the
   default device;
2. ``f64``: dense float64 gold posterior on CPU with the SAME fitted
   hyperparameters (~10 min single-core: one 32k f64 Cholesky).

Prints the summary JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

RUNNER = """
import sys
sys.path.insert(0, {repo!r})
import jax
from gpras_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
if {path!r} == "f64":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
from gpras_tpu import accuracy
accuracy.run_exact_path({path!r}, {workdir!r})
print("EXACT_OK")
"""


def main() -> None:
    workdir = os.environ.get("GPRAS_ACCURACY_WORKDIR",
                             str(REPO / ".accuracy_work"))
    os.makedirs(workdir, exist_ok=True)
    for path in ("f32", "f64"):
        out = Path(workdir) / f"exact_{path}.npz"
        if out.exists() and os.environ.get("GPRAS_ACCURACY_REUSE") == "1":
            print(f"# reusing {out}", file=sys.stderr)
            continue
        code = RUNNER.format(repo=str(REPO), path=path, workdir=workdir)
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=float(os.environ.get(
                                  "GPRAS_ACCURACY_TIMEOUT", "3600")))
        if "EXACT_OK" not in proc.stdout:
            raise SystemExit(f"exact path {path} failed:\n{proc.stderr[-2000:]}")
        print(f"# {path} done", file=sys.stderr)

    import numpy as np

    from gpras_tpu import accuracy

    f32 = dict(np.load(Path(workdir) / "exact_f32.npz"))
    f64 = dict(np.load(Path(workdir) / "exact_f64.npz"))
    summary = accuracy.summarize_exact(f32, f64)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

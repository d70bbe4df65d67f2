"""chip_smoke.py: its refusal to run without a GPU, and every phase's
control flow and comparisons at tiny sizes on the CPU (kernels in
interpret mode; engine thresholds lowered so the tiny problems take the
same engines as the full-size ones)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    return proc.returncode != 0 and '"ok"' not in proc.stdout


def test_refuses_without_gpu():
    proc = _run(REPO)
    assert _no_result(proc), proc.stdout[-500:]
    assert "no GPU" in proc.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    assert _no_result(_run(tmp_path))


def test_phase_kernels_interpret():
    chip_smoke.phase_kernels(n_kmv=300, r=5, n_kgrad=200, probes=8,
                             interpret=True)


@pytest.fixture()
def small_ladder(monkeypatch):
    """Engine thresholds scaled down: N=512 takes the Hutchinson engine and
    anything above 768 goes matrix-free, as 49k and 131k do on the card."""
    from gpras_tpu.gp import model

    monkeypatch.setattr(model.GPRAS, "LEAN_THRESHOLD", 64)
    monkeypatch.setattr(model.GPRAS, "SUPER_THRESHOLD", 128)
    monkeypatch.setattr(model, "dense_n_max", lambda: 768)


def test_phase_exact_small(small_ladder):
    chip_smoke.phase_exact(n=512, n_test=64, steps=3)


def test_phase_cg_small(small_ladder):
    chip_smoke.phase_cg(n=1024, steps=2, probes=8)


def test_phase_serve_small():
    chip_smoke.phase_serve(events=(6, 3), timesteps=8, grid=(24, 16),
                           max_modes=4, n_inducing=16, iters=5)


def test_phase_four_cards_small():
    """The four-card path on the virtual CPU devices."""
    chip_smoke.phase_four_cards(n_cg=512, n_hutch=256, n_query=16, steps=2)

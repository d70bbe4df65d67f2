"""What the package decides from the device it finds: the dense-engine
memory ceiling and the exact engine ladder built on it, the compile-cache
placement, and the host packages the device path imports."""

import os
import subprocess
import sys

import pytest

from gpras_tpu.gp import exact_stochastic
from gpras_tpu.gp.model import GPRAS

#: what one 80 GB H100 grants a JAX process (three quarters of its memory)
H100_BYTES_LIMIT = 63_763_120_128


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_bytes_limit_reads_memory_stats(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(
        {"bytes_limit": H100_BYTES_LIMIT, "bytes_in_use": 5})])
    assert exact_stochastic.device_bytes_limit() == H100_BYTES_LIMIT


def test_device_bytes_limit_falls_back_to_host_memory(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(None)])
    host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert exact_stochastic.device_bytes_limit() == host


@pytest.mark.parametrize("bytes_limit", [16 * 2**30, H100_BYTES_LIMIT,
                                         4 * H100_BYTES_LIMIT])
def test_dense_n_max_rule(bytes_limit):
    """DENSE_BYTES_PER_ENTRY * N^2 fits the limit; one more row does not."""
    n = exact_stochastic.dense_n_max(bytes_limit)
    per = exact_stochastic.DENSE_BYTES_PER_ENTRY
    assert per * n * n <= bytes_limit < per * (n + 1) ** 2


@pytest.mark.parametrize("n,engine", [
    (4096, "dense"),
    (12288, "lean"),
    (49152, "hutchinson"),    # the headline fit: dense Gram on one card
    (81920, "hutchinson"),    # Gram + factor: 53.7 GB of 63.8
    (98304, "cg"),            # Gram + factor would be 77.3 GB
    (131072, "cg"),
])
def test_auto_ladder_on_one_h100(monkeypatch, n, engine):
    monkeypatch.setattr(exact_stochastic, "device_bytes_limit",
                        lambda: H100_BYTES_LIMIT)
    model = GPRAS("Matern52", model_type="exact")
    assert model._single_device_engine(n) == engine


def test_auto_ladder_follows_device_memory(monkeypatch):
    """The same N goes matrix-free on a device with a quarter the memory."""
    monkeypatch.setattr(exact_stochastic, "device_bytes_limit",
                        lambda: H100_BYTES_LIMIT // 4)
    model = GPRAS("Matern52", model_type="exact")
    assert model._single_device_engine(32768) == "hutchinson"
    assert model._single_device_engine(49152) == "cg"


def test_explicit_engine_is_kept(monkeypatch):
    monkeypatch.setattr(exact_stochastic, "device_bytes_limit", lambda: 1)
    model = GPRAS("Matern52", model_type="exact", exact_engine="hutchinson")
    assert model._single_device_engine(131072) == "hutchinson"


def test_compile_cache_respects_environment(monkeypatch, tmp_path):
    import jax

    from gpras_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_directory(monkeypatch):
    from gpras_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")


def test_device_path_imports_no_host_io_packages():
    """The fit, EOF, serving and metric modules load without pandas, h5py,
    matplotlib or pyarrow (the HEC-RAS file layer alone needs them)."""
    code = ("import sys, gpras_tpu.gp.model, gpras_tpu.eof.preprocessor, "
            "gpras_tpu.gp.serving, gpras_tpu.metrics; "
            "print(sorted(m for m in ('pandas', 'h5py', 'matplotlib', "
            "'pyarrow') if m in sys.modules))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]", out.stdout

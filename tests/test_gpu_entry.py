"""The GPU entry points' CPU-testable parts: the device check of bench.py
and chip_smoke.py, the compile-cache location, and chip_smoke's phases
rehearsed at refine=0.5 on the CPU (kernel in the Pallas interpreter)."""

from types import SimpleNamespace

import pytest
import jax

import chip_smoke
from femo_tpu.utils import cache
from femo_tpu.utils.device import require_gpu


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.parametrize("entry", ["bench", "chip_smoke"])
def test_entry_points_refuse_cpu(entry, capsys):
    """bench.py and chip_smoke.py stop before any measurement and print
    no result line when JAX finds no GPU."""
    mod = __import__(entry)
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.main() if entry == "bench" else mod.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache.cache_dir() == cache.REPO_CACHE_DIR
    assert cache.REPO_CACHE_DIR.endswith(".jax_cache")


def test_cache_noop_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.enable_persistent_cache() is None
    assert calls == []


@pytest.mark.parametrize("env", [True, False])
def test_cache_on_gpu_sets_only_the_fixed_path(monkeypatch, tmp_path, env):
    """On a GPU: with JAX_COMPILATION_CACHE_DIR set, JAX's own reading of
    it governs and no directory is set here; without it, the fixed
    in-checkout path is set."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(cache, "REPO_CACHE_DIR", str(tmp_path / "c"))
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_persistent_cache(SimpleNamespace(platform="gpu"))
    if env:
        assert got == str(tmp_path) and calls == []
    else:
        assert got == str(tmp_path / "c")
        assert calls == [("jax_compilation_cache_dir", got)]
        assert (tmp_path / "c").is_dir()


def test_chip_smoke_phase_f64_vs_cpu_rehearsal():
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.phase_motor_f64_vs_cpu(0.5, cpu, cpu)
    assert r["nb"]["mm"]["B"] == 128


def test_chip_smoke_phase_recipe_rehearsal():
    r = chip_smoke.phase_motor_recipe(0.5, jax.devices("cpu")[0], n_rep=1)
    assert abs(r["loss"] - 28.349221547988982) < 1e-3 * 28.35


def test_chip_smoke_phase_sweep_kernel_rehearsal():
    rows = chip_smoke.phase_sweep_kernel([(11, 128), (3, 64)],
                                         interpret=True, n_rep=1)
    assert [(r["nb"], r["B"]) for r in rows] == [(3, 64), (11, 128)]

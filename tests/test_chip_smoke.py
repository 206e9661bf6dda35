"""chip_smoke.py's phases at tiny sizes, its GPU requirement, and the
compile-cache helper the entry-point scripts share."""

import os

import numpy as np
import pytest

import chip_smoke
from muse_tpu.utils import compile_cache


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_grf_northstar_phase_tiny():
    gates, info = chip_smoke.grf_northstar(n=32, nsims=8, max_batch=128)
    assert gates["|theta-mle|"]["ok"], gates
    # σ from 8 sims scatters by tens of percent: only its finiteness and
    # J ≈ H up to that scatter are checked at this size
    assert np.isfinite(gates["sigma/sigma_F"]["value"])
    assert 0.5 < info["J"] / info["H"] < 2.0, info
    assert info["iterations"] >= 2


def test_funnel_ppl_phase():
    gates, info = chip_smoke.funnel_ppl(dim=512, nsims=100)
    assert all(g["ok"] for g in gates.values()), gates


def test_bandpower_phase_tiny():
    gates, _ = chip_smoke.bandpower(n=32, nbands=5, nsims=8)
    assert all(g["ok"] for g in gates.values()), gates


def test_run_phase_raises_on_failed_gate(capsys):
    def phase():
        return {"x": chip_smoke.gate(2.0, False, "< 1")}, {}
    with pytest.raises(chip_smoke.GateFailed, match="x"):
        chip_smoke.run_phase("demo", phase)
    assert "x=2 (< 1) FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("env", [None, "/some/cache/dir"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert compile_cache.compile_cache_dir() == os.path.join(
            repo, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compile_cache.compile_cache_dir() == env

"""`chip_smoke.py` and the helpers it shares with the benchmarks: the
device check, the compile-cache location, phase selection, and every phase
run at a small size on the CPU (the full-size run needs the card)."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from pbmm_tpu.config import MagnifyConfig  # noqa: E402
from pbmm_tpu.utils import cache, device  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _gpu(kind=H100):
    return SimpleNamespace(platform="gpu", device_kind=kind)


class TestDeviceCheck:
    def test_refuses_cpu_platform(self):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            cs.phase_device(jax.devices())

    def test_refuses_no_devices(self):
        with pytest.raises(RuntimeError, match="no devices"):
            device.require_gpu([])

    def test_accepts_gpu_and_prints_card(self, monkeypatch, capsys):
        monkeypatch.setattr(device, "gpu_name_and_power_limit",
                            lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
        info = cs.phase_device([_gpu()])
        assert info == {"platform": "gpu", "kind": H100, "count": 1}
        out = capsys.readouterr().out
        assert "nvidia-smi: NVIDIA H100 80GB HBM3, 700.00 W" in out

    def test_four_needs_four_cards(self, monkeypatch):
        monkeypatch.setattr(device, "gpu_name_and_power_limit", lambda: "x")
        with pytest.raises(RuntimeError, match="needs 4 GPUs"):
            cs.phase_device([_gpu(), _gpu()], n_required=4)

    def test_nvidia_smi_query(self, monkeypatch):
        seen = {}

        def run(cmd, **kw):
            seen["cmd"] = cmd
            return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

        monkeypatch.setattr(device.subprocess, "run", run)
        assert device.gpu_name_and_power_limit() == \
            "NVIDIA H100 80GB HBM3, 700.00 W"
        assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]

    @pytest.mark.parametrize("argv", [[], ["--four"]])
    def test_main_on_cpu_fails_without_a_result(self, argv, capsys):
        assert cs.main(argv) != 0
        assert '"ok"' not in capsys.readouterr().out


class TestCompileCache:
    def test_follows_env_var(self):
        env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
        assert cache.compile_cache_dir(env) == "/some/cache"

    def test_falls_back_to_checkout(self):
        assert cache.compile_cache_dir({}) == str(ROOT / ".jax_cache")

    def test_empty_env_var_falls_back(self):
        env = {"JAX_COMPILATION_CACHE_DIR": ""}
        assert cache.compile_cache_dir(env) == str(ROOT / ".jax_cache")

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        try:
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestPhaseSelection:
    def test_four_selects_only_its_phase(self):
        assert cs.phases(cs.parse_args(["--four"])) == ("device", "four")

    def test_default_runs_the_one_card_phases(self):
        assert cs.phases(cs.parse_args([])) == (
            "device", "compile", "e2e", "parity")


def test_smoke_clip_moves_subpixel():
    clip = cs.smoke_clip(40, 64, 3)
    assert clip.shape == (3, 40, 64, 3) and clip.dtype == np.float32
    assert 0.0 <= clip.min() and clip.max() <= 1.0
    step = np.abs(np.diff(clip, axis=0)).mean()
    assert 0.0 < step < 0.05


def test_compile_phase_reports_both_geometries():
    mem = cs.phase_compile(40, 64, 4)
    assert set(mem) == {"tight", "square_pow2"}
    assert all(m.argument_size_in_bytes > 0 for m in mem.values())


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    frames = cs.smoke_clip(72, 96, 8)
    return cs.phase_e2e(frames, MagnifyConfig(pad_mode="tight"),
                        str(tmp_path_factory.mktemp("smoke")),
                        chunks=2)


def test_e2e_phase_runs_every_mode(small_runs):
    assert set(small_runs) == {"default", "standard", "orientations=4",
                               "chroma=rgb", "iir", "planar_u8"}
    _, src, out = small_runs["planar_u8"]
    assert src.dtype == out.dtype == np.uint8 and out.shape == src.shape


@pytest.mark.parametrize("mode", ["default", "standard", "orientations=4",
                                  "chroma=rgb", "iir", "planar_u8"])
def test_parity_phase_per_mode(small_runs, mode):
    got = cs.phase_parity({mode: small_runs[mode]})
    assert got[mode] >= cs.PARITY_DB


def test_parity_phase_fails_below_the_bar(small_runs):
    cfg, src, out = small_runs["default"]
    broken = np.clip(out + 0.05, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="parity default"):
        cs.phase_parity({"default": (cfg, src, broken)})


def test_four_phase_on_virtual_devices():
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices (conftest provides 8 virtual CPUs)")
    got = cs.phase_four(jax.devices(), 72, 96, 4)
    assert set(got) == {"data_frame", "frame_rows"}
    assert all(db >= cs.SHARDED_DB for db in got.values())


@pytest.mark.gpu
def test_one_card_phases_on_gpu(gpu_device, tmp_path):
    """Phases 2-4 at a small size, compiled for the card."""
    assert cs.phase_compile(72, 96, 8)
    runs = cs.phase_e2e(cs.smoke_clip(72, 96, 8),
                        MagnifyConfig(pad_mode="tight"), str(tmp_path),
                        chunks=2)
    assert len(cs.phase_parity(runs)) == 6


@pytest.mark.gpu
def test_result_line_names_the_gpu(gpu_device, monkeypatch, capsys):
    monkeypatch.setattr(cs, "HEIGHT", 72)
    monkeypatch.setattr(cs, "WIDTH", 96)
    monkeypatch.setattr(cs, "CHUNK", 8)
    assert cs.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["kind"] == gpu_device.device_kind

"""The measurement scripts: each refuses to run without a GPU (a number
from the CPU is never printed under a device metric), and the stage byte
model tracks the geometry."""

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@pytest.mark.parametrize("module,argv", [
    ("bench", None),
    ("benchmarks.run_suite", []),
    ("benchmarks.profile_stages", []),
    ("benchmarks.spatial_bench", None),
])
def test_refuses_cpu(module, argv, capsys):
    mod = importlib.import_module(module)
    rc = mod.main() if argv is None else mod.main(argv)
    assert rc == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_stage_bytes_model_1080p_tight():
    from benchmarks.profile_stages import stage_bytes
    from pbmm_tpu.config import MagnifyConfig

    b = stage_bytes(1080, 1920, MagnifyConfig(pad_mode="tight"))
    plane = 1152 * 2048 * 4
    spec = 1152 * 1025 * 8
    assert b["pbmm.fft"] == plane + spec
    assert b["pbmm.phase_amplify"] == 3 * spec
    assert b["pbmm.ifft"] == spec + plane
    rgb = b["pbmm.preprocess"] - plane - 2 * 1080 * 1920 * 4
    assert rgb == 3 * 1080 * 1920 * 4
    # chroma="rgb" transforms three planes and carries no original I/Q.
    b3 = stage_bytes(1080, 1920, MagnifyConfig(pad_mode="tight",
                                               chroma="rgb"))
    assert b3["pbmm.fft"] == 3 * b["pbmm.fft"]


def test_hbm_table_rejects_unknown_device():
    from benchmarks.profile_stages import hbm_tbps

    assert hbm_tbps("NVIDIA H100 80GB HBM3") == 3.35
    with pytest.raises(ValueError, match="no HBM bandwidth"):
        hbm_tbps("cpu")

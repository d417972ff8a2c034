"""CLI surface tests."""

import numpy as np
import pytest

from pbmm_tpu.cli import main
from pbmm_tpu.io.video import load_video, save_video
from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob


def test_cli_magnifies_npy(tmp_path):
    clip = oscillating_gaussian_blob(height=32, width=32, frames=6)
    inp = tmp_path / "in.npy"
    outp = tmp_path / "out.npy"
    np.save(inp, clip)
    rc = main(["--input", str(inp), "--output", str(outp),
               "--phase-scale", "5"])
    assert rc == 0
    out = np.load(outp)
    assert out.shape == clip.shape
    assert np.isfinite(out).all()


def test_cli_demo_and_scan_engine(tmp_path):
    outp = tmp_path / "out.npz"
    rc = main(["--demo", "blob", "--output", str(outp)])
    assert rc == 0
    out = load_video(str(outp))
    assert out.ndim == 4


def test_cli_checkpoint_roundtrip(tmp_path):
    clip = oscillating_gaussian_blob(height=32, width=32, frames=8)
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    np.save(a, clip[:4])
    np.save(b, clip[4:])
    ck = tmp_path / "state.npz"
    out1, out2 = tmp_path / "o1.npy", tmp_path / "o2.npy"
    assert main(["--input", str(a), "--output", str(out1),
                 "--checkpoint", str(ck)]) == 0
    assert ck.exists()
    assert main(["--input", str(b), "--output", str(out2),
                 "--checkpoint", str(ck)]) == 0
    resumed = np.concatenate([np.load(out1), np.load(out2)])

    whole = tmp_path / "whole.npy"
    outw = tmp_path / "ow.npy"
    np.save(whole, clip)
    assert main(["--input", str(whole), "--output", str(outw)]) == 0
    np.testing.assert_allclose(resumed, np.load(outw), atol=1e-5)


def test_cli_rejects_missing_input(tmp_path, capsys):
    rc = main(["--output", str(tmp_path / "o.npy")])
    assert rc == 2
    assert "exactly one of" in capsys.readouterr().err


def test_cli_rejects_bad_shape(tmp_path, capsys):
    inp = tmp_path / "bad.npy"
    np.save(inp, np.zeros((4, 8, 8)))  # missing channel dim
    rc = main(["--input", str(inp), "--output", str(tmp_path / "o.npy")])
    assert rc == 2
    assert "expected (T, H, W, 3)" in capsys.readouterr().err


def test_cli_no_magnify_passthrough(tmp_path):
    clip = oscillating_gaussian_blob(height=32, width=32, frames=4)
    inp, outp = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(inp, clip)
    rc = main(["--input", str(inp), "--output", str(outp), "--no-magnify"])
    assert rc == 0
    np.testing.assert_allclose(np.load(outp), clip, atol=1e-6)


def test_cli_quirk_and_backend_flags(tmp_path):
    """Every inspector-surface flag drives the config it names."""
    from pbmm_tpu.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["--output", "o.npy", "--fft-backend", "mxu", "--blur-size",
         "0.75", "--compensate-window", "--no-cache-prev-spectrum",
         "--apply-magnitude-scale", "--magnitude-scale", "1.5",
         "--yiq-gains", "1.1", "0.9", "1.0"]
    )
    cfg = config_from_args(args)
    assert cfg.fft_backend == "mxu" and cfg.use_rfft is True
    assert cfg.blur_size == 0.75
    assert cfg.compensate_window is True
    assert cfg.cache_prev_spectrum is False
    assert cfg.apply_magnitude_scale is True and cfg.magnitude_scale == 1.5
    assert cfg.apply_yiq_gains is True
    assert cfg.yiq_gains == (1.1, 0.9, 1.0)

    args = build_parser().parse_args(["--output", "o.npy", "--full-spectrum"])
    assert config_from_args(args).use_rfft is False


def test_cli_full_spectrum_runs(tmp_path):
    clip = oscillating_gaussian_blob(height=24, width=24, frames=3)
    inp, outp = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(inp, clip)
    rc = main(["--input", str(inp), "--output", str(outp),
               "--full-spectrum", "--blur-size", "0.5"])
    assert rc == 0
    assert np.isfinite(np.load(outp)).all()


def test_cli_trace_writes_profile(tmp_path):
    clip = oscillating_gaussian_blob(height=24, width=24, frames=3)
    inp, outp = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(inp, clip)
    logdir = tmp_path / "trace"
    rc = main(["--input", str(inp), "--output", str(outp),
               "--trace", str(logdir)])
    assert rc == 0
    assert logdir.exists() and any(logdir.rglob("*"))


def test_save_load_roundtrip_uint8(tmp_path):
    frames = (np.random.default_rng(0).random((2, 4, 4, 3)) * 255).astype(
        np.uint8
    )
    p = tmp_path / "v.npy"
    np.save(p, frames)
    loaded = load_video(str(p))
    assert loaded.dtype == np.float32
    assert loaded.max() <= 1.0


def test_save_video_npz(tmp_path):
    frames = np.zeros((2, 4, 4, 3), np.float32)
    p = tmp_path / "v.npz"
    save_video(str(p), frames)
    assert load_video(str(p)).shape == frames.shape

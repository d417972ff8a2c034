"""Planar / uint8 ingestion-emission paths.

Input may be (T, 3, H, W) channel-planar uint8 (the y4m/video-file
native layout).  `output_layout` selects interleaved f32 (the reference
texture contract), planar f32, or planar uint8.

All paths are bit-exact vs the classic interleaved path (u8 output:
exact after the same round(255 x) quantization).
"""

import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.engine.video import magnify_video


@pytest.fixture
def clips(rng):
    base = (rng.random((120, 128, 3)) * 255).astype(np.uint8)
    inter = np.stack([np.roll(base, shift=i, axis=1) for i in range(5)])
    planar = np.moveaxis(inter, -1, 1).copy()
    return inter, planar


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _cfg():
    return MagnifyConfig(phase_scale=10.0)


class TestPlanarInput:
    def test_planar_u8_equals_interleaved(self, clips):
        inter, planar = clips
        ref, _ = magnify_video(inter, _cfg())
        out, _ = magnify_video(planar, _cfg())
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_planar_iir_equals_interleaved(self, clips):
        inter, planar = clips
        cfg = _cfg().replace(temporal=TemporalConfig(mode="iir_bandpass"))
        ref, _ = magnify_video(inter, cfg)
        out, _ = magnify_video(planar, cfg)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_planar_chunk_threading(self, clips):
        inter, planar = clips
        ref, _ = magnify_video(inter, _cfg())
        o1, s = magnify_video(planar[:3], _cfg())
        o2, _ = magnify_video(planar[3:], _cfg(), s)
        got = np.concatenate([np.asarray(o1), np.asarray(o2)])
        np.testing.assert_array_equal(got, np.asarray(ref))

    def test_planar_scan_fallback(self, clips):
        # Planar f32 input takes the same conversion path as planar u8.
        inter, planar = clips
        cfg = _cfg()
        ref, _ = magnify_video(inter.astype(np.float32) / 255.0, cfg)
        out, _ = magnify_video(planar.astype(np.float32) / 255.0, cfg)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-6)


class TestOutputLayout:
    def test_planar_f32(self, clips):
        inter, planar = clips
        ref, _ = magnify_video(inter, _cfg())
        out, _ = magnify_video(planar, _cfg().replace(
            output_layout="planar"))
        assert out.shape == (5, 3, 120, 128)
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(out), 1, -1), np.asarray(ref))

    def test_planar_u8_quantized(self, clips):
        inter, planar = clips
        ref, _ = magnify_video(inter, _cfg())
        out, _ = magnify_video(planar, _cfg().replace(
            output_layout="planar_u8"))
        assert out.dtype == np.uint8
        want = np.round(np.asarray(ref) * 255.0).astype(np.uint8)
        got = np.moveaxis(np.asarray(out), 1, -1)
        assert int(np.max(np.abs(got.astype(int) - want.astype(int)))) == 0

    def test_interleaved_in_planar_out(self, clips):
        inter, _ = clips
        f32 = inter.astype(np.float32) / 255.0
        ref, _ = magnify_video(f32, _cfg())
        out, _ = magnify_video(f32, _cfg().replace(output_layout="planar"))
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(out), 1, -1), np.asarray(ref))

    def test_tight_planar_u8_pipeline(self, rng):
        # The full production combo: tight geometry + planar u8 in +
        # planar u8 out.
        base = (rng.random((300, 256, 3)) * 255).astype(np.uint8)
        inter = np.stack([np.roll(base, i, axis=1) for i in range(4)])
        planar = np.moveaxis(inter, -1, 1).copy()
        cfg = _cfg().replace(pad_mode="tight")
        ref, _ = magnify_video(inter, cfg)
        out, _ = magnify_video(planar, cfg.replace(
            output_layout="planar_u8"))
        want = np.round(np.asarray(ref) * 255.0).astype(np.uint8)
        got = np.moveaxis(np.asarray(out), 1, -1)
        assert int(np.max(np.abs(got.astype(int) - want.astype(int)))) == 0

    def test_bypass_respects_layout(self, clips):
        _, planar = clips
        cfg = _cfg().replace(apply_motion_magnification=False,
                             output_layout="planar_u8")
        out, _ = magnify_video(planar, cfg)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(np.asarray(out), planar)

"""Tight-height geometry (pad_mode="tight") through the streaming engine.

The reference pads 1080p to 2048^2 only because its radix-2 FFT needs a
power of two (`MotionMagnificationProcessor.cs:298-302,531-535`); SURVEY
§7.3 opens tighter geometry.  "tight" pads the height to the smallest
multiple of 128 (1080 -> 1152 = 9*128, 0.5625x the pixels); the FFT
library transforms the mixed-radix height directly.
"""

import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.reference import (
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.utils.metrics import psnr


@pytest.fixture
def clip():
    # 300 rows -> tight pad 384 = 3*128: a non-pow2 height; width 256
    # stays pow2.
    return oscillating_bar(size=256, frames=6, bar_width=2)[:, :300]


def _base():
    return MagnifyConfig(phase_scale=10.0, pad_mode="tight")


class TestTightEngine:
    def test_two_frame_vs_oracle(self, clip):
        out, _ = magnify_video(clip, _base())
        assert psnr(np.asarray(out), oracle_magnify_video(clip, _base())) \
            > 100

    def test_iir_vs_oracle(self, clip):
        cfg = _base().replace(temporal=TemporalConfig(mode="iir_bandpass"))
        out, _ = magnify_video(clip, cfg)
        assert psnr(np.asarray(out), oracle_magnify_video_iir(clip, cfg)) \
            > 100

    def test_steerable_vs_oracle(self, clip):
        cfg = _base().replace(orientations=4)
        out, _ = magnify_video(clip, cfg)
        assert psnr(np.asarray(out), oracle_magnify_video(clip, cfg)) > 100

    def test_standard_vs_oracle(self, clip):
        cfg = _base().replace(mode="standard")
        out, _ = magnify_video(clip, cfg)
        assert psnr(np.asarray(out), oracle_magnify_video(clip, cfg)) > 100

    def test_xla_backend_tight_vs_oracle(self, clip):
        # The generic XLA path handles non-pow2 geometry outright — an
        # independent check of the tight geometry itself.
        cfg = MagnifyConfig(phase_scale=10.0).replace(pad_mode="tight")
        out, _ = magnify_video(clip, cfg)
        assert psnr(np.asarray(out), oracle_magnify_video(clip, cfg)) > 100

    def test_chunk_threading_bit_exact(self, clip):
        cfg = _base()
        out_all, _ = magnify_video(clip, cfg)
        o1, s = magnify_video(clip[:3], cfg)
        o2, _ = magnify_video(clip[3:], cfg, s)
        got = np.concatenate([np.asarray(o1), np.asarray(o2)])
        np.testing.assert_array_equal(np.asarray(out_all), got)

    def test_rgb_vs_oracle_and_xla(self, clip):
        cfg = _base().replace(chroma="rgb")
        out, _ = magnify_video(clip, cfg)
        # Direct fp64-oracle parity (the oracle amplifies all three YIQ
        # planes since r5 — see tests/test_rgb_parity.py).
        assert psnr(np.asarray(out),
                    oracle_magnify_video(clip, cfg)) > 60
        cfg_x = MagnifyConfig(phase_scale=10.0).replace(
            pad_mode="tight", chroma="rgb")
        ref, _ = magnify_video(clip, cfg_x)
        assert psnr(np.asarray(out), np.asarray(ref)) > 60

    def test_tight_mxu_backend_rejected(self):
        with pytest.raises(ValueError, match="tight"):
            MagnifyConfig(pad_mode="tight", fft_backend="mxu",
                          use_rfft=True)

    def test_geometry(self):
        from pbmm_tpu.core.window import geometry_for

        g = geometry_for(1080, 1920, "tight")
        assert (g.pad_h, g.pad_w) == (1152, 2048)
        assert (g.y0, g.x0) == (36, 64)
        g = geometry_for(720, 1280, "tight")
        assert (g.pad_h, g.pad_w) == (768, 2048)

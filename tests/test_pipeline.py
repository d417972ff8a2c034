"""End-to-end parity: the jitted pipeline vs the numpy oracle
(SURVEY.md §4b; BASELINE config 1 — 128x128 oscillating bar).

The contract is PSNR-based, not bit-exact (fp32 atan2/sincos ULP differences
accumulate through the FFT; SURVEY.md §7.3) — but on CPU fp32 vs fp64 oracle
the agreement should be far above the 35 dB target."""

import jax
import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.pipeline import magnify_frame_pair
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.reference import oracle_magnify_pair, oracle_magnify_video
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.utils.metrics import psnr


FRAMES = oscillating_bar(size=128, frames=6)


def _pair_psnr(cfg) -> float:
    fn = jax.jit(magnify_frame_pair, static_argnums=2)
    got = np.asarray(fn(FRAMES[2], FRAMES[3], cfg))
    want = oracle_magnify_pair(FRAMES[2], FRAMES[3], cfg)
    return psnr(got, want)


class TestPairParity:
    def test_pyramid_default(self):
        assert _pair_psnr(MagnifyConfig()) > 55.0

    def test_pyramid_scene_params(self):
        assert _pair_psnr(MagnifyConfig.scene_defaults()) > 55.0

    def test_standard_mode(self):
        assert _pair_psnr(MagnifyConfig(mode="standard")) > 55.0

    def test_standard_no_bandpass(self):
        assert _pair_psnr(MagnifyConfig(mode="standard", apply_bandpass=False)) > 55.0

    def test_real_reconstruction(self):
        assert _pair_psnr(MagnifyConfig(reconstruct="real")) > 55.0

    def test_high_scale(self):
        assert _pair_psnr(MagnifyConfig(phase_scale=25.0)) > 50.0

    def test_steerable_orientations_vs_oracle(self):
        # The steerable angular extension against its independent fp64
        # oracle (`oracle.reference.steerable_mask_planes` — direct
        # formulas, no shared code): pins the production bank's VALUES
        # end-to-end, not just its partition-of-unity algebra.
        assert _pair_psnr(MagnifyConfig(orientations=4)) > 55.0

    def test_steerable_many_orientations_vs_oracle(self):
        assert _pair_psnr(
            MagnifyConfig(orientations=8, pyramid_levels=4)) > 55.0

    def test_steerable_fused_kernel_vs_oracle_256(self):
        # The steerable path (sector windows evaluated procedurally inside
        # the fused phase pass) against the independent fp64 oracle at
        # 256 px.
        frames = oscillating_bar(size=256, frames=4)
        fn = jax.jit(magnify_frame_pair, static_argnums=2)
        for k_or, levels in ((4, 5), (8, 4)):
            cfg = MagnifyConfig(orientations=k_or, pyramid_levels=levels)
            got = np.asarray(fn(frames[2], frames[3], cfg))
            want = oracle_magnify_pair(frames[2], frames[3], cfg)
            assert psnr(got, want) > 100.0, (k_or, levels)

    def test_rect_padding(self):
        frames = oscillating_bar(size=96, frames=4)  # pads 96->128 square
        cfg = MagnifyConfig(pad_mode="rect_pow2")
        got = np.asarray(magnify_frame_pair(frames[1], frames[2], cfg))
        want = oracle_magnify_pair(frames[1], frames[2], cfg)
        assert psnr(got, want) > 55.0

    def test_magnification_actually_magnifies(self):
        # Output with scale=10 must differ from scale-0 output where motion is.
        cfg0 = MagnifyConfig(phase_scale=0.0)
        cfg10 = MagnifyConfig(phase_scale=10.0)
        out0 = np.asarray(magnify_frame_pair(FRAMES[2], FRAMES[3], cfg0))
        out10 = np.asarray(magnify_frame_pair(FRAMES[2], FRAMES[3], cfg10))
        assert np.abs(out10 - out0).max() > 0.01


class TestVideoParity:
    def test_video_matches_oracle_video(self):
        cfg = MagnifyConfig()
        out, _ = magnify_video(FRAMES, cfg)
        want = oracle_magnify_video(FRAMES, cfg)
        assert psnr(np.asarray(out), want) > 55.0

    def test_first_frame_passthrough(self):
        cfg = MagnifyConfig()
        out, _ = magnify_video(FRAMES, cfg)
        np.testing.assert_allclose(np.asarray(out[0]), FRAMES[0], atol=1e-6)

    def test_cache_vs_nocache_identical(self):
        # Caching the previous spectrum must be mathematically equivalent to
        # the reference's re-FFT of the previous frame (SURVEY.md §7.0).
        cfg_c = MagnifyConfig(cache_prev_spectrum=True)
        cfg_n = MagnifyConfig(cache_prev_spectrum=False)
        out_c, _ = magnify_video(FRAMES, cfg_c)
        out_n, _ = magnify_video(FRAMES, cfg_n)
        assert psnr(np.asarray(out_c), np.asarray(out_n)) > 70.0

    def test_video_step_equals_pair_for_two_frame_mode(self):
        cfg = MagnifyConfig()
        out, _ = magnify_video(FRAMES[:3], cfg)
        pair = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        assert psnr(np.asarray(out[2]), pair) > 70.0

    def test_chunked_streaming_equals_whole(self):
        cfg = MagnifyConfig()
        whole, _ = magnify_video(FRAMES, cfg)
        first, st = magnify_video(FRAMES[:3], cfg)
        rest, _ = magnify_video(FRAMES[3:], cfg, state=st)
        chunked = np.concatenate([np.asarray(first), np.asarray(rest)])
        np.testing.assert_allclose(chunked, np.asarray(whole), atol=1e-5)

    def test_uint8_ingestion(self):
        # 8-bit frames are first-class (r4): scaled by 1/255 on device
        # (`core.color.unit_float`), quartering host->device transfer for
        # real video sources.  Equivalent to pre-scaled f32 to fp
        # rounding; frame-0 passthrough and bypass emit [0,1] f32.
        f_u8 = np.round(FRAMES * 255).astype(np.uint8)
        out_u8, _ = magnify_video(f_u8, MagnifyConfig())
        out_f32, _ = magnify_video(f_u8.astype(np.float32) / 255.0,
                                   MagnifyConfig())
        assert np.asarray(out_u8).dtype == np.float32
        assert psnr(np.asarray(out_u8), np.asarray(out_f32)) > 100.0
        byp, _ = magnify_video(
            f_u8, MagnifyConfig(apply_motion_magnification=False))
        assert float(np.asarray(byp).max()) <= 1.0 + 1e-5

class TestExtensions:
    def test_chroma_rgb_runs(self):
        cfg = MagnifyConfig(chroma="rgb")
        out = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        assert out.shape == FRAMES[2].shape
        assert np.isfinite(out).all()

    def test_orientations_runs_and_reduces_to_radial_at_scale0(self):
        # With phase_scale=0 the steerable bank must collapse identically to
        # the radial bank (partition of unity) except for gate differences;
        # compare outputs directly.
        cfg_r = MagnifyConfig(phase_scale=0.0)
        cfg_s = MagnifyConfig(phase_scale=0.0, orientations=4)
        out_r = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_r))
        out_s = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_s))
        assert psnr(out_r, out_s) > 60.0

    def test_temporal_iir_runs(self):
        from pbmm_tpu.config import TemporalConfig

        cfg = MagnifyConfig(
            temporal=TemporalConfig(mode="iir_bandpass", low_hz=0.5,
                                    high_hz=5.0, fps=30.0)
        )
        out, st = magnify_video(FRAMES, cfg)
        assert np.isfinite(np.asarray(out)).all()
        # half-spectrum IIR state in the default rfft path
        assert st.temporal.lp_fast.shape == (1, 128, 65)

    def test_window_compensation(self):
        cfg = MagnifyConfig(compensate_window=True)
        out = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        assert np.isfinite(out).all()


class TestQuirkSwitches:
    def test_no_magnify_bypass_pair(self):
        # applyMotionMagnification=false: source blits through untouched
        # (`MotionMagnificationProcessor.cs:126-139`).
        cfg = MagnifyConfig(apply_motion_magnification=False)
        out = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        np.testing.assert_allclose(out, FRAMES[2], atol=0)

    def test_no_magnify_bypass_video_and_state_tracking(self):
        # The bypass still tracks the previous frame so re-enabling mid-
        # stream pairs with the true predecessor (`:142` runs either way).
        cfg_off = MagnifyConfig(apply_motion_magnification=False)
        cfg_on = MagnifyConfig()
        out, st = magnify_video(FRAMES[:3], cfg_off)
        np.testing.assert_allclose(np.asarray(out), FRAMES[:3], atol=0)
        assert int(st.frame_idx) == 3
        rest, _ = magnify_video(FRAMES[3:], cfg_on, state=st)
        # frame 3 must be magnified against frame 2, i.e. match the whole-
        # video run's frame 3.
        whole, _ = magnify_video(FRAMES, cfg_on)
        np.testing.assert_allclose(
            np.asarray(rest[0]), np.asarray(whole[3]), atol=1e-5
        )

    def test_no_magnify_bypass_batched(self):
        from pbmm_tpu.parallel.sharding import magnify_clip_batched

        cfg = MagnifyConfig(apply_motion_magnification=False)
        out = np.asarray(magnify_clip_batched(FRAMES, cfg))
        np.testing.assert_allclose(out, FRAMES, atol=0)

    def test_yiq_gains_unity_is_identity(self):
        cfg_off = MagnifyConfig()
        cfg_on = MagnifyConfig(apply_yiq_gains=True, yiq_gains=(1.0, 1.0, 1.0))
        a = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_off))
        b = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_on))
        np.testing.assert_allclose(a, b, atol=0)

    def test_yiq_gains_zero_blacks_out(self):
        # Gains multiply YIQ right before the RGB matrix
        # (`YIQToRGB.shader:65-70`); zero gains -> zero YIQ -> black.
        cfg = MagnifyConfig(apply_yiq_gains=True, yiq_gains=(0.0, 0.0, 0.0))
        out = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        np.testing.assert_allclose(out, 0.0, atol=1e-7)

    def test_yiq_luma_gain_scales_brightness(self):
        # Doubling only Y must brighten: RGB = M @ (2Y, I, Q) with M's first
        # column all ones -> output = saturate(base + Y).
        from pbmm_tpu.core.color import rgb_to_yiq, yiq_to_rgb

        cfg = MagnifyConfig(apply_yiq_gains=True, yiq_gains=(2.0, 1.0, 1.0),
                            phase_scale=0.0, compensate_window=False)
        base_cfg = MagnifyConfig(phase_scale=0.0)
        out2 = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg))
        out1 = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], base_cfg))
        assert out2.mean() > out1.mean()


class TestRfftPath:
    def test_rfft_equals_full_fft(self):
        # The half-spectrum path must match the full-spectrum chain
        # (Hermitian-symmetry argument in spectral/fft.py docstrings).
        out_r = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2],
                                              MagnifyConfig(use_rfft=True)))
        out_f = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2],
                                              MagnifyConfig(use_rfft=False)))
        assert psnr(out_r, out_f) > 70.0

    def test_rfft_standard_mode_equals_full(self):
        cfg_r = MagnifyConfig(mode="standard", use_rfft=True)
        cfg_f = MagnifyConfig(mode="standard", use_rfft=False)
        out_r = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_r))
        out_f = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_f))
        assert psnr(out_r, out_f) > 70.0

    def test_rfft_steerable_equals_full(self):
        cfg_r = MagnifyConfig(orientations=4, use_rfft=True)
        cfg_f = MagnifyConfig(orientations=4, use_rfft=False)
        out_r = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_r))
        out_f = np.asarray(magnify_frame_pair(FRAMES[1], FRAMES[2], cfg_f))
        assert psnr(out_r, out_f) > 70.0

    def test_rfft_video_iir_equals_full(self):
        from pbmm_tpu.config import TemporalConfig

        tc = TemporalConfig(mode="iir_bandpass", low_hz=0.5, high_hz=5.0,
                            fps=30.0)
        out_r, _ = magnify_video(FRAMES, MagnifyConfig(use_rfft=True,
                                                       temporal=tc))
        out_f, _ = magnify_video(FRAMES, MagnifyConfig(use_rfft=False,
                                                       temporal=tc))
        assert psnr(np.asarray(out_r), np.asarray(out_f)) > 70.0

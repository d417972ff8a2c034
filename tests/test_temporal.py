"""Quantitative validation of the streaming IIR temporal mode (SURVEY.md
§7.1 item 4; BASELINE.json configs 2-5): the fp64 numpy oracle, the
analytic frequency response, and end-to-end frequency selectivity.

VERDICT r2 "Missing #4": the IIR mode was pinned only by finite-output
checks; these tests pin its *values* (oracle PSNR) and its *function*
(band-pass gain curve; in-band motion amplified, DC-velocity drift not).
"""

import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.reference import oracle_magnify_video_iir
from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob, single_tone_bar
from pbmm_tpu.phase.temporal import TemporalState, temporal_apply, temporal_init
from pbmm_tpu.utils.metrics import psnr

IIR = TemporalConfig(mode="iir_bandpass", low_hz=0.4, high_hz=3.0, fps=30.0)


def _analytic_gain(tcfg: TemporalConfig, f_hz: float) -> float:
    """|H(e^{i w})| of band = lp_fast - lp_slow, each lp a one-pole
    y += r (x - y)  =>  H_r(z) = r / (1 - (1-r) z^-1)."""
    r_hi, r_lo = tcfg.smoothing_factors()
    w = 2.0 * np.pi * f_hz / tcfg.fps
    z1 = np.exp(-1j * w)
    h = r_hi / (1 - (1 - r_hi) * z1) - r_lo / (1 - (1 - r_lo) * z1)
    return float(np.abs(h))


class TestFrequencyResponse:
    """Drive `temporal_apply` with sinusoidal delta streams and compare the
    measured steady-state gain to the analytic transfer function."""

    def _measured_gain(self, f_hz: float, n_settle: int = 120,
                       n_meas: int = 120) -> float:
        tcfg = IIR
        state = temporal_init((1, 1), tcfg)
        state = TemporalState(
            np.zeros((1, 1), np.float32), np.zeros((1, 1), np.float32)
        )
        w = 2.0 * np.pi * f_hz / tcfg.fps
        acc = 0.0 + 0.0j
        for t in range(n_settle + n_meas):
            x = np.float32(np.cos(w * t)) * np.ones((1, 1), np.float32)
            y, state = temporal_apply(x, state, tcfg)
            if t >= n_settle:
                acc += complex(np.asarray(y)[0, 0]) * np.exp(-1j * w * t)
        return abs(acc) * 2.0 / n_meas

    # frequencies chosen as multiples of fps/n_meas = 0.25 Hz so the
    # demodulation window holds an integer number of periods (no leakage)
    @pytest.mark.parametrize("f_hz", [0.25, 0.5, 1.5, 3.0, 10.0, 14.0])
    def test_gain_matches_analytic(self, f_hz):
        got = self._measured_gain(f_hz)
        want = _analytic_gain(IIR, f_hz)
        assert got == pytest.approx(want, rel=0.05, abs=5e-3)

    def test_band_shape(self):
        """In-band gain dominates: the passband peak is well above both the
        low side (DC blocked exactly) and the high side."""
        g_dc = _analytic_gain(IIR, 0.0)
        g_mid = _analytic_gain(IIR, 1.5)
        g_hi = _analytic_gain(IIR, 14.0)
        assert g_dc < 1e-12  # the two low-passes agree exactly at DC
        assert g_mid > 0.5
        assert g_mid > 1.8 * g_hi


class TestIIROracle:
    """The engine's IIR mode vs the fp64 straight-line oracle."""

    @pytest.mark.parametrize("mode", ["pyramid", "standard"])
    def test_engine_matches_oracle(self, mode):
        cfg = MagnifyConfig(mode=mode, temporal=IIR)
        clip = oscillating_gaussian_blob(height=32, width=32, frames=12)
        out, _ = magnify_video(clip, cfg)
        ref = oracle_magnify_video_iir(clip, cfg)
        assert psnr(np.asarray(out), ref.astype(np.float32)) > 55.0

    def test_oracle_reduces_to_two_frame_at_unit_band(self):
        """Sanity on the oracle itself: with the band wide open the filter
        output is a *filtered* delta, not the raw one — so IIR and
        two-frame must genuinely differ (guards against a pass-through
        bug making the PSNR test vacuous)."""
        cfg = MagnifyConfig(temporal=IIR)
        clip = oscillating_gaussian_blob(height=32, width=32, frames=10)
        iir = oracle_magnify_video_iir(clip, cfg)
        from pbmm_tpu.oracle.reference import oracle_magnify_video

        two = oracle_magnify_video(clip, MagnifyConfig())
        assert np.abs(iir - two).max() > 1e-3


def _tone_amplitude(sig: np.ndarray, f_hz: float, fps: float) -> float:
    """Amplitude of the `f_hz` component via complex demodulation."""
    t = np.arange(len(sig))
    sig = sig - sig.mean()
    return 2.0 * abs((sig * np.exp(-2j * np.pi * f_hz * t / fps)).mean())


class TestEndToEndSelectivity:
    """Frequency selectivity of the full pipeline in IIR mode.

    Measurement: the luma modulation at a pixel on the bar's flank is
    linear in the bar's (sub-pixel) displacement, so its amplitude at the
    driving frequency tracks the output motion amplitude.  The absolute
    motion gain mixes in frequency-independent pipeline effects (the
    unamplified skip-end bands dilute it; |z| reconstruction and the
    magnitude gates distort it), so the pinned quantity is the IIR gain
    *normalized by the two-frame gain at the same frequency* — exactly
    the factor the temporal filter contributes.  In-band response must
    survive (ratio > 0.5) while out-of-band motion is suppressed several
    times harder (ratio < 0.35, and > 2.5x smaller than in-band)."""

    FPS = 30.0

    def _motion_gain(self, f_hz: float, cfg) -> float:
        size, settle = 64, 30
        clip = single_tone_bar(size=size, frames=90, fps=self.FPS, f_hz=f_hz)
        out, _ = magnify_video(clip, cfg)
        flank = (size // 2, size // 2 + 2)
        s_in = clip[settle:, flank[0], flank[1], 0]
        s_out = np.asarray(out)[settle:, flank[0], flank[1], 0]
        return _tone_amplitude(s_out, f_hz, self.FPS) / _tone_amplitude(
            s_in, f_hz, self.FPS
        )

    def test_in_band_passes_out_of_band_suppressed(self):
        kw = dict(phase_scale=5.0, compensate_window=True)
        iir_cfg = MagnifyConfig(temporal=IIR, **kw)
        two_cfg = MagnifyConfig(**kw)
        f_in, f_out = 1.5, 10.0  # band is 0.4..3.0 Hz at 30 fps

        ratio_in = self._motion_gain(f_in, iir_cfg) / self._motion_gain(
            f_in, two_cfg
        )
        ratio_out = self._motion_gain(f_out, iir_cfg) / self._motion_gain(
            f_out, two_cfg
        )
        assert ratio_in > 0.5, f"in-band response lost: {ratio_in:.2f}"
        assert ratio_out < 0.35, f"out-of-band leaks: {ratio_out:.2f}"
        assert ratio_in > 2.5 * ratio_out, (
            f"no selectivity: in {ratio_in:.2f} vs out {ratio_out:.2f}"
        )

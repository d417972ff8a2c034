"""chroma="rgb" oracle parity (VERDICT r4 ask 4, resolved in r5).

Round 4 carried a caveat: "rgb measures only ~47 dB vs the fp64 oracle
on every backend (f32-vs-f64 gate knife-edges)".  Investigating the
asked-for gate-replay experiment showed the explanation was WRONG: the
residual did not move when the gates were disabled (tau=0) on both
sides.  The actual cause: the oracle never implemented chroma="rgb" —
`oracle/reference.py::_preprocess` FFT'd only the Y plane and passed
the original I/Q through, so rgb runs (which amplify all three planes)
were being compared against the WRONG spec.  With the oracle extended
to amplify all three YIQ planes in fp64, rgb parity equals y_only
parity on the same clip — there is no rgb-specific accuracy deficit.
"""

import numpy as np

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.reference import (
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.utils.metrics import psnr


def _clip():
    return oscillating_bar(size=256, frames=6, bar_width=2)


def _cfg(**kw):
    return MagnifyConfig(phase_scale=10.0, **kw)


def test_rgb_parity_equals_y_only_parity():
    frames = _clip()
    out_rgb, _ = magnify_video(frames, _cfg(chroma="rgb"))
    p_rgb = psnr(np.asarray(out_rgb),
                 oracle_magnify_video(frames, _cfg(chroma="rgb")))
    out_y, _ = magnify_video(frames, _cfg())
    p_y = psnr(np.asarray(out_y), oracle_magnify_video(frames, _cfg()))
    # rgb is as accurate as y_only against the (now rgb-aware) fp64
    # oracle — the r4 "rgb ~47 dB" caveat was an oracle gap, not a
    # pipeline deficit.
    assert p_rgb > 60
    assert abs(p_rgb - p_y) < 6


def test_rgb_iir_parity():
    frames = _clip()
    cfg = _cfg(chroma="rgb").replace(
        temporal=TemporalConfig(mode="iir_bandpass"))
    out, _ = magnify_video(frames, cfg)
    assert psnr(np.asarray(out),
                oracle_magnify_video_iir(frames, cfg)) > 60


def test_y_only_oracle_values_unchanged():
    # The oracle extension (stacked (C, ph, pw) spectra) must be
    # value-preserving for the reference y_only path.
    frames = _clip()[:4]
    cfg = MagnifyConfig(phase_scale=5.0)
    o = oracle_magnify_video(frames, cfg)
    assert o.shape == frames.shape
    out, _ = magnify_video(frames, cfg)
    assert psnr(np.asarray(out), o) > 60

"""Oracle-parity matrix of the portable engine (`magnify_video`): every
mode x pad geometry x chroma x temporal filter, plus steerable orientations
and the full-spectrum chain, against the fp64 oracle (`oracle/reference.py`);
and chunk threading (state carried across calls) in every mode.

The clip is 300x48 so the three pad geometries differ: square_pow2 512x512,
rect_pow2 512x64, tight 384x64 (a non-pow2 height)."""

import itertools

import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.core.window import geometry_for
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.reference import (
    oracle_magnify_video,
    oracle_magnify_video_iir,
)
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.utils.metrics import psnr

BAR = 55.0  # the repo's parity bar against the fp64 oracle
PADS = ("square_pow2", "rect_pow2", "tight")
IIR = TemporalConfig(mode="iir_bandpass")


@pytest.fixture(scope="module")
def clip():
    # The bar oscillates about the centre column; keep the 48 columns
    # around it.
    return oscillating_bar(size=300, frames=4, bar_width=2)[:, :, 126:174]


def _oracle(frames, cfg):
    if cfg.temporal.mode == "iir_bandpass":
        return oracle_magnify_video_iir(frames, cfg)
    return oracle_magnify_video(frames, cfg)


def test_geometries_differ():
    shapes = {p: geometry_for(300, 48, p)[2:4] for p in PADS}
    assert shapes == {"square_pow2": (512, 512), "rect_pow2": (512, 64),
                      "tight": (384, 64)}


@pytest.mark.parametrize(
    "mode,pad_mode,chroma,temporal",
    list(itertools.product(("pyramid", "standard"), PADS, ("y_only", "rgb"),
                           ("two_frame", "iir_bandpass"))))
def test_matrix_vs_oracle(clip, mode, pad_mode, chroma, temporal):
    cfg = MagnifyConfig(mode=mode, pad_mode=pad_mode, chroma=chroma,
                        temporal=TemporalConfig(mode=temporal))
    out, _ = magnify_video(clip, cfg)
    assert psnr(np.asarray(out), _oracle(clip, cfg)) > BAR


@pytest.mark.parametrize("orientations,pad_mode", [
    (4, "square_pow2"), (4, "rect_pow2"), (4, "tight"),
    (8, "square_pow2"), (8, "rect_pow2"), (8, "tight"),
])
def test_orientations_vs_oracle(clip, orientations, pad_mode):
    cfg = MagnifyConfig(orientations=orientations, pad_mode=pad_mode)
    out, _ = magnify_video(clip, cfg)
    assert psnr(np.asarray(out), _oracle(clip, cfg)) > BAR


@pytest.mark.parametrize("mode,temporal", [
    ("pyramid", "two_frame"), ("pyramid", "iir_bandpass"),
    ("standard", "two_frame"), ("standard", "iir_bandpass"),
])
def test_full_spectrum_vs_oracle(clip, mode, temporal):
    cfg = MagnifyConfig(mode=mode, use_rfft=False, pad_mode="tight",
                        temporal=TemporalConfig(mode=temporal))
    out, _ = magnify_video(clip, cfg)
    assert psnr(np.asarray(out), _oracle(clip, cfg)) > BAR


@pytest.mark.parametrize(
    "mode,temporal,chroma",
    list(itertools.product(("pyramid", "standard"),
                           ("two_frame", "iir_bandpass"),
                           ("y_only", "rgb"))))
def test_chunk_threading_equals_whole(clip, mode, temporal, chroma):
    cfg = MagnifyConfig(mode=mode, pad_mode="tight", chroma=chroma,
                        temporal=TemporalConfig(mode=temporal))
    whole, _ = magnify_video(clip, cfg)
    first, state = magnify_video(clip[:2], cfg)
    rest, _ = magnify_video(clip[2:], cfg, state)
    got = np.concatenate([np.asarray(first), np.asarray(rest)])
    np.testing.assert_allclose(got, np.asarray(whole), atol=1e-5)

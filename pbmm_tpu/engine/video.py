"""Streaming video magnification via `lax.scan`.

The reference's only cross-frame state is `previousSourceTexture` plus a
first-frame flag (`MotionMagnificationProcessor.cs:56-57,75,111-117,142`).
Here the carried state is an explicit, serializable pytree (`VideoState`) of
f32 arrays: the previous frame's spectrum (split re/im, so a checkpoint holds
plain float arrays), optional previous-frame pixels for the no-cache parity
mode, temporal IIR filter taps, and the frame index.
That makes long video jobs resumable mid-stream (SURVEY.md §5
checkpoint/resume row) — see `engine.state`.

First-frame semantics match `OnRenderImage`'s bootstrap: frame 0 passes
through unmodified (`MotionMagnificationProcessor.cs:111-117`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.core.color import unit_float
from pbmm_tpu.core.complexop import combine
from pbmm_tpu.engine.pipeline import amplify_spectrum, postprocess, preprocess
from pbmm_tpu.phase.temporal import TemporalState, temporal_init


def _is_planar(frames) -> bool:
    """(T, 3, H, W) channel-planar input (vs the reference's interleaved
    (T, H, W, 3) texture layout).  Planar is the y4m/video-file native
    layout."""
    return (frames.ndim == 4 and frames.shape[1] == 3
            and frames.shape[-1] != 3)


def _emit(chans_cf: jnp.ndarray, cfg: MagnifyConfig) -> jnp.ndarray:
    """Channels-first (..., 3, H, W) f32 in [0,1] -> the configured
    output layout."""
    if cfg.output_layout == "interleaved":
        return jnp.moveaxis(chans_cf, -3, -1)
    if cfg.output_layout == "planar":
        return chans_cf
    return jnp.round(chans_cf * 255.0).astype(jnp.uint8)


class VideoState(NamedTuple):
    """Scan carry / checkpointable pipeline state. f32/i32 leaves only."""

    prev_spec_re: jnp.ndarray  # (C, Hp, Wp) f32 (empty if not caching)
    prev_spec_im: jnp.ndarray
    prev_frame: jnp.ndarray  # (H, W, 3) f32 (empty if caching spectra)
    temporal: TemporalState
    frame_idx: jnp.ndarray  # () i32


def video_init(first_frame: jnp.ndarray, cfg: MagnifyConfig) -> VideoState:
    """Bootstrap state from frame 0.

    `frame_idx` counts frames consumed/emitted so far (so it starts at 1:
    frame 0 has passed through) — the resume driver
    (`io.stream.stream_magnify_resumable`) uses it as the output offset.
    """
    spec, _ = preprocess(first_frame, cfg)
    if cfg.cache_prev_spectrum:
        sre, sim = jnp.real(spec), jnp.imag(spec)
        pframe = jnp.zeros((0, 0, 0), jnp.float32)
    else:
        sre = sim = jnp.zeros((0, 0, 0), jnp.float32)
        pframe = unit_float(first_frame)
    tstate = temporal_init(spec.shape, cfg.temporal)
    return VideoState(sre, sim, pframe, tstate, jnp.int32(1))


def video_step(
    state: VideoState, frame: jnp.ndarray, cfg: MagnifyConfig
) -> Tuple[VideoState, jnp.ndarray]:
    """Process one frame; returns (new_state, magnified RGB frame)."""
    cur_spec, cur_yiq = preprocess(frame, cfg)

    if cfg.cache_prev_spectrum:
        prev_spec = combine(state.prev_spec_re, state.prev_spec_im)
    else:
        # Reference-faithful: fully re-process the previous frame
        # (`MotionMagnificationProcessor.cs:151-156`).
        prev_spec, _ = preprocess(state.prev_frame, cfg)

    mod_spec, new_temporal = amplify_spectrum(
        cur_spec, prev_spec, cfg, state.temporal
    )
    out = _emit(postprocess(mod_spec, cur_yiq, cfg), cfg)

    if cfg.cache_prev_spectrum:
        sre, sim = jnp.real(cur_spec), jnp.imag(cur_spec)
        pframe = state.prev_frame
    else:
        sre, sim = state.prev_spec_re, state.prev_spec_im
        pframe = unit_float(frame)
    new_state = VideoState(
        sre, sim, pframe, new_temporal, state.frame_idx + 1
    )
    return new_state, out


@functools.partial(jax.jit, static_argnames=("cfg",))
def _chunk_scan(frames, state: VideoState, cfg: MagnifyConfig):
    final_state, outs = jax.lax.scan(
        lambda s, f: video_step(s, f, cfg), state, frames
    )
    return outs, final_state


@functools.partial(jax.jit, static_argnames=("cfg",))
def _magnify_bootstrap(frames, cfg: MagnifyConfig):
    state = video_init(frames[0], cfg)
    first_out = _first_passthrough(frames, cfg)
    outs, final_state = _chunk_scan(frames[1:], state, cfg)
    return jnp.concatenate([first_out, outs], axis=0), final_state


def _first_passthrough(frames, cfg: MagnifyConfig):
    """Frame 0 in the configured output layout (the reference's
    first-frame bootstrap emits the source frame unmodified)."""
    return _emit(jnp.moveaxis(unit_float(frames[0]), -1, -3), cfg)[None]


def magnify_video(
    frames: jnp.ndarray, cfg: MagnifyConfig, state: VideoState = None
) -> Tuple[jnp.ndarray, VideoState]:
    """Magnify a clip.

    Args:
      frames: (T, H, W, 3) RGB, f32 in [0, 1] or uint8; channel-planar
        (T, 3, H, W) input is accepted too.
      state: optional carry from a previous chunk (streaming / resume).
        When None, frame 0 bootstraps the state and passes through
        unmodified, like the reference's first rendered frame.

    Returns (out_frames (T, H, W, 3), final_state).  Chunked streaming:
    call repeatedly with consecutive clips, threading the returned state.

    The whole clip runs as ONE cached executable (jit with `cfg` static —
    the analog of `OnValidate` retracing on parameter edits); repeat calls
    with the same shapes/config dispatch without retracing.
    """
    frames = jnp.asarray(frames)
    if _is_planar(frames):
        frames = jnp.moveaxis(frames, 1, -1)
    if not cfg.apply_motion_magnification:
        # Reference bypass: frames pass through untouched, but the previous
        # frame keeps being tracked so re-enabling magnification mid-stream
        # pairs with the true predecessor
        # (`MotionMagnificationProcessor.cs:126-139,142`).
        new_state = _bypass_state(frames, cfg)
        if state is not None:
            new_state = new_state._replace(
                frame_idx=state.frame_idx + jnp.int32(frames.shape[0])
            )
        return _emit(jnp.moveaxis(unit_float(frames), -1, -3), cfg), new_state
    if state is None:
        return _magnify_bootstrap(frames, cfg)
    return _chunk_scan(frames, state, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _bypass_state(frames, cfg: MagnifyConfig) -> VideoState:
    state = video_init(frames[-1], cfg)
    return state._replace(frame_idx=jnp.int32(frames.shape[0]))

"""Batched and multi-chip magnification paths.

Two formulations of the two-frame pipeline:

- `magnify_clip_batched`: all frames processed as one batch — FFTs batch over
  the frame axis (one large transform; no sequential scan dependency).  The
  previous-frame spectrum is a shifted slice of the batch, so each frame's
  spectrum is computed exactly once (the reference computes it twice —
  `MotionMagnificationProcessor.cs:151-156`).
- `magnify_batch_sharded`: the same math under pjit over a
  ("data", "frame") mesh: videos shard over "data", frames over "frame".
  The shifted-slice becomes a 1-frame halo exchange across shard boundaries
  (XLA inserts a collective-permute between devices) — the degenerate
  ring-attention-style neighbor exchange anticipated in SURVEY.md §5.

The streaming IIR temporal mode has a sequential dependency over frames and
therefore shards over videos only, scanning frames locally
(`engine.video.magnify_video`; SURVEY.md §7.3 "temporal sharding").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.pipeline import (
    amplify_spectrum,
    postprocess,
    preprocess,
)


def _magnify_clip_batched_impl(
    frames: jnp.ndarray, cfg: MagnifyConfig
) -> jnp.ndarray:
    """(T, H, W, 3) -> (T, H, W, 3), two-frame mode, batched over T."""
    if cfg.temporal.mode != "two_frame":
        raise ValueError("batched path requires the two-frame temporal mode; "
                         "use engine.video.magnify_video for IIR modes")
    if not cfg.apply_motion_magnification:
        # Reference bypass (`MotionMagnificationProcessor.cs:126-139`).
        return frames.astype(jnp.float32)
    # All stages are natively rank-generic: the frame axis batches the FFTs
    # directly (one large transform, not vmap-of-small-transforms).
    specs, yiqs = preprocess(frames, cfg)
    # 1-frame temporal halo: prev[t] = spec[t-1]; frame 0 pairs with itself
    # (its delta is 0 => pass-through, matching first-frame bootstrap).
    prev_specs = jnp.concatenate([specs[:1], specs[:-1]], axis=0)

    mod, _ = amplify_spectrum(specs, prev_specs, cfg)
    out = jnp.moveaxis(postprocess(mod, yiqs, cfg), -3, -1)
    # Frame 0 passes through unmodified (`MotionMagnificationProcessor.cs:
    # 111-117`).  (Its phase delta is zero, but magnitude reconstruction,
    # windowing and blur would still alter it — replace explicitly.)
    return jnp.concatenate([frames[:1].astype(jnp.float32), out[1:]], axis=0)


_magnify_clip_batched_jit = jax.jit(_magnify_clip_batched_impl, static_argnums=1)


def magnify_clip_batched(frames, cfg: MagnifyConfig):
    """Single-device batched two-frame magnification of one clip."""
    return _magnify_clip_batched_jit(frames, cfg)


def batch_shardings(mesh: Mesh):
    """(in, out) shardings for (B, T, H, W, 3) video batches."""
    spec = P("data", "frame", None, None, None)
    return NamedSharding(mesh, spec), NamedSharding(mesh, spec)


@functools.lru_cache(maxsize=16)
def _sharded_fn(cfg: MagnifyConfig, mesh: Mesh):
    in_sh, out_sh = batch_shardings(mesh)
    return jax.jit(
        jax.vmap(lambda clip: _magnify_clip_batched_impl(clip, cfg)),
        in_shardings=in_sh,
        out_shardings=out_sh,
    )


def magnify_batch_sharded(
    frames: jnp.ndarray, cfg: MagnifyConfig, mesh: Mesh
) -> jnp.ndarray:
    """(B, T, H, W, 3) -> (B, T, H, W, 3) over a ("data", "frame") mesh.

    Each video's frames shard across the "frame" axis; the shifted-slice
    previous-spectrum access crosses shard boundaries as a 1-frame halo
    (collective-permute between devices).
    """
    in_sh, _ = batch_shardings(mesh)
    return _sharded_fn(cfg, mesh)(jax.device_put(frames, in_sh))

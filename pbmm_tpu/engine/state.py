"""Checkpoint / resume of the streaming pipeline state.

The reference has no checkpointing — its only cross-frame state is one
texture, rebuilt every run (SURVEY.md §5).  Long video jobs need to
resume mid-stream, so `VideoState` (all-f32/i32 pytree) round-trips through
a plain .npz file; a host restart resumes from the last emitted frame index
with identical results (asserted by tests/test_checkpoint.py).
"""

from __future__ import annotations

import os

import numpy as np

from pbmm_tpu.engine.video import VideoState
from pbmm_tpu.phase.temporal import TemporalState


def save_state(state: VideoState, path: str) -> None:
    """Atomic write: a kill mid-save never leaves a torn checkpoint — the
    previous complete one survives (the resume loop depends on this)."""
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        prev_spec_re=np.asarray(state.prev_spec_re),
        prev_spec_im=np.asarray(state.prev_spec_im),
        prev_frame=np.asarray(state.prev_frame),
        lp_fast=np.asarray(state.temporal.lp_fast),
        lp_slow=np.asarray(state.temporal.lp_slow),
        frame_idx=np.asarray(state.frame_idx),
    )
    os.replace(tmp, path)


def load_state(path: str) -> VideoState:
    with np.load(path) as z:
        return VideoState(
            prev_spec_re=z["prev_spec_re"],
            prev_spec_im=z["prev_spec_im"],
            prev_frame=z["prev_frame"],
            temporal=TemporalState(z["lp_fast"], z["lp_slow"]),
            frame_idx=z["frame_idx"],
        )

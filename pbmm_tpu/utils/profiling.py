"""Tracing / profiling helpers (SURVEY.md §5: the reference has no timing
code at all; Unity's profiler was the only recourse).

- `trace(logdir)`: context manager around `jax.profiler` producing
  Perfetto/XProf traces of the jitted pipeline.
- `device_time_by_scope`: reduces such a trace to device time per named
  pipeline stage.  The stages carry `jax.named_scope` names
  (`pbmm.preprocess`, `pbmm.fft`, `pbmm.phase_amplify`, `pbmm.ifft`,
  `pbmm.blur`, `pbmm.post`); the trace's device events name the HLO
  instruction they ran (`hlo_op`, or the kernel name for kernels replayed
  from a CUDA graph), and the compiled module's HLO text maps each
  instruction to its scope path (`op_name` metadata).  Device work outside
  every scope (layout transposes, the scan's slicing and stacking) counts
  as "other".
- `timeit` / `stage_times`: host wall-clock per jitted stage, each call
  ended with `jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed block into `logdir`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median wall-clock seconds of fn(*args), each call run to completion."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def stage_times(frames, cfg, reps: int = 3) -> Dict[str, float]:
    """Per-stage median seconds for one frame batch (T, H, W, 3), each
    stage jitted on its own (so XLA cannot fuse across the boundaries)."""
    import jax.numpy as jnp

    from pbmm_tpu.engine.pipeline import (
        amplify_spectrum,
        postprocess,
        preprocess,
    )

    frames = jnp.asarray(frames)
    pre = jax.jit(lambda f: preprocess(f, cfg))
    specs, windowed = pre(frames)
    prev = jnp.concatenate([specs[:1], specs[:-1]], axis=0)
    amp = jax.jit(lambda c, p: amplify_spectrum(c, p, cfg)[0])
    mod = amp(specs, prev)
    post = jax.jit(lambda m, w: postprocess(m, w, cfg))

    return {
        "preprocess_fft": timeit(pre, frames, reps=reps),
        "phase_amplify": timeit(amp, specs, prev, reps=reps),
        "ifft_postprocess": timeit(post, mod, windowed, reps=reps),
    }


# --- trace reduction ---------------------------------------------------------

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


# Control-flow instructions: on backends that time them as one event, the
# event encloses the events of the computations they call.
_CONTROL_OPS = ("while", "conditional", "call")


def hlo_scopes(hlo_text: str) -> Dict[str, str]:
    """HLO instruction name -> innermost `pbmm.*` scope of its op_name
    ("other" when the instruction carries no pipeline scope).  Each name is
    also entered with dots as underscores: the GPU backend names a fusion's
    kernel that way (`loop_multiply_fusion.6` -> `loop_multiply_fusion_6`)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        op = _OP_NAME.search(line)
        scopes = [p for p in (op.group(1) if op else "").split("/")
                  if p.startswith("pbmm.")]
        out[m.group(1)] = out[m.group(1).replace(".", "_")] = (
            scopes[-1] if scopes else "other")
    return out


def _xplane_file(logdir: str) -> str:
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {logdir!r}")
    return files[-1]


def _op_events(planes) -> Iterable[Tuple[str, str, str, float, float]]:
    """(hlo_module, hlo_op, event name, start_ns, duration_ns) of every
    event that ran part of an HLO module.  Device planes ("/device:...")
    win over the host plane when they hold any such event (the host plane
    carries the CPU backend's ops)."""
    found = {}
    for plane in planes:
        evs = []
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if stats.get("hlo_op"):
                    evs.append((str(stats.get("hlo_module", "")),
                                str(stats["hlo_op"]), ev.name,
                                float(ev.start_ns), float(ev.duration_ns)))
        if evs:
            found[plane.name] = evs
    device = [p for p in found if p.startswith("/device:")]
    for p in device or list(found):
        yield from found[p]


def busy_ns(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, -np.inf
    for s, d in sorted(intervals):
        e = s + d
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_time_by_scope(logdir: str, hlo_text: str,
                         module: Optional[str] = None,
                         kernels: Optional[Dict[str, float]] = None
                         ) -> Dict[str, float]:
    """Sum of device event durations (ns) per `pbmm.*` scope in the trace
    under `logdir`.  `hlo_text`: the compiled module's HLO
    (`compiled.as_text()`) that maps instruction names to scopes;
    `module`: count only events of the HLO module of that name (e.g.
    "jit__chunk_scan"); `kernels`: a dict filled with the same durations
    keyed "scope/kernel".  Adds
    "_busy_ns" (union of all op intervals) and "_window_ns" (first op start
    to last op end) so the idle share is 1 - busy / window."""
    scopes = hlo_scopes(hlo_text)
    pd = jax.profiler.ProfileData.from_file(_xplane_file(logdir))
    totals: Dict[str, float] = {}
    spans = []
    for mod, op, name, start, dur in _op_events(pd.planes):
        if module is not None and mod != module:
            continue  # another module's event
        if op.split(".")[0] in _CONTROL_OPS:
            continue  # spans the ops of its body, which count themselves
        # Kernels replayed from a command buffer (CUDA graph) carry
        # hlo_op="command_buffer"; their kernel name is the fusion's name.
        key = scopes.get(op) or scopes.get(name, "other")
        totals[key] = totals.get(key, 0.0) + dur
        if kernels is not None:
            k = f"{key}/{name if op == 'command_buffer' else op}"
            kernels[k] = kernels.get(k, 0.0) + dur
        spans.append((start, dur))
    if spans:
        totals["_busy_ns"] = busy_ns(spans)
        totals["_window_ns"] = (max(s + d for s, d in spans)
                                - min(s for s, _ in spans))
    return totals

"""The trace reduction (`utils/profiling.py`): HLO scope parsing, the busy
interval union, and per-stage device time on a small recorded trace."""

import jax
import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.video import _chunk_scan, magnify_video
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.utils.profiling import (
    busy_ns,
    device_time_by_scope,
    hlo_scopes,
    timeit,
    trace,
)

HLO = """
ENTRY %main {
  %p0 = f32[4]{0} parameter(0)
  %fusion.3 = f32[4]{0} fusion(f32[4]{0} %p0), kind=kLoop, calls=%fc, metadata={op_name="jit(f)/pbmm.preprocess/pbmm.fft/fft" source_file="x.py"}
  ROOT %add.1 = f32[4]{0} add(%fusion.3, %p0), metadata={op_name="jit(f)/pbmm.blur/add"}
  %copy.2 = f32[4]{0} copy(%p0), metadata={op_name="jit(f)/copy"}
}
"""


def test_hlo_scopes_takes_innermost_pipeline_scope():
    sc = hlo_scopes(HLO)
    assert sc["fusion.3"] == "pbmm.fft"
    assert sc["add.1"] == "pbmm.blur"
    assert sc["copy.2"] == sc["p0"] == "other"
    # GPU kernel names use underscores for the instruction's dots.
    assert sc["fusion_3"] == "pbmm.fft"


def test_busy_ns_is_the_interval_union():
    # [0, 10) and [5, 15) overlap; [20, 25) is separate; [21, 22) nested.
    assert busy_ns([(0, 10), (5, 10), (20, 5), (21, 1)]) == 20.0
    assert busy_ns([]) == 0.0


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    frames = oscillating_bar(size=64, frames=4)
    cfg = MagnifyConfig()
    out, state = magnify_video(frames, cfg)
    jax.block_until_ready(out)
    hlo = _chunk_scan.lower(frames, state, cfg=cfg).compile().as_text()
    logdir = str(tmp_path_factory.mktemp("trace"))
    with trace(logdir):
        jax.block_until_ready(_chunk_scan(frames, state, cfg))
    return logdir, hlo


def test_device_time_by_scope_on_recorded_trace(traced):
    logdir, hlo = traced
    ns = device_time_by_scope(logdir, hlo, module="jit__chunk_scan")
    for stage in ("pbmm.fft", "pbmm.phase_amplify", "pbmm.ifft"):
        assert ns.get(stage, 0.0) > 0.0, stage
    assert 0.0 < ns["_busy_ns"] <= ns["_window_ns"]


def test_device_time_by_scope_filters_other_modules(traced):
    logdir, hlo = traced
    assert device_time_by_scope(logdir, hlo, module="jit_not_there") == {}


def test_timeit_blocks_until_ready():
    x = jax.numpy.ones((256, 256))
    t = timeit(jax.jit(lambda a: a @ a), x, reps=2)
    assert np.isfinite(t) and t > 0.0

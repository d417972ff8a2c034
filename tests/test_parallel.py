"""Mesh/sharding tests on the 8-virtual-device CPU backend (SURVEY.md §4c):
the sharded batched path must equal the unsharded scan path."""

import jax
import numpy as np
import pytest

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.video import magnify_video
from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob
from pbmm_tpu.parallel.mesh import make_mesh, mesh_shape_for
from pbmm_tpu.parallel.sharding import magnify_batch_sharded, magnify_clip_batched
from pbmm_tpu.utils.metrics import psnr


pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

CFG = MagnifyConfig()
CLIP = oscillating_gaussian_blob(height=48, width=48, frames=8)


def test_mesh_shape_for():
    assert mesh_shape_for(8, n_videos=1) == (1, 8)
    assert mesh_shape_for(8, n_videos=4) == (4, 2)
    assert mesh_shape_for(8, n_videos=64) == (8, 1)
    assert mesh_shape_for(1) == (1, 1)


def test_batched_equals_scan():
    out_scan, _ = magnify_video(CLIP, CFG)
    out_batch = magnify_clip_batched(CLIP, CFG)
    assert out_batch.shape == CLIP.shape
    assert psnr(np.asarray(out_batch), np.asarray(out_scan)) > 70.0


def test_sharded_equals_unsharded():
    batch = np.stack([CLIP, CLIP[:, ::-1]])  # 2 videos
    mesh = make_mesh((2, 4))
    out_sh = np.asarray(magnify_batch_sharded(batch, CFG, mesh))
    out_ref = np.stack(
        [np.asarray(magnify_clip_batched(v, CFG)) for v in batch]
    )
    assert psnr(out_sh, out_ref) > 70.0


def test_sharded_frame_axis_only():
    batch = CLIP[None]  # 1 video, frames over all 8 devices
    mesh = make_mesh((1, 8))
    out = np.asarray(magnify_batch_sharded(batch, CFG, mesh))
    ref, _ = magnify_video(CLIP, CFG)
    assert psnr(out[0], np.asarray(ref)) > 70.0


@pytest.mark.parametrize("kw", [
    dict(pad_mode="tight"), dict(mode="standard"), dict(chroma="rgb"),
])
def test_sharded_modes_equal_unsharded(kw):
    """The ("data", "frame") engine in every mode family vs the unsharded
    streaming engine on the same clips."""
    cfg = MagnifyConfig(**kw)
    batch = np.stack([CLIP, CLIP[:, ::-1]])
    out = np.asarray(magnify_batch_sharded(batch, cfg, make_mesh((2, 4))))
    ref = np.stack([np.asarray(magnify_video(v, cfg)[0]) for v in batch])
    assert psnr(out, ref) > 70.0


def test_batched_rejects_iir_mode():
    from pbmm_tpu.config import TemporalConfig

    cfg = MagnifyConfig(temporal=TemporalConfig(mode="iir_bandpass"))
    with pytest.raises(ValueError, match="two-frame"):
        magnify_clip_batched(CLIP, cfg)


class TestLinkModel:
    """Analytic multi-card scaling model: exact collective byte counts per
    sharding axis and the no-overlap efficiency bound."""

    def test_frame_axis_traffic(self):
        from pbmm_tpu.parallel.model import frame_axis_traffic

        t = frame_axis_traffic(2048, 1152, frames_per_shard=16)
        # one (2048, 1152) f32 re/im pair per 16-frame chunk
        assert t.bytes_per_frame == 2 * 2048 * 1152 * 4 / 16

    def test_rows_axis_traffic(self):
        from pbmm_tpu.parallel.model import rows_axis_traffic

        t = rows_axis_traffic(2048, 2048, n_dev=4, blur_radius=2)
        a2a = 2 * (2048 * 2048 * 2 * 4) * 3 / 4
        halo = 2 * 4 * 2048 * 4
        assert t.bytes_per_frame == a2a + halo

    def test_efficiency_bounds_ordering(self):
        from pbmm_tpu.parallel.model import scaling_table

        rows = scaling_table(1080, 1920, "square_pow2",
                             compute_ms_per_frame=0.45,
                             device_kind="NVIDIA H100 80GB HBM3")
        frame_row = rows[0]
        assert frame_row["axis"] == "frame"
        # the 1-frame spectral halo is tiny: >= 98% bound at 1080p
        assert frame_row["efficiency_bound_no_overlap"] >= 0.98
        # rows-axis bounds decrease with devices and sit well below the
        # frame axis (all-to-alls move the whole spectrum)
        effs = [r["efficiency_bound_no_overlap"] for r in rows[1:]]
        assert all(e < frame_row["efficiency_bound_no_overlap"]
                   for e in effs)
        assert effs == sorted(effs, reverse=True)

    def test_link_bandwidth_by_device_kind(self):
        from pbmm_tpu.parallel.model import link_gbps

        assert link_gbps("NVIDIA H100 80GB HBM3") == 450.0

    def test_unknown_device_kind_raises(self):
        from pbmm_tpu.parallel.model import link_gbps, scaling_table

        with pytest.raises(ValueError, match="no link bandwidth"):
            link_gbps("Unknown Accelerator")
        with pytest.raises(ValueError, match="no link bandwidth"):
            scaling_table(1080, 1920, "tight", 1.0, device_kind="cpu")

"""Spatially-sharded (rows-across-chips) engine vs the unsharded pipeline
on the 8-virtual-device CPU mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.pipeline import magnify_frame_pair
from pbmm_tpu.oracle.synthetic import oscillating_bar
from pbmm_tpu.parallel.spatial import magnify_frame_pair_spatial
from pbmm_tpu.utils.metrics import psnr

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def _rows_mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("rows",))


def test_spatial_matches_unsharded():
    frames = oscillating_bar(size=128, frames=3, bar_width=2)
    cfg = MagnifyConfig(use_rfft=False)
    mesh = _rows_mesh()
    got = np.asarray(
        magnify_frame_pair_spatial(frames[1], frames[2], cfg, mesh)
    )
    want = np.asarray(magnify_frame_pair(frames[1], frames[2], cfg))
    assert got.shape == want.shape
    assert psnr(got, want) > 70.0


def test_spatial_rejects_only_sequential_conflict():
    """r5 parity: the ONLY rejected combination is IIR temporal on a
    frame-sharded mesh (the lp recurrence is sequential across frames)."""
    from pbmm_tpu.config import TemporalConfig
    from pbmm_tpu.parallel.spatial import magnify_video_spatial

    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh2d = Mesh(devs, ("frame", "rows"))
    cfg = MagnifyConfig(use_rfft=False,
                        temporal=TemporalConfig(mode="iir_bandpass"))
    with pytest.raises(ValueError, match="sequential"):
        magnify_video_spatial(
            np.zeros((4, 64, 64, 3), np.float32), cfg, mesh2d)


def test_spatial_two_devices():
    frames = oscillating_bar(size=64, frames=3, bar_width=2)
    cfg = MagnifyConfig(use_rfft=False)
    mesh = _rows_mesh(2)
    got = np.asarray(
        magnify_frame_pair_spatial(frames[1], frames[2], cfg, mesh)
    )
    want = np.asarray(magnify_frame_pair(frames[1], frames[2], cfg))
    assert psnr(got, want) > 70.0


class TestVideoSpatial:
    """The production video-level spatial engine: device-side padding, one
    FFT per frame, frame x rows mesh composition."""

    def _make_2d_mesh(self, nf, nr):
        import numpy as _np

        devs = _np.asarray(jax.devices()[: nf * nr]).reshape(nf, nr)
        return Mesh(devs, ("frame", "rows"))

    def test_video_rows_only_matches_unsharded(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=6, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False)
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh()))
        want, _ = magnify_video(frames, cfg)
        assert out.shape == frames.shape
        assert psnr(out, np.asarray(want)) > 70.0

    def test_video_frame_x_rows_mesh_matches_unsharded(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=8, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False)
        mesh = self._make_2d_mesh(2, 4)
        out = np.asarray(magnify_video_spatial(frames, cfg, mesh))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_video_first_frame_passthrough(self):
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=4, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False)
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        np.testing.assert_allclose(out[0], frames[0], atol=1e-6)

    def test_video_steerable_matches_unsharded(self):
        """Steerable orientations through the spatial engine: the sector
        windows evaluated at each shard's global frequencies."""
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=4, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False, orientations=4)
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_video_standard_frame_x_rows_mesh(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=8, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False, mode="standard")
        out = np.asarray(
            magnify_video_spatial(frames, cfg, self._make_2d_mesh(2, 4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_video_rejects_unsplittable_frames(self):
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=5, bar_width=2)
        mesh = self._make_2d_mesh(2, 4)
        with pytest.raises(ValueError, match="must divide"):
            magnify_video_spatial(frames, MagnifyConfig(use_rfft=False), mesh)


class TestSpatialParityR5:
    """Spatial-engine parity: standard mode, IIR temporal, rgb chroma
    through the sharded engine vs the unsharded pipeline."""

    def test_standard_mode_xla(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=4, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False, mode="standard")
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_iir_rows_mesh_xla(self):
        from pbmm_tpu.config import TemporalConfig
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=6, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False,
                            temporal=TemporalConfig(mode="iir_bandpass"))
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_rgb_chroma_xla(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=4, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False, chroma="rgb")
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_rgb_chroma_frame_mesh(self):
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=64, frames=4, bar_width=2)
        cfg = MagnifyConfig(use_rfft=False, chroma="rgb")
        devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, ("frame", "rows"))
        out = np.asarray(magnify_video_spatial(frames, cfg, mesh))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

    def test_tight_geometry_takes_xla_path(self):
        """Non-pow-2 (tight) heights through the sharded FFT (rows split
        across 4 shards) match the unsharded engine."""
        from pbmm_tpu.core.window import geometry_for
        from pbmm_tpu.engine.video import magnify_video
        from pbmm_tpu.parallel.spatial import magnify_video_spatial

        frames = oscillating_bar(size=256, frames=4, bar_width=2)
        frames = np.concatenate([frames, frames[:, :44]], axis=1)  # 300 rows
        cfg = MagnifyConfig(pad_mode="tight", use_rfft=False)
        geom = geometry_for(300, 256, "tight")
        assert geom.pad_h == 384  # 3 * 128: non-pow2
        out = np.asarray(magnify_video_spatial(frames, cfg, _rows_mesh(4)))
        want, _ = magnify_video(frames, cfg)
        assert psnr(out, np.asarray(want)) > 70.0

"""Analytic multi-chip scaling model.

The multi-chip story is split into three pieces the reader can combine:

  1. correctness: every sharded engine is psnr-tested against the
     unsharded engine on the 8-virtual-device CPU mesh
     (tests/test_parallel.py, test_spatial.py), and on real cards by
     `chip_smoke.py --four`;
  2. measured single-card compute: bench.py / benchmarks/run_suite.py;
  3. THIS MODULE: exact per-frame collective traffic for each sharding
     axis at a given geometry, and the no-overlap efficiency bound it
     implies against the card-to-card link bandwidth.

The collectives per axis (see `parallel/sharding.py`, `parallel/
spatial.py`):

  frame axis ("sp"): the two-frame pairing needs each shard's FIRST
    frame to receive its left neighbor's LAST spectrum — ONE
    collective-permute of one (Hp, W//2+1) re/im plane pair per shard per
    chunk, amortized over the shard's frames.  (IIR is sequential across
    frames and never frame-sharded.)
  rows axis ("tp"): the distributed FFT's two all-to-alls per frame
    (forward and inverse transpose of the shard axis — each moves
    (p-1)/p of the full complex spectrum) plus the blur's 2r-row halo
    exchange.
  data axis ("dp"): zero steady-state collectives (videos are
    independent; only metric psums).

The model reports the no-overlap bound t_comm = bytes / link bandwidth
serialized after compute — XLA overlaps collectives with compute in
practice, so real efficiency lands between this bound and 1.0.
"""

from __future__ import annotations

from dataclasses import dataclass

# Card-to-card bandwidth per direction, GB/s, keyed by `device_kind`.
LINK_GBPS = {
    # NVLink 4: 900 GB/s total, 450 GB/s each way (NVIDIA H100 data sheet,
    # SXM part).
    "NVIDIA H100 80GB HBM3": 450.0,
}
_F = 4  # f32 bytes


def link_gbps(device_kind: str) -> float:
    """Link bandwidth of `device_kind`; a device not in the table is an
    error, not a default."""
    try:
        return LINK_GBPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no link bandwidth on record for device kind {device_kind!r}; "
            f"known: {sorted(LINK_GBPS)}"
        ) from None


@dataclass
class AxisTraffic:
    axis: str
    bytes_per_frame: float  # collective bytes crossing links per frame
    note: str


def frame_axis_traffic(pad_h: int, kept_w: int,
                       frames_per_shard: int) -> AxisTraffic:
    """One (Hp, Wk) f32 re/im spectrum-plane pair ppermuted per shard
    per chunk (the 1-frame temporal halo), amortized per frame."""
    per_chunk = 2 * pad_h * kept_w * _F
    return AxisTraffic(
        "frame", per_chunk / max(frames_per_shard, 1),
        f"1 spectrum plane pair ({per_chunk / 1e6:.1f} MB) per shard per "
        f"{frames_per_shard}-frame chunk",
    )


def rows_axis_traffic(pad_h: int, pad_w: int, n_dev: int,
                      blur_radius: int = 2) -> AxisTraffic:
    """Two all-to-alls of the full complex spectrum (each moves
    (p-1)/p of it across the links) + the blur halo (2r rows in each
    direction), per frame."""
    p = max(n_dev, 1)
    a2a = 2 * (pad_h * pad_w * 2 * _F) * (p - 1) / p
    halo = 2 * (2 * blur_radius) * pad_w * _F
    return AxisTraffic(
        "rows", a2a + halo,
        f"2 all-to-alls x {(pad_h * pad_w * 2 * _F) / 1e6:.1f} MB x "
        f"(p-1)/p + {halo / 1e6:.2f} MB blur halo",
    )


def efficiency_bound(compute_ms_per_frame: float, traffic: AxisTraffic,
                     device_kind: str) -> dict:
    """No-overlap scaling-efficiency bound: each card keeps its full
    per-frame compute and additionally serializes its collective bytes
    through its links.  eff = t_compute / (t_compute + t_comm)."""
    gbps = link_gbps(device_kind)
    t_comm_ms = traffic.bytes_per_frame / (gbps * 1e9) * 1e3
    eff = compute_ms_per_frame / (compute_ms_per_frame + t_comm_ms)
    return {
        "axis": traffic.axis,
        "collective_mb_per_frame": round(traffic.bytes_per_frame / 1e6, 3),
        "t_comm_ms_per_frame": round(t_comm_ms, 4),
        "compute_ms_per_frame": round(compute_ms_per_frame, 3),
        "efficiency_bound_no_overlap": round(eff, 3),
        "note": traffic.note,
        "device_kind": device_kind,
        "link_gbps_assumed": gbps,
    }


def scaling_table(h: int, w: int, pad_mode: str,
                  compute_ms_per_frame: float, device_kind: str,
                  frames_per_shard: int = 16,
                  devices=(2, 4, 8)) -> list:
    """Per-axis projected efficiency bounds at the given geometry for a
    range of device counts — the numbers run_suite configs 4/5 publish."""
    from pbmm_tpu.core.window import geometry_for

    geom = geometry_for(h, w, pad_mode)
    rows = []
    # The frame halo carries the rfft half-spectrum: W//2 + 1 columns.
    ft = frame_axis_traffic(geom.pad_h, geom.pad_w // 2 + 1,
                            frames_per_shard)
    rows.append({"devices": "any", **efficiency_bound(
        compute_ms_per_frame, ft, device_kind)})
    for n in devices:
        rt = rows_axis_traffic(geom.pad_h, geom.pad_w, n)
        rows.append({"devices": n, **efficiency_bound(
            compute_ms_per_frame, rt, device_kind)})
    return rows

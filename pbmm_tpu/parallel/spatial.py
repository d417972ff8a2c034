"""Spatially-sharded magnification: frame ROWS sharded across chips.

The tensor-parallel analog for frames too large (or too latency-critical)
for one chip: the 2D FFT becomes

    local row-FFT  ->  all-to-all (transpose the shard axis: rows -> cols)
    ->  local col-FFT

so each chip always transforms full contiguous lines; the only
communication is one all-to-all per transform (the classic
distributed-FFT decomposition — SURVEY.md §7.3 called this out as the
sharded analog of ButterflyByRow/Col).  The phase pass is elementwise
on natural-layout spectrum shards (masks evaluated procedurally at each
shard's global frequencies); the inverse mirrors the forward; the 5-tap
blur needs a 2-row halo exchange with ppermute at shard boundaries.

Two engines, both `shard_map`-based:

- `magnify_video_spatial`: the production path — (T, H, W, 3) videos over
  a 2D ("frame", "rows") mesh (or 1D ("rows",)).  Padding happens on
  device inside the jit, each frame is FFT'd exactly once (the previous
  spectrum is a shifted slice, crossing frame-shard boundaries as a
  1-frame ppermute halo), and the frame and row axes compose.
- `magnify_frame_pair_spatial`: one (prev, cur) pair over a ("rows",)
  mesh — a thin wrapper over the video engine with T=2.

Coverage: pyramid (radial/steerable) and standard mode, two-frame and
iir_bandpass temporal, y_only and rgb chroma — everything the single-chip
engine serves, except IIR + FRAME sharding (sequential recurrence;
rejected with a pointer to rows-only meshes).  Tested against the
unsharded pipeline on the virtual CPU mesh (`tests/test_spatial.py`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.core.color import rgb_to_yiq, yiq_to_rgb
from pbmm_tpu.core.window import blur_taps, geometry_for

AXIS = "rows"
FRAME_AXIS = "frame"


def _axis_size():
    return jax.lax.axis_size(AXIS)


def _axis_index():
    return jax.lax.axis_index(AXIS)


def _fft2_local(y_local: jnp.ndarray):
    """(..., Hl, W) real rows-shard -> (..., H, Wc) natural-layout
    cols-shard.  Leading dims (frames) batch through."""
    p = _axis_size()
    s = jnp.fft.fft(y_local.astype(jnp.complex64), axis=-1)  # full rows
    return jnp.fft.fft(_a2a_fwd(s, p), axis=-2)  # full columns


def _ifft2_local(spec: jnp.ndarray):
    """(..., H, Wc) cols-shard spectrum -> (..., Hl, W) rows-shard complex
    result."""
    p = _axis_size()
    s = jnp.fft.ifft(spec, axis=-2)
    return jnp.fft.ifft(_a2a_inv(s, p), axis=-1)


def _freqs_local(pad_h: int, pad_w: int):
    """Global natural-layout frequency axes for this shard's block:
    fy full (H, 1); fx for the local column slice (1, Wc)."""
    p = _axis_size()
    wc = pad_w // p
    ky = jnp.arange(pad_h, dtype=jnp.float32) / pad_h
    fy = jnp.where(ky < 0.5, ky, ky - 1.0)[:, None]
    kx_local = (_axis_index() * wc + jnp.arange(wc)).astype(jnp.float32) / pad_w
    fx = jnp.where(kx_local < 0.5, kx_local, kx_local - 1.0)[None, :]
    return fy, fx


def _amplify_local(cur, prev, cfg: MagnifyConfig, pad_h: int, pad_w: int,
                   delta_override=None):
    """Fused pyramid amplification on (..., H, Wc) cols-shards with global
    freqs.  `delta_override`: pre-filtered phase delta (the IIR temporal
    band-pass), replacing the raw two-frame rotation."""
    from pbmm_tpu.phase.amplify import rotation_term
    from pbmm_tpu.pyramid.filters import radial_profile_jnp

    fy, fx = _freqs_local(pad_h, pad_w)
    freq = jnp.sqrt(fy * fy + fx * fx)
    cur_mag = jnp.abs(cur)
    prev_mag = jnp.abs(prev)
    tau = cfg.magnitude_threshold
    levels = cfg.pyramid_levels
    steer = cfg.orientations > 1 and levels >= 3
    sect = None
    if steer:
        # Steerable sector windows at this shard's global frequencies
        # (partition of unity across k; matches
        # `pyramid.filters.angular_profiles_jnp`).
        theta = jnp.arctan2(jnp.broadcast_to(fy, freq.shape),
                            jnp.broadcast_to(fx, freq.shape))
        p_ang = 2 * (cfg.orientations - 1)
        raw = [jnp.abs(jnp.cos(theta - jnp.pi * k / cfg.orientations))
               ** p_ang for k in range(cfg.orientations)]
        denom = sum(raw)
        sect = [a / jnp.where(denom == 0.0, 1.0, denom) for a in raw]
    total = jnp.zeros_like(freq)
    amped = jnp.zeros_like(cur_mag)
    for i in range(levels):
        m = radial_profile_jnp(freq, i, levels, cfg.min_frequency,
                               cfg.max_frequency)
        total = total + m
        if 0 < i < levels - 1:
            if steer:
                for a in sect:
                    mk = m * a
                    gate = (cur_mag * mk >= tau) & (prev_mag * mk >= tau)
                    amped = amped + jnp.where(gate, mk, 0.0)
            else:
                gate = (cur_mag * m >= tau) & (prev_mag * m >= tau)
                amped = amped + jnp.where(gate, m, 0.0)
    rot = rotation_term(cur, prev, cfg.phase_scale,
                        delta_override=delta_override)
    return cur * ((total - amped) + amped * rot)


def _amplify_local_any(cur, prev, cfg: MagnifyConfig, pad_h: int,
                       pad_w: int, delta_override=None):
    """Mode dispatch for the sharded amplification:
    pyramid (radial/steerable) or the standard whole-spectrum weighted
    rotation (`ProcessPhaseDifference`,
    `PhaseDifferenceComputeShader.compute:124-179`) — the weight w(f)
    evaluated at this shard's global frequencies."""
    if cfg.mode == "standard":
        from pbmm_tpu.phase.standard import (
            bandpass_weight_jnp,
            standard_phase_amplify,
        )

        fy, fx = _freqs_local(pad_h, pad_w)
        weight = bandpass_weight_jnp(jnp.sqrt(fy * fy + fx * fx), cfg)
        return standard_phase_amplify(
            cur, prev, weight, cfg.phase_scale, cfg.magnitude_threshold,
            cfg.magnitude_scale, cfg.apply_magnitude_scale,
            delta_override=delta_override,
        )
    return _amplify_local(cur, prev, cfg, pad_h, pad_w,
                          delta_override=delta_override)


def _a2a_fwd(x: jnp.ndarray, p: int) -> jnp.ndarray:
    """(..., hl, w) row-shard -> (..., hl*p, w/p) col-shard (distributed
    transpose of the shard axis)."""
    *lead, hl, w = x.shape
    nd = len(lead)
    x = x.reshape(*lead, hl, p, w // p)
    x = jax.lax.all_to_all(x, AXIS, split_axis=nd + 1, concat_axis=nd,
                           tiled=False)
    return x.reshape(*lead, hl * p, w // p)


def _a2a_inv(x: jnp.ndarray, p: int) -> jnp.ndarray:
    """(..., h, wc) col-shard -> (..., h/p, wc*p) row-shard."""
    *lead, h, wc = x.shape
    nd = len(lead)
    x = x.reshape(*lead, p, h // p, wc)
    x = jax.lax.all_to_all(x, AXIS, split_axis=nd, concat_axis=nd + 1,
                           tiled=False)
    return x.reshape(*lead, h // p, wc * p)


def _blur_rowsharded(y: jnp.ndarray, blur_size: float):
    """Separable 5-tap blur on (..., Hl, W) rows-shards with a halo
    exchange.

    Horizontal pass is local (full rows).  Vertical pass gathers `radius`
    rows from each neighbor via ppermute; global edges replicate (texture
    clamp)."""
    taps = blur_taps(blur_size)
    radius = (len(taps) - 1) // 2
    *lead, hl, w = y.shape
    p = _axis_size()
    idx = _axis_index()

    # Horizontal (local, edge clamp).
    pad_cfg = [(0, 0)] * len(lead) + [(0, 0), (radius, radius)]
    yh = jnp.pad(y, pad_cfg, mode="edge")
    out = sum(taps[k] * yh[..., :, k:k + w] for k in range(len(taps)))

    # Vertical halo: bottom rows travel to the next shard, top rows to the
    # previous one (ring ppermute; wrap values are masked off below).
    down = [(i, (i + 1) % p) for i in range(p)]
    up = [(i, (i - 1) % p) for i in range(p)]
    from_above = jax.lax.ppermute(out[..., -radius:, :], AXIS, down)
    from_below = jax.lax.ppermute(out[..., :radius, :], AXIS, up)
    # Global edge clamp: first shard's top halo and last shard's bottom
    # halo replicate their own edge rows instead of the wrapped values.
    top_edge = jnp.broadcast_to(out[..., 0:1, :], (*lead, radius, w))
    bot_edge = jnp.broadcast_to(out[..., -1:, :], (*lead, radius, w))
    above = jnp.where(idx == 0, top_edge, from_above)
    below = jnp.where(idx == p - 1, bot_edge, from_below)

    stacked = jnp.concatenate([above, out, below], axis=-2)
    return sum(taps[k] * stacked[..., k:k + hl, :] for k in range(len(taps)))


def _prev_shift(a, frame_sharded, c: int = 1):
    """Previous-frame spectra: local shift along the frame axis (`c`
    planes per frame — 3 for chroma="rgb" plane-batched streams); the
    boundary frame crosses the frame-shard ring via ppermute.  The global
    first frame pairs with itself (zero delta); its exact passthrough is
    applied by the caller."""
    if not frame_sharded:
        return jnp.concatenate([a[:c], a[:-c]], axis=0)
    pf = jax.lax.axis_size(FRAME_AXIS)
    fidx = jax.lax.axis_index(FRAME_AXIS)
    ring = [(i, (i + 1) % pf) for i in range(pf)]
    recv = jax.lax.ppermute(a[-c:], FRAME_AXIS, ring)
    first_prev = jnp.where(fidx == 0, a[:c], recv)
    return jnp.concatenate([first_prev, a[:-c]], axis=0)


def _video_kernel(frames_padded, cfg: MagnifyConfig, geom, frame_sharded):
    """shard_map body: (Tl, Hl, Wp, 3) padded rows(+frame)-shards ->
    magnified rows-shards at padded resolution.

    Each local frame is FFT'd once; the previous-frame spectrum is the
    shifted slice along the frame axis, with the shard-boundary frame's
    spectrum arriving from the previous frame-shard via ppermute (the
    1-frame temporal halo, here exchanged in the *spectral* domain so the
    forward FFT is never repeated)."""
    pad_h, pad_w = geom.pad_h, geom.pad_w
    p = _axis_size()
    idx = _axis_index()
    hl = pad_h // p

    yiq = rgb_to_yiq(frames_padded)  # (Tl, Hl, Wp, 3), channels-last
    gy = (idx * hl + jnp.arange(hl)).astype(jnp.float32)
    wy = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * (gy + 0.5) / pad_h))[:, None]
    ix = (jnp.arange(pad_w, dtype=jnp.float32) + 0.5) / pad_w
    wx = (0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * ix)))[None, :]
    win = wy * wx  # (Hl, Wp)

    rgb = cfg.chroma == "rgb"
    c = 3 if rgb else 1
    tl = frames_padded.shape[0]
    if rgb:
        # All three YIQ planes FFT-bound, plane-batched in the leading
        # dim [Y0 I0 Q0 Y1 ...] so the frame shift is a c-plane shift.
        fft_in = (jnp.moveaxis(yiq, -1, 1) * win).reshape(
            tl * 3, hl, pad_w)
    else:
        fft_in = yiq[..., 0] * win  # (Tl, Hl, Wp)
    iir = cfg.temporal.mode == "iir_bandpass"

    spec = _fft2_local(fft_in)  # (Tl*c, H, Wc)
    prev = _prev_shift(spec, frame_sharded, c)
    delta_override = None
    if iir:
        # Sequential IIR band-pass over the per-bin delta stream: the
        # lp taps ride this shard's column slice through a scan over
        # LOCAL frames (the frame axis is whole on each shard — IIR +
        # frame sharding is rejected at dispatch).
        from pbmm_tpu.phase.amplify import phase_delta
        from pbmm_tpu.phase.temporal import temporal_apply, temporal_init

        delta = phase_delta(spec, prev).reshape(
            (tl, c) + spec.shape[1:])

        def step(carry, dt):
            filt, ns = temporal_apply(dt, carry, cfg.temporal)
            return ns, filt

        # The zero initial taps vary over the mesh like the deltas do.
        init = jax.lax.pcast(
            temporal_init((c,) + spec.shape[1:], cfg.temporal),
            (FRAME_AXIS, AXIS) if frame_sharded else (AXIS,), to="varying")
        _, filt = jax.lax.scan(step, init, delta)
        delta_override = filt.reshape(spec.shape)
    mod = _amplify_local_any(spec, prev, cfg, pad_h, pad_w,
                             delta_override=delta_override)
    rec = _ifft2_local(mod)  # (Tl*c, Hl, Wp) complex
    out = (jnp.abs(rec) if cfg.reconstruct == "magnitude"
           else jnp.real(rec))
    out = _blur_rowsharded(out, cfg.blur_size)

    if rgb:
        out_yiq = jnp.moveaxis(out.reshape(tl, 3, hl, pad_w), 1, -1)
    else:
        out_yiq = jnp.stack(
            [out, yiq[..., 1] * win, yiq[..., 2] * win], axis=-1
        )
    return yiq_to_rgb(out_yiq, saturate=True)


def _validate(cfg: MagnifyConfig, mesh: Mesh = None):
    """The sharded engine accepts everything the single-chip engine
    accepts — pyramid (radial/steerable) AND standard
    mode, two-frame AND iir_bandpass temporal, y_only AND rgb chroma —
    except the one genuinely sequential-conflicting combination: IIR
    temporal with FRAME sharding (the lp recurrence is strictly
    sequential across frames, so frames cannot be data-parallel; shard
    rows instead)."""
    if mesh is not None and FRAME_AXIS in mesh.axis_names \
            and mesh.shape[FRAME_AXIS] > 1 \
            and cfg.temporal.mode == "iir_bandpass":
        raise ValueError(
            "iir_bandpass is sequential across frames and cannot ride a "
            "frame-sharded mesh; use a ('rows',)-only mesh (the lp taps "
            "then ride each shard's column slice)"
        )


@functools.lru_cache(maxsize=8)
def _spatial_video_fn(cfg: MagnifyConfig, mesh: Mesh, in_h: int, in_w: int):
    geom = geometry_for(in_h, in_w, cfg.pad_mode)
    n_rows = mesh.shape[AXIS]
    frame_sharded = FRAME_AXIS in mesh.axis_names
    if geom.pad_h % n_rows or geom.pad_w % n_rows:
        raise ValueError("padded dims must divide the rows-mesh size")

    pspec = (P(FRAME_AXIS, AXIS, None, None) if frame_sharded
             else P(None, AXIS, None, None))
    sharding = NamedSharding(mesh, pspec)

    def fn(frames):
        frames = frames.astype(jnp.float32)
        t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        # Device-side center pad (the reference's GL-quad PadTexture,
        # `MotionMagnificationProcessor.cs:358-384`) — no host round trip.
        padded = jnp.pad(
            frames,
            ((0, 0),
             (geom.y0, geom.pad_h - geom.y0 - h),
             (geom.x0, geom.pad_w - geom.x0 - w),
             (0, 0)),
        )
        padded = jax.lax.with_sharding_constraint(padded, sharding)
        body = shard_map(
            lambda fr: _video_kernel(fr, cfg, geom, frame_sharded),
            mesh=mesh,
            in_specs=(pspec,),
            out_specs=pspec,
        )
        out = body(padded)[:, geom.y0:geom.y0 + h, geom.x0:geom.x0 + w]
        # Global first frame passes through unmodified
        # (`MotionMagnificationProcessor.cs:111-117`).
        return jnp.concatenate([frames[:1], out[1:]], axis=0)

    return jax.jit(fn), geom


def magnify_video_spatial(frames, cfg: MagnifyConfig, mesh: Mesh):
    """(T, H, W, 3) -> (T, H, W, 3) with rows sharded across chips.

    mesh: 2D ("frame", "rows") — frames over the first axis (1-frame
    spectral halo via ppermute), rows of every frame over the second — or
    1D ("rows",) for pure spatial sharding.  T must divide the frame-axis
    size.  Two-frame mode; each frame's FFT computed exactly once.
    """
    _validate(cfg, mesh)
    frames = jnp.asarray(frames)
    if not cfg.apply_motion_magnification:
        return frames.astype(jnp.float32)
    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    if FRAME_AXIS in mesh.axis_names and t % mesh.shape[FRAME_AXIS]:
        raise ValueError(
            f"T={t} must divide the frame-mesh size {mesh.shape[FRAME_AXIS]}"
        )
    fn, _ = _spatial_video_fn(cfg, mesh, h, w)
    return fn(frames)


def magnify_frame_pair_spatial(
    prev_rgb, cur_rgb, cfg: MagnifyConfig, mesh: Mesh
):
    """Two-frame magnification of ONE frame pair with rows sharded over a
    ("rows",) mesh.  (H, W, 3) f32 in/out.

    A T=2 run of the video engine: frame 1's output is `cur` magnified
    against `prev` (padding on device, one FFT per frame)."""
    _validate(cfg, mesh)
    frames = jnp.stack([jnp.asarray(prev_rgb), jnp.asarray(cur_rgb)])
    return magnify_video_spatial(frames, cfg, mesh)[1]

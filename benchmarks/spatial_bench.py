"""Single-card throughput of the spatially-sharded engine under a trivial
(frame=1, rows=1) mesh, beside the streaming engine on the same frames:
the cost of the shard_map formulation itself (full complex FFTs, no
collectives).  Exits 1 when JAX finds no GPU."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from jax.sharding import Mesh

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.engine.video import magnify_video
    from pbmm_tpu.parallel.spatial import magnify_video_spatial
    from pbmm_tpu.utils.cache import enable_compile_cache
    from pbmm_tpu.utils.device import (
        describe,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        require_gpu(jax.devices())
    except RuntimeError as e:
        print(f"spatial_bench: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    print(f"device: {describe(jax.devices())}", file=sys.stderr)
    print(f"card: {gpu_name_and_power_limit()}", file=sys.stderr)
    h, w, t, reps = 1080, 1920, 16, 4
    rng = np.random.default_rng(0)
    base = rng.random((h, w, 3)).astype(np.float32)
    fd = jax.device_put(np.stack([np.roll(base, i, axis=1) for i in range(t)]))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("frame", "rows"))
    cfg = MagnifyConfig()

    for name, fn in [
        ("spatial (1,1) mesh", lambda: magnify_video_spatial(fd, cfg, mesh)),
        ("streaming engine", lambda: magnify_video(fd, cfg)[0]),
    ]:
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        fps = t * reps / (time.perf_counter() - t0)
        print(f"{name} 1080p single-card: {fps:.2f} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())

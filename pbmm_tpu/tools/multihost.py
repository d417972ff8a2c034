"""Multi-process execution on one machine.

The reference is strictly single-GPU (`MotionMagnificationProcessor.cs:
639-645`); the BASELINE-specified scale-out target (>= 80% efficiency at
N >= 2 hosts) needs *executed* evidence, not just launcher code.  This
module runs the software analog of a multi-host job: N separate OS
processes, each owning K virtual CPU devices, joined by
`jax.distributed.initialize` over a TCP coordinator — the exact
initialization path, host-aligned global mesh, host-local input slicing,
and cross-process collectives a multi-host job uses, with the data-center
network replaced by the local coordination transport.

Two entry points:

- worker mode (`python -m pbmm_tpu.tools.multihost --process-id I ...`):
  one distributed process.  Initializes jax.distributed, builds the
  global ("data", "frame") mesh over ALL processes' devices, feeds its
  host-local slice of the video batch (`host_local_batch_slice`), runs
  `magnify_batch_sharded`, gathers the global result, and (process 0)
  writes output + timing.

- harness mode (`--spawn N`): spawns N workers against a fresh local
  coordinator port, waits, then checks parity against the single-process
  engine and optionally writes the result to `--json-out`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_batch(n_videos: int, frames: int, size: int) -> np.ndarray:
    from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob

    base = oscillating_gaussian_blob(height=size, width=size, frames=frames)
    return np.stack(
        [np.roll(base, shift=v, axis=2) for v in range(n_videos)]
    ).astype(np.float32)


def run_worker(args) -> int:
    """One distributed process of the multi-process job."""
    # Force the CPU platform with K local virtual devices BEFORE jax
    # initializes a backend (mirrors tests/conftest.py).
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.local_devices)
    jax.config.update("jax_enable_compilation_cache", False)

    from pbmm_tpu.parallel.launcher import (
        global_mesh,
        host_local_batch_slice,
        initialize_distributed,
    )

    multi = initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert multi == (args.num_processes > 1)
    assert jax.process_count() == args.num_processes
    assert jax.device_count() == args.num_processes * args.local_devices

    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.parallel.sharding import _sharded_fn

    cfg = MagnifyConfig()
    mesh = global_mesh(n_videos=args.videos)
    batch = _make_batch(args.videos, args.frames, args.size)
    pspec = P("data", "frame", None, None, None)
    sharding = NamedSharding(mesh, pspec)

    # Host-local feeding: `make_array_from_callback` materializes device
    # buffers only for this process's addressable shards — each process
    # uploads only its slice of the batch (the DCN-free input path a real
    # multi-host job uses).  `host_local_batch_slice` is the video-row
    # form of the same ownership; assert they agree when videos shard
    # across processes.
    garr = jax.make_array_from_callback(
        batch.shape, sharding, lambda idx: batch[idx]
    )
    lo, hi = host_local_batch_slice(args.videos)
    if int(mesh.shape["data"]) >= args.num_processes > 1:
        owned_rows = sorted({
            s[0] for d, s in garr.sharding.addressable_devices_indices_map(
                batch.shape).items()
        }, key=lambda sl: sl.start or 0)
        assert owned_rows[0].start == lo and owned_rows[-1].stop == hi, (
            f"host_local_batch_slice {(lo, hi)} != addressable rows "
            f"{owned_rows}"
        )

    fn = _sharded_fn(cfg, mesh)
    t0 = time.perf_counter()
    out = fn(garr)
    out_local = multihost_utils.global_array_to_host_local_array(
        out, mesh, pspec
    )
    np.asarray(out_local)  # block
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = fn(garr)
    out_local = np.asarray(
        multihost_utils.global_array_to_host_local_array(out, mesh, pspec)
    )
    steady_s = (time.perf_counter() - t0) / args.reps

    # Cross-process gather of the host-local pieces; process 0 reassembles
    # the global result for the harness's parity check.
    gathered = multihost_utils.process_allgather(out_local)
    if args.out and args.process_id == 0:
        parts = [np.asarray(g) for g in gathered]
        if parts[0].shape[0] < args.videos:  # videos sharded across procs
            full = np.concatenate(parts, axis=0)[:args.videos]
        elif parts[0].shape[1] < args.frames:  # frames sharded across procs
            full = np.concatenate(parts, axis=1)[:, :args.frames]
        else:  # single process owns everything
            full = parts[0]
        np.save(f"{args.out}.p0.npy", full)
        with open(f"{args.out}.timing.json", "w") as f:
            json.dump({
                "processes": args.num_processes,
                "local_devices": args.local_devices,
                "global_devices": int(jax.device_count()),
                "mesh": {k: int(v) for k, v in mesh.shape.items()},
                "videos": args.videos,
                "frames": args.frames,
                "size": args.size,
                "compile_s": round(compile_s, 3),
                "steady_s_per_batch": round(steady_s, 4),
            }, f)
    return 0


def _spawn(n_procs: int, args, out_prefix: str) -> dict:
    """Launch n_procs workers; returns the timing dict from process 0."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for pid in range(n_procs):
        cmd = [
            sys.executable, "-m", "pbmm_tpu.tools.multihost",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n_procs),
            "--process-id", str(pid),
            "--local-devices", str(args.local_devices),
            "--videos", str(args.videos),
            "--frames", str(args.frames),
            "--size", str(args.size),
            "--reps", str(args.reps),
            "--out", out_prefix,
        ]
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"worker {i} timed out")
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {i} rc={p.returncode}\n{err.decode()[-3000:]}"
            )
    with open(f"{out_prefix}.timing.json") as f:
        return json.load(f)


def _stitch(out_prefix: str, n_procs: int, n_videos: int) -> np.ndarray:
    """Load the global result (process 0 gathered + reassembled it)."""
    return np.load(f"{out_prefix}.p0.npy")


def run_harness(args) -> int:
    """Spawn 1-process and N-process runs; check parity; record scaling.

    Two mesh scenarios per run:
    - data-parallel: videos over the full cross-process "data" axis
      (no cross-process traffic beyond input/output);
    - frame-parallel: ONE video with its frame axis spanning every device
      of every process, so the 1-frame previous-spectrum halo
      (collective-permute) crosses the process boundary — the collective
      a real multi-host frame-sharded job exercises over the network.
    """
    import dataclasses
    import tempfile

    from pbmm_tpu.utils.metrics import psnr

    tmp = tempfile.mkdtemp(prefix="pbmm_mh_")
    scenarios = {
        "data_parallel": dict(videos=args.videos),
        "frame_parallel": dict(videos=1),
    }
    doc = {
        "kind": "multiprocess execution artifact: jax.distributed over a "
                "local TCP coordinator, N OS processes x K virtual CPU "
                "devices each — the multi-host init / host-aligned mesh / "
                "host-local slicing / cross-process collective path with "
                "the network replaced by local transport",
        "processes": args.spawn,
        "local_devices_per_process": args.local_devices,
        "scenarios": {},
    }
    ok = True
    for name, over in scenarios.items():
        sargs = argparse.Namespace(**{**vars(args), **over})
        results, outs = {}, {}
        for n in (1, args.spawn):
            prefix = os.path.join(tmp, f"{name}.run{n}")
            results[n] = _spawn(n, sargs, prefix)
            outs[n] = _stitch(prefix, n, sargs.videos)
            print(f"[multihost] {name} x{n}: "
                  f"steady {results[n]['steady_s_per_batch']*1e3:.1f} "
                  f"ms/batch, mesh {results[n]['mesh']}", file=sys.stderr)
        p = float(psnr(outs[args.spawn], outs[1]))
        t1 = results[1]["steady_s_per_batch"]
        tn = results[args.spawn]["steady_s_per_batch"]
        doc["scenarios"][name] = {
            "workload": {"videos": sargs.videos, "frames": args.frames,
                         "size": args.size},
            "single_process": results[1],
            "multi_process": results[args.spawn],
            "parity_psnr_db_vs_single": (
                round(p, 2) if np.isfinite(p) else "bit-identical"),
            "speedup_vs_single_process": round(t1 / tn, 3),
            "scaling_efficiency": round(t1 / (args.spawn * tn), 3),
        }
        ok &= p > 70.0
    doc["note"] = (
        "efficiency = T_1proc / (N * T_Nproc) on the same global batch; "
        "not meaningful when the N processes timeshare one machine's "
        "cores and collectives ride loopback TCP — the "
        "artifact's point is EXECUTED multi-process initialization, "
        "host-local input slicing, cross-process collectives (incl. the "
        "frame-halo collective-permute across the process boundary), and "
        "parity with the single-process engine."
    )
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    assert ok, "multi-process parity broken"
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="harness mode: spawn N workers and verify")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    if args.spawn:
        return run_harness(args)
    return run_worker(args)


if __name__ == "__main__":
    sys.exit(main())

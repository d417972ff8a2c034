"""Multi-process execution (VERDICT r2 "Missing #1"): N OS processes
joined by `jax.distributed.initialize` over a local TCP coordinator run
the sharded engine on a global mesh spanning processes, with host-local
input slicing and the frame-halo collective crossing the process
boundary (`python -m pbmm_tpu.tools.multihost --spawn 2 ...`)."""

import json
import os
import socket
import subprocess
import sys

import pytest


def _sockets_available() -> bool:
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.close()
        return True
    except OSError:
        return False


@pytest.mark.skipif(not _sockets_available(),
                    reason="no loopback sockets for the coordinator")
def test_two_process_harness(tmp_path):
    """Spawns 2 real distributed processes (x2 CPU devices each) for BOTH
    mesh scenarios and asserts parity inside the harness (it exits
    nonzero on parity failure)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = str(tmp_path / "mh.json")
    res = subprocess.run(
        [sys.executable, "-m", "pbmm_tpu.tools.multihost",
         "--spawn", "2", "--local-devices", "2", "--videos", "4",
         "--frames", "8", "--size", "32", "--reps", "2",
         "--json-out", out],
        env=env, capture_output=True, timeout=560,
    )
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    doc = json.loads(open(out).read())
    assert doc["processes"] == 2
    for name in ("data_parallel", "frame_parallel"):
        sc = doc["scenarios"][name]
        assert sc["multi_process"]["global_devices"] == 4
        p = sc["parity_psnr_db_vs_single"]
        assert p == "bit-identical" or float(p) > 70.0
    # frame_parallel really spans processes on the frame axis
    assert doc["scenarios"]["frame_parallel"]["multi_process"]["mesh"] == {
        "data": 1, "frame": 4
    }

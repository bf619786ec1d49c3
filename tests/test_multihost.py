"""Multi-host (DCN) layer: two jax.distributed CPU processes, two virtual
devices each, run the REAL sharded calling step over the global 4-device
mesh on ds200k and verify every statistic against the local host engines
(the worker does the asserts; see tests/multihost_worker.py)."""

import os

import pytest as _pytest

pytestmark = _pytest.mark.slow
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_mesh():
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    worker = os.path.join(HERE, "multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2",
                               str(port)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n"
                    + "\n".join(o or "" for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, f"worker {i} output:\n{out[-4000:]}"

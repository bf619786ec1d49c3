"""Device kernels: the production tile kernel via the driver entry
points + the multichip mesh dry run."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow


def test_entry_kernel_matches_host_engine():
    """__graft_entry__.entry() jits the PRODUCTION tile kernel
    (ops/accumulate.py tile_kernel_core) on real ds200k tensors; its
    base_tot output must equal the host engine's per-base totals."""
    import os

    import jax

    import __graft_entry__ as ge
    from grom_tpu.call import scan as scan_mod
    from grom_tpu.testing.fixtures import chrom_inputs

    d = os.path.join(os.path.dirname(__file__), "data", "ds200k")
    ci = chrom_inputs(d)
    fn, args = ge.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    base_tot = np.asarray(out[0])

    arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                         ci.scan_start)
    host = (arr.snv.sum(axis=0) + arr.snv_lowmq.sum(axis=0)).astype(np.int64)
    L = len(ci.chrom)
    assert np.array_equal(base_tot[:L], host)


def test_mesh_dryrun():
    """Run the multichip dry run in a subprocess with a virtual 8-device CPU
    mesh (the forced device count must be set before jax initializes)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dryrun_multichip ok" in r.stdout

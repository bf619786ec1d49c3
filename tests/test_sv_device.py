"""Device SV scorer (ops/sv_device.py) end-to-end parity: with the scorer
forced on (GROM_TPU_DEVICE_SV=1) on CPU devices, the full CLI output must be
byte-identical to the committed reference-binary golden files — proving the
screen's binomial gathers run under jit inside the scorer's own x64 scope
(x64 is not on for the process) without perturbing a single printed
digit."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _run(tmp_path, fixture, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["GROM_TPU_DEVICE_SV"] = "1"
    env.pop("JAX_ENABLE_X64", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = str(tmp_path / "out.vcf")
    r = subprocess.run([sys.executable, "-m", "grom_tpu",
                        "-i", os.path.join(DATA, fixture, "ds.bam"),
                        "-r", os.path.join(DATA, fixture, "ds.fa"),
                        "-o", out, *extra],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


def _body(path):
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##"))


@pytest.mark.parametrize("fixture,extra", [("ds200k", ()),
                                           ("dup60k", ("-M",)),
                                           ("sv400k", ())])
def test_device_scorer_x64_byte_parity(tmp_path, fixture, extra):
    if not os.path.exists(os.path.join(DATA, fixture, "oracle.vcf")):
        pytest.skip("fixture %s not committed" % fixture)
    out = _run(tmp_path, fixture, extra)
    assert _body(out) == _body(os.path.join(DATA, fixture, "oracle.vcf"))


def test_scorer_unit_matches_numpy_x64():
    """Direct DeviceSvScorer vs numpy score_sv_entries (pad-bucket path),
    with x64 off for the process: the scorer scopes it itself."""
    import jax
    assert not jax.config.read("jax_enable_x64")
    from grom_tpu.call.sv_screen import score_sv_entries
    from grom_tpu.ops.sv_device import DeviceSvScorer
    MT, AF = 50, 10
    rng = np.random.default_rng(3)
    mq = np.sort(rng.random((MT + 1, MT + 1)))[:, ::-1].copy()
    hez = np.sort(rng.random((MT + 1, MT + 1)))[:, ::-1].copy()
    n = 777   # deliberately not a pow2: exercises the pad slice
    pos = np.sort(rng.integers(1000, 50000, n)).astype(np.int64)
    etype = rng.integers(1, 11, n).astype(np.int32)
    count = rng.integers(0, AF * 2 * MT, n).astype(np.int64)
    rs = pos - rng.integers(0, 400, n)
    re = pos - rng.integers(-100, 300, n)
    rd = rng.integers(0, 3 * MT, n).astype(np.int64)
    wf = rng.integers(0, AF * MT, n).astype(np.int64)
    wr = rng.integers(0, AF * MT, n).astype(np.int64)
    cfh = rng.integers(0, AF * MT, n).astype(np.int64)
    args = (pos, etype, count, rs, re, rd, wf, wr, cfh)
    kw = dict(af=AF, mt=MT, md=2, thr1=0.5, mean=300, lseq=100)
    exp = score_sv_entries(np, *args, mq, hez, **kw)
    sc = DeviceSvScorer(mq, hez, AF, MT, 2, 0.5, 300, 100)
    got = sc(*args)
    for e, g in zip(exp, got):
        assert e.dtype == g.dtype
        assert (np.asarray(e) == np.asarray(g)).all()
    assert not jax.config.read("jax_enable_x64")

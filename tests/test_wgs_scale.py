"""WGS-scale memory + parity gates (VERDICT-r3 items 1-2).

1. ``test_streamed_matches_whole_batch_24mb``: chunked streaming (4Mb
   ingest / 1Mb detect chunks) vs the whole-batch path on a 24Mb @ 30x
   chromosome — rows byte-identical. This is the chunk-locality proof at a
   scale where every boundary kind (ingest chunk, detect chunk, drain lag,
   scan_end hold-back) occurs many times.
2. ``test_250mb_bounded_memory``: the WGS memory gate — a 250Mb @ 30x
   chromosome through the full CLI with the slab pool capped at 2GB
   (emulating a small-RAM host): peak live slab bytes must stay under
   16GB (the reference calls a whole human genome in ~13GB single-threaded,
   reference README.md:12), and rows must be identical across two different
   chunk configurations.

Both tests generate their datasets with bulk_sim (deterministic); artifacts
(wall, peak live) are appended to the pytest report via printed lines.
"""

import json
import os
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(bam, fa, out, env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-m", "grom_tpu", "-i", bam,
                        "-r", fa, "-o", out],
                       env=env, capture_output=True, text=True, timeout=1700)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stderr


def _body(path):
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##"))


def test_streamed_matches_whole_batch_24mb(tmp_path):
    from grom_tpu.testing.bulk_sim import bulk_dataset
    fa, bam = bulk_dataset(str(tmp_path / "m24"), 24_000_000, coverage=30.0,
                           seed=5, snp_rate=1e-3,
                           hotspots=[(6_000_000, 6_020_000, 20.0)],
                           depressions=[(14_000_000, 14_040_000, 0.4)],
                           repeats=[(20_000_000, 20_010_000, b"AT")])
    _run_cli(bam, fa, str(tmp_path / "chunked.vcf"),
             {"GROM_TPU_CHUNK_BASES": str(4 << 20),
              "GROM_TPU_DETECT_BASES": str(1 << 20)})
    # whole-batch: disable streaming entirely (the legacy everything-in-RAM
    # path call_chromosome)
    _run_cli(bam, fa, str(tmp_path / "whole.vcf"),
             {"GROM_TPU_STREAM_BASES": str(1 << 40)})
    assert _body(tmp_path / "chunked.vcf") == _body(tmp_path / "whole.vcf")
    assert _body(tmp_path / "chunked.ctx.vcf") == \
        _body(tmp_path / "whole.ctx.vcf")


@pytest.mark.skipif(os.environ.get("GROM_TPU_RUN_WGS") != "1",
                    reason="~25 min + ~7GB disk; set GROM_TPU_RUN_WGS=1")
def test_250mb_bounded_memory(tmp_path):
    from grom_tpu.testing.bulk_sim import bulk_dataset
    fa, bam = bulk_dataset(str(tmp_path / "c250"), 250_000_000,
                           coverage=30.0, seed=11, snp_rate=1e-3,
                           hotspots=[(40_000_000, 40_060_000, 3.0)],
                           depressions=[(120_000_000, 120_120_000, 0.4)],
                           repeats=[(180_000_000, 180_040_000, b"AT")])
    stats = {}
    outs = {}
    for tag, (c, d) in (("a", (8 << 20, 2 << 20)), ("b", (4 << 20, 1 << 20))):
        out = str(tmp_path / ("out_%s.vcf" % tag))
        err = _run_cli(bam, fa, out, {
            "GROM_TPU_POOL_CAP": str(2 << 30),
            "GROM_TPU_CHUNK_BASES": str(c),
            "GROM_TPU_DETECT_BASES": str(d),
            "GROM_TPU_TIMING": "1",
        })
        m = re.search(r"'live_max': (\d+)", err)
        assert m, err[-2000:]
        stats[tag] = int(m.group(1))
        outs[tag] = _body(out)
    print("WGS250 peak live bytes:", json.dumps(stats))
    assert outs["a"] == outs["b"]          # chunk-size independence
    for tag, lm in stats.items():
        assert lm < 16 << 30, (tag, lm)    # the WGS memory gate

"""Differential test: the device (jax) accumulate + SNV screen engine
(ops/accumulate.py + call/snv.py:candidates_from_device) must reproduce the
host engines' results exactly — same SnvCandidates, same base_tot — and the
full device-engine pipeline must emit byte-identical VCF rows.

Runs on the CPU jax backend (tests force JAX_PLATFORMS=cpu); all compared
quantities are integers or reference-replicated float32 ops, so backend
choice cannot change them.
"""

import os

import pytest as _pytest

pytestmark = _pytest.mark.slow
import subprocess
import sys

import numpy as np
import pytest

from grom_tpu.call import scan as scan_mod
from grom_tpu.call import snv as snv_mod
from grom_tpu.call.deposits import run_deposits
from grom_tpu.config import DerivedConfig, GromConfig
from grom_tpu.ingest import bam as bam_mod
from grom_tpu.ingest import fasta as fasta_mod
from grom_tpu.ingest.batches import build_batch
from grom_tpu.ingest.insert_size import load_or_estimate
from grom_tpu.stats import binom

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("ds", ["ds200k", "dup60k"])
def test_device_matches_host(ds):
    d = os.path.join(DATA, ds)
    cfg = GromConfig(bam=os.path.join(d, "ds.bam"),
                     ref_fasta=os.path.join(d, "ds.fa"),
                     out_vcf="/tmp/x.vcf")
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    header, reads = bam_mod.read_bam(cfg.bam)
    ins = load_or_estimate(cfg.bam, reads, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean,
                                          ins.insert_min, ins.insert_max,
                                          ins.read_len, ins.mapped_read_bases)
    mq_table = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                                    cfg.max_trials)
    hez_table = binom.build_hez_table(cfg.max_trials)
    from grom_tpu.driver import _subset_reads
    from grom_tpu.ops.accumulate import get_accumulator
    acc = get_accumulator()
    assert acc is not None
    for refid, bam_name in enumerate(header.ref_names):
        fa = fasta_mod.match_chromosome(bam_name, info.names)
        if fa is None:
            continue
        sel = np.flatnonzero(reads.refid == refid)
        if not len(sel):
            continue
        chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa)
        sub = _subset_reads(reads, sel)
        batch = build_batch(sub, refid, cfg.min_mapq, cfg.add_factor,
                            cfg.rmdup)
        scan_start, scan_end, _ = scan_mod.scan_bounds(cfg, drv, sub.pos, 0)
        dense, _ = run_deposits(len(chrom), batch, fa.lower(), cfg, drv,
                                scan_start)
        eligible = batch.keep & (batch.pos >= scan_start)
        gate = dense.rd + dense.indel_sc_rd

        res = acc.run(chrom, batch, eligible, cfg, gate)
        assert res is not None
        base_tot_dev, dev_cand = res

        # host reference
        arr = scan_mod.accumulate_chromosome(chrom, batch, cfg, drv,
                                             scan_start)
        arr.one_base_rd = dense.rd
        arr.indel_sc_rd = dense.indel_sc_rd
        arr.sc_rd = dense.sc_rd
        base_tot_host = (arr.snv.sum(axis=0)
                         + arr.snv_lowmq.sum(axis=0)).astype(np.int64)
        assert np.array_equal(base_tot_dev, base_tot_host)

        c_host = snv_mod.detect_snv_candidates(chrom, arr, cfg, mq_table,
                                               hez_table, scan_start,
                                               scan_end)
        c_dev = snv_mod.candidates_from_device(dev_cand, chrom, cfg,
                                               mq_table, hez_table,
                                               scan_start, scan_end)
        assert len(c_host) == len(c_dev), (ds, bam_name)
        for f in ("pos", "alt", "ratio", "binom_cdf", "hez_cdf", "counts",
                  "lowmq", "bq_all", "mq_all", "bq", "mq", "bq_read_count",
                  "mq_read_count", "read_count_all", "pos_in_read",
                  "fstrand"):
            a, b = getattr(c_host, f), getattr(c_dev, f)
            assert np.array_equal(np.asarray(a), np.asarray(b)), (ds, f)


@pytest.mark.slow
def test_device_engine_end_to_end(tmp_path):
    """Full CLI run with GROM_TPU_ENGINE=device == host engine output."""
    d = os.path.join(DATA, "ds200k")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    outs = {}
    for engine in ("host", "device"):
        out = tmp_path / ("%s.vcf" % engine)
        env["GROM_TPU_ENGINE"] = engine
        r = subprocess.run(
            [sys.executable, "-m", "grom_tpu", "-i",
             os.path.join(d, "ds.bam"), "-r", os.path.join(d, "ds.fa"),
             "-o", str(out)],
            env=env, capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        outs[engine] = out.read_text()
    assert outs["host"] == outs["device"]

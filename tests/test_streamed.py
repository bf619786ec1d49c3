"""Streamed (bounded-memory, chunked-read) chromosome calling must emit
EXACTLY the same rows as the whole-batch path — host engine and the
sequential device engine (CPU backend), with chunk sizes small enough to
force many chunks and reads straddling chunk boundaries."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from grom_tpu.config import DerivedConfig, GromConfig
from grom_tpu.driver import (_subset_reads, call_chromosome,
                             call_chromosome_streamed)
from grom_tpu.ingest import bam as bam_mod
from grom_tpu.ingest import fasta as fasta_mod
from grom_tpu.ingest.insert_size import load_or_estimate
from grom_tpu.stats import binom

DATA = os.path.join(os.path.dirname(__file__), "data")


def _setup(ds):
    d = os.path.join(DATA, ds)
    cfg = GromConfig(bam=os.path.join(d, "ds.bam"),
                     ref_fasta=os.path.join(d, "ds.fa"), out_vcf="/tmp/x.vcf")
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    header, reads = bam_mod.read_bam(cfg.bam)
    ins = load_or_estimate(cfg.bam, reads, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean,
                                          ins.insert_min, ins.insert_max,
                                          ins.read_len, ins.mapped_read_bases)
    mq = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                              cfg.max_trials)
    hez = binom.build_hez_table(cfg.max_trials)
    fa = fasta_mod.match_chromosome(header.ref_names[0], info.names)
    chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa)
    return cfg, drv, mq, hez, chrom, reads, fa


@pytest.mark.parametrize("ds,engine,chunk", [("ds200k", "host", 37_000),
                                             ("sv400k", "host", 37_000),
                                             ("ds200k", "device", 80_000)])
def test_streamed_matches_whole(ds, engine, chunk):
    cfg, drv, mq, hez, chrom, reads, fa = _setup(ds)
    sel = np.flatnonzero(reads.refid == 0)
    rows_w, ctx_w = call_chromosome(chrom, reads, sel, 0, fa.lower(), cfg,
                                    drv, mq, hez, engine=engine)

    ends = bam_mod.alignment_ends(reads)

    def fetch(t0, t1):
        # every read whose alignment overlaps [t0, t1) — what a BAI-planned
        # regional fetch returns
        s = np.flatnonzero((reads.refid == 0) & (reads.pos < t1)
                           & (ends > t0))
        return _subset_reads(reads, s)

    rows_s, ctx_s = call_chromosome_streamed(
        chrom, 0, fa.lower(), cfg, drv, mq, hez, fetch, engine=engine,
        chunk_bases=chunk)
    assert rows_s == rows_w
    assert ctx_s == ctx_w

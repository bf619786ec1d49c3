"""Differential tests for the SHARDED real pipeline (parallel/pipeline.py):
the mesh accumulator must reproduce the sequential device engine and the
host engines exactly — per-base stats, candidate sets, the all_gather'd
caf_rd_* depth carry, and the psum'd global histogram — and the full
mesh-engine pipeline must emit byte-identical VCFs on the 8-virtual-device
CPU mesh (conftest forces JAX_PLATFORMS=cpu ×8).
"""

import os

import pytest as _pytest

pytestmark = _pytest.mark.slow

import numpy as np
import pytest

from grom_tpu.call import scan as scan_mod
from grom_tpu.call import snv as snv_mod
from grom_tpu.config import GromConfig
from grom_tpu.stats import binom
from grom_tpu.testing.fixtures import chrom_inputs

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("shape,seg_l",
                         [((4, 2), None),     # full 8-device dp×sp mesh
                          ((2, 2), 1 << 14),  # multi-round launches
                          ((1, 1), None)])    # degenerate single device
def test_mesh_matches_host_and_sequential_device(shape, seg_l):
    import jax

    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.parallel.pipeline import HIST_BINS, MeshAccumulator

    chrom, batch, eligible, gate, dense, cfg, drv, ss, se = chrom_inputs(
        os.path.join(DATA, "ds200k"))
    mesh = make_mesh(*shape, devices=jax.devices("cpu"))
    acc = MeshAccumulator(mesh=mesh, seg_l=seg_l)
    res = acc.run(chrom, batch, eligible, cfg, gate)
    assert res is not None
    base_tot, dev_cand, (rd_mq, rd_hi, rd_lo), hist = res

    # host reference (includes exact name dedup + rd lists)
    arr = scan_mod.accumulate_chromosome(chrom, batch, cfg, drv, ss)
    arr.one_base_rd = dense.rd
    arr.indel_sc_rd = dense.indel_sc_rd
    arr.sc_rd = dense.sc_rd
    base_host = (arr.snv.sum(axis=0) + arr.snv_lowmq.sum(axis=0))
    assert np.array_equal(base_tot, base_host.astype(np.int64))
    assert np.array_equal(rd_mq, arr.rd_mq)
    assert np.array_equal(rd_hi, arr.rd_hi)
    assert np.array_equal(rd_lo, arr.rd_lo)

    # psum'd histogram == histogram of the host depth list
    hist_host = np.bincount(np.clip(arr.rd_hi, 0, HIST_BINS - 1),
                            minlength=HIST_BINS).astype(np.int64)
    assert np.array_equal(hist, hist_host)

    # SNV candidates derived from mesh stats == host detection
    mq_table = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                                    cfg.max_trials)
    hez_table = binom.build_hez_table(cfg.max_trials)
    c_host = snv_mod.detect_snv_candidates(chrom, arr, cfg, mq_table,
                                           hez_table, ss, se)
    c_mesh = snv_mod.candidates_from_device(dev_cand, chrom, cfg, mq_table,
                                            hez_table, ss, se)
    assert len(c_host) == len(c_mesh)
    for f in ("pos", "alt", "ratio", "binom_cdf", "hez_cdf", "counts",
              "lowmq", "bq_all", "mq_all", "bq", "mq", "bq_read_count",
              "mq_read_count", "read_count_all", "pos_in_read", "fstrand"):
        a, b = getattr(c_host, f), getattr(c_mesh, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f


def test_mesh_engine_vcf_parity(tmp_path):
    """Full pipeline with engine='mesh' on the 8-device mesh emits VCF + ctx
    byte-identical to the serial host engine (in-process; strict mode makes
    a silent fallback to host a hard failure)."""
    import jax

    from grom_tpu.driver import run
    from grom_tpu.parallel.mesh import make_mesh

    d = os.path.join(DATA, "ds200k")
    base = GromConfig(bam=os.path.join(d, "ds.bam"),
                      ref_fasta=os.path.join(d, "ds.fa"), out_vcf="")
    run(base.replace(out_vcf=str(tmp_path / "host.vcf")),
        file_date="2026725", engine="host")
    mesh = make_mesh(4, 2, devices=jax.devices("cpu"))
    os.environ["GROM_TPU_STRICT"] = "1"
    try:
        run(base.replace(out_vcf=str(tmp_path / "mesh.vcf")),
            file_date="2026725", engine="mesh", mesh=mesh)
        # sequential device engine end-to-end too (same strict gate)
        run(base.replace(out_vcf=str(tmp_path / "device.vcf")),
            file_date="2026725", engine="device")
    finally:
        del os.environ["GROM_TPU_STRICT"]
    for eng in ("mesh", "device"):
        assert ((tmp_path / "host.vcf").read_bytes()
                == (tmp_path / f"{eng}.vcf").read_bytes()), eng
        assert ((tmp_path / "host.ctx.vcf").read_bytes()
                == (tmp_path / f"{eng}.ctx.vcf").read_bytes()), eng


def test_mesh_engine_chunked_vcf_parity(tmp_path):
    """Chunk-ranged mesh: the streamed path with engine='mesh' and a chunk
    size forcing MULTIPLE chunks (span clipping + per-chunk cell grids +
    device rd depth) emits byte-identical VCFs under strict mode."""
    import jax

    from grom_tpu.driver import run
    from grom_tpu.parallel.mesh import make_mesh

    d = os.path.join(DATA, "ds200k")
    base = GromConfig(bam=os.path.join(d, "ds.bam"),
                      ref_fasta=os.path.join(d, "ds.fa"), out_vcf="")
    run(base.replace(out_vcf=str(tmp_path / "host.vcf")),
        file_date="2026725", engine="host")
    mesh = make_mesh(4, 2, devices=jax.devices("cpu"))
    os.environ["GROM_TPU_STRICT"] = "1"
    os.environ["GROM_TPU_CHUNK_BASES"] = str(60_000)   # ~4 chunks
    try:
        run(base.replace(out_vcf=str(tmp_path / "mesh.vcf")),
            file_date="2026725", engine="mesh", mesh=mesh)
    finally:
        del os.environ["GROM_TPU_STRICT"]
        del os.environ["GROM_TPU_CHUNK_BASES"]
    assert ((tmp_path / "host.vcf").read_bytes()
            == (tmp_path / "mesh.vcf").read_bytes())
    assert ((tmp_path / "host.ctx.vcf").read_bytes()
            == (tmp_path / "mesh.ctx.vcf").read_bytes())


@pytest.mark.slow
def test_mesh_engine_real_depth(tmp_path):
    """Mesh parity at REAL coverage: 10Mb @ 30x, multi-chunk + multi-launch
    under strict mode. This is the regime the 0.6x scale test can't reach —
    pow2 bucket sizing and the overflow->fallback path
    (parallel/pipeline.py) see realistic event densities here."""
    import jax

    from grom_tpu.driver import run
    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.testing.bulk_sim import bulk_dataset

    fa, bam = bulk_dataset(str(tmp_path / "deep"), 10_000_000,
                           coverage=30.0, seed=23, snp_rate=1e-3,
                           hotspots=[(2_000_000, 2_020_000, 3.0)],
                           depressions=[(6_000_000, 6_040_000, 0.4)])
    base = GromConfig(bam=bam, ref_fasta=fa, out_vcf="")
    run(base.replace(out_vcf=str(tmp_path / "host.vcf")),
        file_date="2026725", engine="host")
    mesh = make_mesh(4, 2, devices=jax.devices("cpu"))
    os.environ["GROM_TPU_STRICT"] = "1"
    os.environ["GROM_TPU_CHUNK_BASES"] = str(3 << 20)   # 4 ingest chunks
    try:
        run(base.replace(out_vcf=str(tmp_path / "mesh.vcf")),
            file_date="2026725", engine="mesh", mesh=mesh)
    finally:
        del os.environ["GROM_TPU_STRICT"]
        del os.environ["GROM_TPU_CHUNK_BASES"]
    assert ((tmp_path / "host.vcf").read_bytes()
            == (tmp_path / "mesh.vcf").read_bytes())
    assert ((tmp_path / "host.ctx.vcf").read_bytes()
            == (tmp_path / "mesh.ctx.vcf").read_bytes())


@pytest.mark.slow
def test_mesh_engine_large_chromosome(tmp_path):
    """The VERDICT-r2 scale gate: engine='mesh' on a simulated >=100Mb
    chromosome runs CHUNKED (the old whole-chromosome-only mesh limit is
    gone) under GROM_TPU_STRICT with byte-identical VCF vs the host
    engine. Low coverage keeps the wall manageable; the chunk/cell/carry
    machinery exercised is coverage-independent."""
    import jax

    from grom_tpu.driver import run
    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.testing.bulk_sim import bulk_dataset

    fa, bam = bulk_dataset(str(tmp_path / "big"), 100_000_000,
                           coverage=0.6, seed=11)
    base = GromConfig(bam=bam, ref_fasta=fa, out_vcf="")
    run(base.replace(out_vcf=str(tmp_path / "host.vcf")),
        file_date="2026725", engine="host")
    mesh = make_mesh(4, 2, devices=jax.devices("cpu"))
    os.environ["GROM_TPU_STRICT"] = "1"
    try:
        run(base.replace(out_vcf=str(tmp_path / "mesh.vcf")),
            file_date="2026725", engine="mesh", mesh=mesh)
    finally:
        del os.environ["GROM_TPU_STRICT"]
    assert ((tmp_path / "host.vcf").read_bytes()
            == (tmp_path / "mesh.vcf").read_bytes())

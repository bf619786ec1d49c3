"""Device kernels compiled for the card, each against its plain reference at
the widths the pipeline dispatches: the tile kernel (production bucket
shapes), the one-card mesh step, the f64 CNV kernels and the f64 SV scorer.

These need a GPU and skip elsewhere. ``python chip_smoke.py`` runs them on
the card (``JAX_PLATFORMS=cuda python -m pytest tests/test_chip.py -m chip
-s``) and prints the ``KERNEL`` lines: first-call and steady wall,
XLA compiles and their seconds, and the device's peak bytes."""

import os
import time

import numpy as np
import pytest

pytestmark = pytest.mark.chip

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU card (run by chip_smoke.py)")
    return jax.devices()[0]


class _Compiles:
    """XLA backend compiles seen while the block runs (JAX's monitoring
    hook): count and seconds."""

    def __init__(self):
        import jax
        self.n, self.s = 0, 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.s += secs

    def snap(self):
        return self.n, self.s


@pytest.fixture(scope="module")
def compiles(gpu):
    return _Compiles()


def _report(name, **kv):
    print("KERNEL %-22s %s" % (name, " ".join(
        "%s=%s" % (k, ("%.6f" % v) if isinstance(v, float) else v)
        for k, v in kv.items())), flush=True)


def _timed(fn, compiles, reps=3):
    """(first-call wall, compiles in it, their seconds, steady wall per
    call, last result) — every wall ends in block_until_ready."""
    import jax
    c0, s0 = compiles.snap()
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    c1, s1 = compiles.snap()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return first, c1 - c0, s1 - s0, (time.perf_counter() - t0) / reps, out


@pytest.fixture(scope="module")
def ds200k(gpu):
    from grom_tpu.call import scan as scan_mod
    from grom_tpu.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                         ci.scan_start)
    return ci, arr


def test_tile_kernel_production_shapes(ds200k, compiles):
    """The sequential device engine on ds200k (one 2^18-position tile, the
    production 2^23-event buckets) equals the host engine; the tile kernel
    alone is then replayed on the same device inputs for its device time."""
    import jax

    from grom_tpu.call import snv as snv_mod
    from grom_tpu.ops import accumulate
    from grom_tpu.stats import binom
    ci, arr = ds200k
    calls = []
    orig = accumulate._tile_kernel

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    accumulate._tile_kernel = spy
    try:
        acc = accumulate.get_accumulator()
        first, nc, cs, steady, res = _timed(
            lambda: acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg,
                            ci.gate), compiles, reps=2)
    finally:
        accumulate._tile_kernel = orig
    base_tot, dev = res
    host_tot = (arr.snv.sum(0) + arr.snv_lowmq.sum(0)).astype(np.int64)
    assert np.array_equal(base_tot, host_tot)
    cfg = ci.cfg
    mq = binom.build_mq_table(max(cfg.min_mapq, 10), cfg.max_trials)
    hez = binom.build_hez_table(cfg.max_trials)
    arr.one_base_rd = ci.dense.rd
    arr.indel_sc_rd = ci.dense.indel_sc_rd
    arr.sc_rd = ci.dense.sc_rd
    c_host = snv_mod.detect_snv_candidates(ci.chrom, arr, cfg, mq, hez,
                                           ci.scan_start, ci.scan_end)
    c_dev = snv_mod.candidates_from_device(dev, ci.chrom, cfg, mq, hez,
                                           ci.scan_start, ci.scan_end)
    assert len(c_host) == len(c_dev) > 0
    for f in ("pos", "alt", "counts", "bq", "mq", "binom_cdf", "hez_cdf"):
        assert np.array_equal(np.asarray(getattr(c_host, f)),
                              np.asarray(getattr(c_dev, f))), f

    a, k = calls[0]
    lowered = orig.lower(*a, **k)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    reps = 10
    jax.block_until_ready(compiled(*a))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*a)
    jax.block_until_ready(out)
    per_call = (time.perf_counter() - t0) / reps
    _report("tile_kernel", e_cap=k["e_cap"], first_run_s=first,
            compiles=nc, compile_s=cs, steady_run_s=steady,
            recompile_s=t_compile, device_call_s=per_call,
            temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            arg_bytes=getattr(mem, "argument_size_in_bytes", None))


def test_mesh_step_one_card(ds200k, compiles):
    """The sharded mesh step on a one-card (1, 1) mesh equals the host
    engine: per-base totals and the all_gather'd depth carry."""
    import jax

    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.parallel.pipeline import MeshAccumulator
    ci, arr = ds200k
    acc = MeshAccumulator(mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    first, nc, cs, steady, res = _timed(
        lambda: acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate),
        compiles, reps=2)
    assert res is not None
    base_tot, dev, (rd_mq, rd_hi, rd_lo), _ = res
    host_tot = (arr.snv.sum(0) + arr.snv_lowmq.sum(0)).astype(np.int64)
    assert np.array_equal(base_tot, host_tot)
    for a, b in ((rd_mq, arr.rd_mq), (rd_hi, arr.rd_hi), (rd_lo, arr.rd_lo)):
        assert np.array_equal(a, b)
    _report("mesh_step_1card", first_run_s=first, compiles=nc,
            compile_s=cs, steady_run_s=steady)


@pytest.fixture(scope="module")
def cnvrich(gpu):
    from grom_tpu.call import scan as scan_mod
    from grom_tpu.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "cnvrich"))
    arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                         ci.scan_start)
    return ci.chrom, arr, ci.cfg, ci.drv


def _del_dup(chrom, arr, cfg, drv, engine):
    """detect_del_dup's (dels, dups) on the numpy ("host", native C off)
    or the device path."""
    from grom_tpu.call import cnv as cnv_mod
    orig = cnv_mod._native_cnv_ctx
    cnv_mod._native_cnv_ctx = lambda *a, **k: None
    try:
        feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                             cfg.min_repeat)
        prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo,
                                arr.rd_mq, cfg, drv)
        return cnv_mod.detect_del_dup(chrom, feats, prep, arr.rd_hi,
                                      arr.rd_lo, cfg, drv, cfg.ploidy,
                                      engine=engine)
    finally:
        cnv_mod._native_cnv_ctx = orig


def test_cnv_kernels_f64(cnvrich, compiles):
    """The f64 CNV kernels on the card against the numpy host stages on
    cnvrich (1 Mb, CNV-rich): z-scores, null-window model, and the full
    detect_del_dup calls (coordinates and copy numbers exact, SD within
    float tolerance)."""
    from grom_tpu.call import cnv as cnv_mod
    from grom_tpu.ops import cnv_device
    chrom, arr, cfg, drv = cnvrich
    cfg = cfg.replace(rd_pval_threshold=1e-4)
    feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                         cfg.min_repeat)
    prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                            cfg, drv)
    depth = arr.rd_hi.astype(np.int32) + arr.rd_lo.astype(np.int32)
    (hi_arr, lo_arr), ave, std, nwin, _, _ = cnv_mod._sample_distributions(
        chrom, feats, prep, arr.rd_hi, arr.rd_lo, cfg, drv, cfg.ploidy,
        rng=np.random.default_rng(0), depth=depth)
    L, NB = len(chrom), cfg.num_gc_bins
    gc, mq = feats.gc_weighted, prep.mq_mean
    low_acgt = np.zeros(L, np.int8)
    lo, hi = drv.insert_mean - 1, L - (2 * drv.insert_mean - 1)
    pv_p, pv_sd = cnv_mod.build_pval2sd()
    host_z = np.zeros(L)
    cnv_mod._zscores_numpy(host_z, [(lo, hi)], depth, mq, gc, low_acgt,
                           nwin, hi_arr, lo_arr, ave, std, pv_p, pv_sd, cfg)
    mat, lens = cnv_device.build_bin_matrix(hi_arr, lo_arr, NB)
    first, nc, cs, steady, z = _timed(lambda: cnv_device.zscores_device(
        depth, mq, gc, low_acgt, mat, lens, ave, std, pv_p, pv_sd, NB, lo,
        hi, cfg.min_mapq, cfg.mapq_factor, cfg.dup_threshold_factor,
        cfg.ranks_stdev != 0), compiles)
    assert z.dtype == np.float64
    nz = host_z != 0
    rel = np.abs(z - host_z)[nz] / np.abs(host_z[nz])
    assert np.array_equal(z == 0, host_z == 0)
    assert rel.max() <= 1e-12, rel.max()
    _report("zscores_device", width=hi - lo, first_call_s=first,
            compiles=nc, compile_s=cs, steady_call_s=steady,
            bitwise=bool(np.array_equal(z, host_z)),
            max_rel_diff=float(rel.max()))

    gate = (low_acgt == 0) & np.where(mq >= cfg.min_mapq, nwin[0, gc] > 1,
                                      nwin[1, gc] > 1)
    host_w = cnv_mod._null_window_model(prep, depth, mq, gc, nwin, low_acgt,
                                        host_z, cfg, L)
    first, nc, cs, steady, w = _timed(lambda: cnv_device.null_model_device(
        prep.lowvar_blocks, host_z, gate, cfg.min_rd_window_len,
        cfg.max_rd_window_len, cfg.sampling_rate), compiles)
    assert np.allclose(w, host_w, rtol=1e-9, atol=1e-12)
    _report("null_model_device", first_call_s=first, compiles=nc,
            compile_s=cs, steady_call_s=steady,
            max_abs_diff=float(np.abs(w - host_w).max()))

    do, po = _del_dup(chrom, arr, cfg, drv, "host")
    first, nc, cs, steady, (dd, pd) = _timed(
        lambda: _del_dup(chrom, arr, cfg, drv, "device"), compiles, reps=1)
    assert len(dd) + len(pd) >= 5
    for dev, host in ((dd, do), (pd, po)):
        assert [(c.start, c.end, c.cn) for c in dev] == \
            [(c.start, c.end, c.cn) for c in host]
        for cd, ch in zip(dev, host):
            assert np.isclose(cd.stdev, ch.stdev, rtol=1e-9, atol=0)
    _report("detect_del_dup_device", first_call_s=first, compiles=nc,
            compile_s=cs, steady_call_s=steady, calls=len(dd) + len(pd))


def test_sv_scorer_f64(gpu, compiles):
    """The device SV scorer at a detection window's width (2^17 entries)
    is bitwise equal to the numpy screen, with x64 off for the process."""
    import jax

    from grom_tpu.call.sv_screen import score_sv_entries
    from grom_tpu.ops.sv_device import DeviceSvScorer
    from grom_tpu.stats import binom
    assert not jax.config.read("jax_enable_x64")
    MT, AF = 1000, 6
    mq = binom.build_mq_table(20, MT)
    hez = binom.build_hez_table(MT)
    rng = np.random.default_rng(3)
    n = (1 << 17) - 5
    pos = np.sort(rng.integers(1000, 4_000_000, n)).astype(np.int64)
    etype = rng.integers(1, 11, n).astype(np.int32)
    count = rng.integers(0, AF * 2 * 60, n).astype(np.int64)
    rs = pos - rng.integers(0, 400, n)
    re = pos - rng.integers(-100, 300, n)
    rd = rng.integers(0, 3 * 60, n).astype(np.int64)
    wf = rng.integers(0, AF * 60, n).astype(np.int64)
    wr = rng.integers(0, AF * 60, n).astype(np.int64)
    cfh = rng.integers(0, AF * 60, n).astype(np.int64)
    args = (pos, etype, count, rs, re, rd, wf, wr, cfh)
    kw = dict(af=AF, mt=MT, md=3, thr1=1e-3, mean=300, lseq=100)
    exp = score_sv_entries(np, *args, mq, hez, **kw)
    sc = DeviceSvScorer(mq, hez, AF, MT, 3, 1e-3, 300, 100)
    first, nc, cs, steady, got = _timed(lambda: sc(*args), compiles)
    for e, g in zip(exp, got):
        assert e.dtype == g.dtype
        assert np.array_equal(np.asarray(e), np.asarray(g))
    assert np.asarray(got[1]).any()
    _report("sv_scorer", entries=n, first_call_s=first, compiles=nc,
            compile_s=cs, steady_call_s=steady)


def test_zz_peak_bytes(gpu):
    stats = gpu.memory_stats() or {}
    _report("device_memory", peak_bytes_in_use=stats.get("peak_bytes_in_use"),
            bytes_limit=stats.get("bytes_limit"))
    assert stats.get("peak_bytes_in_use", 0) > 0

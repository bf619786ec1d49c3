"""Differential tests: device CNV kernels (ops/cnv_device.py, jax) vs the
host implementations in call/cnv.py — bit-identical on the CPU backend
(the kernels run inside JAX's x64 scope themselves). Covers the
SURVEY §7.4 prescription: z-scores + the window-growth scans as prefix-sum
pyramid queries on device."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow

DATA = os.path.join(os.path.dirname(__file__), "data")


def _stage_inputs(fixture):
    """Everything detect_del_dup computes before the z stage, captured by
    running the host path with instrumented internals."""
    from grom_tpu.call import cnv as cnv_mod
    from tests.test_native_cnv import _cnv_inputs

    chrom, arr, cfg, drv = _cnv_inputs(fixture)
    feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                         cfg.min_repeat)
    prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                            cfg, drv)
    return chrom, arr, cfg, drv, feats, prep


@pytest.mark.parametrize("fixture", ["ds200k", "sv400k"])
def test_device_cnv_scan_matches_host(fixture):
    """Full detect_del_dup with the device z-scores + device window scans
    substituted must produce identical call lists (start, end, bitwise
    stdev) to the pure-host path."""
    from grom_tpu.call import cnv as cnv_mod
    from grom_tpu.ops import cnv_device
    from tests.test_native_cnv import _calls, _cnv_inputs

    if not os.path.exists(os.path.join(DATA, fixture, "ds.bam")):
        pytest.skip("fixture missing")
    chrom, arr, cfg, drv = _cnv_inputs(fixture)

    # host oracle (numpy path)
    do, po = _calls(chrom, arr, cfg, drv, native=False)

    # device path: monkeypatch the window scan + z stage
    orig_scan = cnv_mod._window_scan
    orig_ctx = cnv_mod._native_cnv_ctx

    def dev_scan(blocks, depth, mq, gc, nwin, low_acgt, stdev_list, thr,
                 win_std, cfg_, L, side):
        return cnv_device.window_scan_device(
            blocks, depth, mq, gc, nwin, low_acgt, stdev_list, thr,
            win_std, cfg_, L, side)

    cnv_mod._window_scan = dev_scan
    cnv_mod._native_cnv_ctx = lambda *a, **k: None
    try:
        feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                             cfg.min_repeat)
        prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo,
                                arr.rd_mq, cfg, drv)
        dd, pd = cnv_mod.detect_del_dup(chrom, feats, prep, arr.rd_hi,
                                        arr.rd_lo, cfg, drv, cfg.ploidy)
    finally:
        cnv_mod._window_scan = orig_scan
        cnv_mod._native_cnv_ctx = orig_ctx

    for dev, host in ((dd, do), (pd, po)):
        assert [(c.start, c.end, c.stdev) for c in dev] == \
            [(c.start, c.end, c.stdev) for c in host]


def test_device_zscores_match_host():
    """zscores_device == the z stage of the host path, bitwise."""
    import math

    from grom_tpu.call import cnv as cnv_mod
    from grom_tpu.ops import cnv_device
    from tests.test_native_cnv import _cnv_inputs

    chrom, arr, cfg, drv = _cnv_inputs("ds200k")
    L = len(chrom)
    m = drv.insert_mean
    W = 2 * m - 1

    # reproduce the host preamble up to the z stage with the native ctx
    # disabled, capturing stdev_list via the _window_scan hook
    captured = {}
    orig_scan = cnv_mod._window_scan
    orig_ctx = cnv_mod._native_cnv_ctx

    def capture_scan(blocks, depth, mq, gc, nwin, low_acgt, stdev_list,
                     *a, **k):
        if "z" not in captured:
            captured.update(depth=depth, mq=mq, gc=gc, low_acgt=low_acgt,
                            nwin=nwin, z=stdev_list.copy())
        return orig_scan(blocks, depth, mq, gc, nwin, low_acgt,
                         stdev_list, *a, **k)

    cnv_mod._window_scan = capture_scan
    cnv_mod._native_cnv_ctx = lambda *a, **k: None

    # also capture the merged distributions by re-running the sampling
    # stages exactly as detect_del_dup does (deterministic)
    feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                         cfg.min_repeat)
    prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                            cfg, drv)
    try:
        cnv_mod.detect_del_dup(chrom, feats, prep, arr.rd_hi, arr.rd_lo,
                               cfg, drv, cfg.ploidy)
    finally:
        cnv_mod._window_scan = orig_scan
        cnv_mod._native_cnv_ctx = orig_ctx
    assert "z" in captured
    if prep.most_biased_repeat != -1:
        pytest.skip("repeat rescore overwrites z; fixture unsuitable")

    # rebuild bin distributions/ave/std via a second instrumented run of
    # the sampling block (they are deterministic functions of the inputs)
    from grom_tpu.call.cnv import build_pval2sd
    pv_p, pv_sd = build_pval2sd()

    # easiest exact route: recompute using the internals of detect_del_dup
    # by calling it with a scan hook that also captures the dist arrays.
    # The captured nwin gives merged lengths; recover ave/std/dists by
    # replaying detect_del_dud's sampling stanza through the public
    # helper below.
    dists, ave, std, _nwin, _dt, _ut = cnv_mod._sample_distributions(
        chrom, feats, prep, arr.rd_hi, arr.rd_lo, cfg, drv, cfg.ploidy)
    hi_arr, lo_arr = dists
    NB = cfg.num_gc_bins
    mat, lens = cnv_device.build_bin_matrix(hi_arr, lo_arr, NB)
    z_dev = cnv_device.zscores_device(
        captured["depth"], captured["mq"], captured["gc"],
        captured["low_acgt"], mat, lens, ave, std, pv_p, pv_sd, NB,
        m - 1, L - W, cfg.min_mapq, cfg.mapq_factor,
        cfg.dup_threshold_factor, cfg.ranks_stdev != 0)
    assert np.array_equal(z_dev, captured["z"])


def test_device_cnv_env_flag(tmp_path):
    """GROM_TPU_DEVICE_CNV=1 routes detect_del_dup through the device
    kernels end-to-end: identical call boundaries and copy numbers; SD to
    within float tolerance (the device null-window model's prefix sums are
    XLA log-depth scans, so win_std agrees only to ~1e-12 relative — the
    z-scores and window scans themselves remain bit-exact)."""
    from grom_tpu.call import cnv as cnv_mod
    from tests.test_native_cnv import _calls, _cnv_inputs

    chrom, arr, cfg, drv = _cnv_inputs("ds200k")
    do, po = _calls(chrom, arr, cfg, drv, native=False)
    os.environ["GROM_TPU_DEVICE_CNV"] = "1"
    try:
        dd, pd = _calls(chrom, arr, cfg, drv, native=True)
    finally:
        del os.environ["GROM_TPU_DEVICE_CNV"]
    for dev, host in ((dd, do), (pd, po)):
        assert [(c.start, c.end) for c in dev] == \
            [(c.start, c.end) for c in host]
        for cd, ch in zip(dev, host):
            assert np.isclose(cd.stdev, ch.stdev, rtol=1e-9, atol=0), \
                (cd.start, cd.stdev, ch.stdev)
            assert np.isclose(cd.cn, ch.cn, rtol=1e-9, atol=1e-12)


def test_null_model_device_matches_host():
    """Device null-window model vs the host _null_window_model on real
    fixture z-scores: same counts, sums within float tolerance."""
    from grom_tpu.call import cnv as cnv_mod
    from grom_tpu.ops import cnv_device
    from tests.test_native_cnv import _cnv_inputs

    chrom, arr, cfg, drv = _cnv_inputs("ds200k")
    feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                         cfg.min_repeat)
    prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                            cfg, drv)
    depth = arr.rd_hi.astype(np.int32) + arr.rd_lo.astype(np.int32)
    rng = np.random.default_rng(0)
    (hi_arr, lo_arr), ave, std, nwin, del_thr, dup_thr = \
        cnv_mod._sample_distributions(chrom, feats, prep, arr.rd_hi,
                                      arr.rd_lo, cfg, drv, cfg.ploidy,
                                      rng=rng)
    L = len(chrom)
    z = rng.normal(0, 1, L)   # any z field exercises the window machinery
    gc = feats.gc_weighted
    mq = prep.mq_mean
    host = cnv_mod._null_window_model(prep, depth, mq, gc, nwin,
                                      np.ones(L, np.int8) * 0, z, cfg, L)
    gate = (np.zeros(L, np.int8) == 0) & np.where(
        mq >= cfg.min_mapq, nwin[0, gc] > 1, nwin[1, gc] > 1)
    dev = cnv_device.null_model_device(
        prep.lowvar_blocks, z, gate, cfg.min_rd_window_len,
        cfg.max_rd_window_len, cfg.sampling_rate)
    assert host.shape == dev.shape
    assert np.allclose(host, dev, rtol=1e-9, atol=1e-12), \
        np.abs(host - dev).max()

"""Engine choice, failure behaviour and the exact device paths, checked on
the CPU: engine resolution, no silent host fallback, the compile-cache
location, the one-process-per-card -P slots, a small-capacity tile kernel
against the host engine, the device z-scores against the numpy z stage, and
the mesh step under JAX_ENABLE_X64=1."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


class _Dev:
    platform = "gpu"
    device_kind = "test card"


@pytest.mark.parametrize("env,backend,n_dev,cards,want", [
    ({"JAX_PLATFORMS": "cpu"}, None, 0, ["0"], "host"),
    ({"GROM_TPU_ENGINE": "device"}, None, 0, [], "device"),
    ({"GROM_TPU_ENGINE": "mesh"}, None, 0, [], "mesh"),
    ({"GROM_TPU_ENGINE": "host"}, None, 0, [], "host"),
    ({"GROM_TPU_ENGINE": "cuda"}, None, 0, [], ValueError),
    ({"GROM_TPU_ENGINE": "gpu"}, None, 0, [], ValueError),
    ({}, "gpu", 1, ["0"], "device"),
    ({}, "gpu", 4, ["0", "1", "2", "3"], "mesh"),
    ({}, "cpu", 8, [], "host"),
    ({}, "cpu", 8, ["0"], RuntimeError),
], ids=["cpu-only", "device", "mesh", "host", "unknown-cuda", "unknown-gpu",
        "auto-one-card", "auto-four-cards", "auto-cpu-backend",
        "auto-card-without-gpu-backend"])
def test_resolve_engine(monkeypatch, env, backend, n_dev, cards, want):
    """Auto follows the backend; a visible card with JAX on its CPU backend
    (the GPU backend failed to start) is an error, not the host engine."""
    import jax

    from grom_tpu import driver
    monkeypatch.delenv("GROM_TPU_ENGINE", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(driver, "visible_cards", lambda: cards)
    if backend is not None:
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()] * n_dev)
    if isinstance(want, type):
        with pytest.raises(want):
            driver.resolve_engine()
    else:
        assert driver.resolve_engine() == want


class _CpuDev:
    platform = "cpu"
    device_kind = "cpu"


@pytest.mark.parametrize("engine", ["device", "mesh"])
@pytest.mark.parametrize("platforms", ["", "cpu"], ids=["unset", "cpu"])
def test_start_engine_refuses_cpu_backend(monkeypatch, capsys, engine,
                                          platforms):
    """An explicit device engine on JAX's CPU backend raises unless
    JAX_PLATFORMS names only the CPU (the tests' own setting)."""
    import jax

    from grom_tpu import driver
    from grom_tpu.utils import jaxcache
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setattr(jax, "devices", lambda *a: [_CpuDev()])
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(driver, "_STARTED", set())
    if platforms:
        driver.start_engine(engine)
        assert "engine: %s (cpu, cpu, n=1)" % engine in capsys.readouterr().err
    else:
        with pytest.raises(RuntimeError, match="not the GPU"):
            driver.start_engine(engine)


def _chrom_setup(fixture="ds200k"):
    from grom_tpu.config import DerivedConfig, GromConfig
    from grom_tpu.ingest import bam as bam_mod
    from grom_tpu.ingest import fasta as fasta_mod
    from grom_tpu.ingest.insert_size import load_or_estimate
    from grom_tpu.stats import binom
    d = os.path.join(DATA, fixture)
    cfg = GromConfig(bam=os.path.join(d, "ds.bam"),
                     ref_fasta=os.path.join(d, "ds.fa"), out_vcf="/x.vcf")
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


@pytest.mark.parametrize("path", ["whole", "streamed"])
def test_device_failure_raises(monkeypatch, path):
    """A device engine that cannot run raises; it never returns host
    output."""
    from grom_tpu import driver
    from grom_tpu.ops import accumulate

    def broken():
        raise RuntimeError("no device")

    monkeypatch.setattr(accumulate, "get_accumulator", broken)
    cfg, drv, mq, hez, chrom, reads, fa = _chrom_setup()
    sel = np.flatnonzero(reads.refid == 0)
    with pytest.raises(RuntimeError, match="no device"):
        if path == "whole":
            driver.call_chromosome(chrom, reads, sel, 0, fa.lower(), cfg,
                                   drv, mq, hez, engine="device")
        else:
            driver.call_chromosome_streamed(
                chrom, 0, fa.lower(), cfg, drv, mq, hez,
                lambda t0, t1: driver._subset_reads(reads, sel),
                engine="device")


def test_device_overflow_is_one_line_or_strict_error(monkeypatch, capsys):
    """The one data-driven fallback: a bucket overflow at the minimum tile
    width logs one stderr line, and is an error under GROM_TPU_STRICT=1."""
    from grom_tpu.driver import device_overflow
    monkeypatch.delenv("GROM_TPU_STRICT", raising=False)
    device_overflow("chr1")
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "chr1" in err
    monkeypatch.setenv("GROM_TPU_STRICT", "1")
    with pytest.raises(RuntimeError):
        device_overflow("chr1")


_CACHE_PROBE = """
import json, jax
from grom_tpu.utils.jaxcache import REPO_CACHE_DIR, enable_persistent_cache
updates = []
_update = jax.config.update
jax.config.update = lambda k, v: (updates.append(k), _update(k, v))
enable_persistent_cache()
print(json.dumps([jax.config.jax_compilation_cache_dir, updates,
                  REPO_CACHE_DIR]))
"""


@pytest.mark.parametrize("env_dir", [True, False], ids=["env-set", "unset"])
def test_compile_cache_location(tmp_path, env_dir):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    cache_dir, updates, repo_dir = json.loads(r.stdout.splitlines()[-1])
    assert repo_dir == os.path.join(REPO, ".jax_cache")
    if env_dir:
        # JAX reads the variable itself; the code sets no cache option
        assert cache_dir == str(tmp_path / "cc")
        assert updates == []
    else:
        assert cache_dir == repo_dir and os.path.isdir(repo_dir)
        assert "jax_compilation_cache_dir" in updates


@pytest.mark.parametrize("n_cards", [0, 1, 4])
def test_worker_slot_env(n_cards):
    from grom_tpu.cli import worker_env
    cards = [str(i) for i in range(n_cards)]
    for slot in range(6):
        env = worker_env(slot, cards)
        if slot < n_cards:
            assert env == {"CUDA_VISIBLE_DEVICES": str(slot)}
        else:
            assert env == {"CUDA_VISIBLE_DEVICES": "",
                           "GROM_TPU_ENGINE": "host"}


def test_worker_slots_from_counter(monkeypatch, capsys):
    """The pool initializer hands out slots in order: the first takes the
    card, the next runs the host engine; both are printed."""
    import multiprocessing

    from grom_tpu import cli
    mp = multiprocessing.get_context("spawn")
    counter, claimed = mp.Value("i", 0), mp.Value("i", 0)
    monkeypatch.setattr(cli, "_CLAIMED", None)
    seen = []
    for _ in range(2):
        # each call is a fresh worker process: give it its own environment
        env = {k: v for k, v in os.environ.items()
               if k not in ("GROM_TPU_ENGINE", "CUDA_VISIBLE_DEVICES")}
        monkeypatch.setattr(os, "environ", env)
        cli._init_worker(counter, claimed, ["3"])
        seen.append((env["CUDA_VISIBLE_DEVICES"], env.get("GROM_TPU_ENGINE")))
        if len(seen) == 1:
            # the card's worker takes its first job: host slots may start
            assert cli._CLAIMED is claimed
            with claimed.get_lock():
                claimed.value += 1
    assert seen == [("3", None), ("", "host")]
    err = capsys.readouterr().err
    assert "worker slot 0: card 3" in err
    assert "worker slot 1: host engine" in err


def test_host_slot_waits_for_the_cards(monkeypatch):
    """A host slot's initializer returns only once every card's worker has
    claimed a job, so a single chromosome always runs on the card."""
    import multiprocessing
    import threading
    import time

    from grom_tpu import cli
    mp = multiprocessing.get_context("spawn")
    counter, claimed = mp.Value("i", 2), mp.Value("i", 1)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    done = threading.Event()
    t = threading.Thread(target=lambda: (
        cli._init_worker(counter, claimed, ["0", "1"]), done.set()))
    t.start()
    time.sleep(0.3)
    assert not done.is_set()
    with claimed.get_lock():
        claimed.value += 1
    t.join(10)
    assert done.is_set()
    assert os.environ["GROM_TPU_ENGINE"] == "host"


@pytest.mark.parametrize("env,want", [
    ({"CUDA_VISIBLE_DEVICES": "2,5"}, ["2", "5"]),
    ({"CUDA_VISIBLE_DEVICES": ""}, []),
    ({"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "0"}, []),
], ids=["listed", "hidden", "cpu-only"])
def test_visible_cards(monkeypatch, env, want):
    from grom_tpu.driver import visible_cards
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert visible_cards() == want


@pytest.fixture(scope="module")
def ds200k_inputs():
    from grom_tpu.call import scan as scan_mod
    from grom_tpu.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                         ci.scan_start)
    return ci, arr


@pytest.mark.parametrize("t0,width", [(30_000, 2048), (61_000, 4096)])
def test_tile_kernel_small_caps_matches_host(ds200k_inputs, t0, width):
    """tile_kernel_core at a small position width and small buckets equals
    the host engine's per-base tallies, and its SNV screen returns a
    superset of the host's screen hits with the host's exact counts."""
    import functools

    import jax

    import __graft_entry__ as ge
    from grom_tpu.ops.accumulate import tile_kernel_core
    ci, arr = ds200k_inputs
    args, statics, _ = ge.tile_args_from_fixture(ci=ci, t0=t0, width=width)
    fn = jax.jit(functools.partial(tile_kernel_core, **statics))
    base_tot, n_cand, n_mm, cand = jax.device_get(fn(*args))
    assert int(n_mm) <= statics["m_cap"]
    t1 = t0 + width
    host_tot = (arr.snv.sum(0) + arr.snv_lowmq.sum(0))[t0:t1]
    assert np.array_equal(base_tot[:width], host_tot)

    n = int(n_cand)
    assert 0 < n <= statics["k_cap"]
    pos = cand["pos"][:n] + t0
    for k in ("bq", "bq_all", "mq_all", "read_count_all"):
        assert np.array_equal(cand[k][:n], getattr(arr, k)[pos]), k
    assert np.array_equal(cand["mq"][:n], arr.mq[pos])
    assert np.array_equal(cand["counts"][:, :n], arr.snv[:, pos])
    assert np.array_equal(cand["lowmq"][:, :n], arr.snv_lowmq[:, pos])
    # host screen: an alt allele with >= min_snv reads at ratio >= min
    cfg = ci.cfg
    lut = {ord(c): i for i, c in enumerate("ACGT")}
    ref = np.array([lut.get(int(b) & 0xDF, 4) for b in ci.chrom[t0:t1]])
    counts = arr.snv[:, t0:t1].astype(np.int64)
    tot = counts.sum(0)
    alt = np.arange(4)[:, None] != ref[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        hit = (alt & (counts >= cfg.min_snv)
               & (counts >= cfg.min_snv_ratio * tot)
               & (ci.gate[t0:t1] > 0)[None, :]
               & (ref < 4)[None, :]).any(0)
    assert set(np.flatnonzero(hit) + t0) <= set(pos.tolist())


def test_zscores_device_bitwise_numpy():
    """zscores_device inside the x64 scope is bitwise equal to the host
    numpy z stage on a small synthetic chromosome, in rank mode and in
    direct (-K 0) mode."""
    from grom_tpu.call import cnv as cnv_mod
    from grom_tpu.config import GromConfig
    from grom_tpu.ops import cnv_device

    rng = np.random.default_rng(5)
    L, NB = 6000, 101
    depth = rng.poisson(30, L).astype(np.int32)
    depth[rng.random(L) < 0.02] = 0
    mq = rng.integers(0, 60, L).astype(np.int32)
    gc = rng.integers(30, 36, L).astype(np.int64)
    low_acgt = (rng.random(L) < 0.1).astype(np.int8)
    hi_arr = [np.sort(rng.poisson(30, 300)).astype(np.int64)
              if 30 <= b < 36 else np.zeros(0, np.int64) for b in range(NB)]
    lo_arr = [np.sort(rng.poisson(20, 150)).astype(np.int64)
              if 30 <= b < 34 else np.zeros(0, np.int64) for b in range(NB)]
    ave = np.zeros((2, NB))
    std = np.zeros((2, NB))
    nwin = np.zeros((2, NB), np.int64)
    for c, arrs in enumerate((hi_arr, lo_arr)):
        for b, a in enumerate(arrs):
            nwin[c, b] = len(a)
            if len(a) > 1:
                ave[c, b] = a.mean()
                std[c, b] = a.std(ddof=1)
    pv_p, pv_sd = cnv_mod.build_pval2sd()
    mat, lens = cnv_device.build_bin_matrix(hi_arr, lo_arr, NB)
    lo, hi = 150, L - 299
    for ranks in (1, 0):
        cfg = GromConfig(ranks_stdev=ranks)
        host = np.zeros(L)
        cnv_mod._zscores_numpy(host, [(lo, hi)], depth, mq, gc, low_acgt,
                               nwin, hi_arr, lo_arr, ave, std, pv_p, pv_sd,
                               cfg)
        dev = cnv_device.zscores_device(
            depth, mq, gc, low_acgt, mat, lens, ave, std, pv_p, pv_sd, NB,
            lo, hi, cfg.min_mapq, cfg.mapq_factor, cfg.dup_threshold_factor,
            ranks != 0)
        assert dev.dtype == np.float64
        assert np.count_nonzero(host) > L // 2
        assert np.array_equal(dev, host), ranks


_MESH_X64 = """
import os, sys, json
import numpy as np
import jax
assert jax.config.jax_enable_x64
from grom_tpu.call import scan as scan_mod
from grom_tpu.parallel.mesh import make_mesh
from grom_tpu.parallel.pipeline import MeshAccumulator
from grom_tpu.testing.fixtures import chrom_inputs
ci = chrom_inputs(sys.argv[1])
arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                     ci.scan_start)
lo, seg = 60_000, 2048
hi = lo + 8 * seg
acc = MeshAccumulator(mesh=make_mesh(4, 2, devices=jax.devices()[:8]),
                      seg_l=seg)
res = acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate, lo=lo, hi=hi)
assert res is not None
base_tot, dev, (rd_mq, rd_hi, rd_lo), _ = res
host_tot = arr.snv.sum(0) + arr.snv_lowmq.sum(0)
assert np.array_equal(base_tot[lo:hi], host_tot[lo:hi])
for a, b in ((rd_mq, arr.rd_mq), (rd_hi, arr.rd_hi), (rd_lo, arr.rd_lo)):
    assert np.array_equal(a[lo:hi], b[lo:hi])
assert dev["n"] > 0
print("MESH_X64_OK", dev["n"])
"""


def test_mesh_step_under_global_x64():
    """The sharded mesh step traces and matches the host engine with
    JAX_ENABLE_X64=1 on the forced 8-device CPU platform (dynamic_slice
    once got int64 and int32 indices mixed there)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1", JAX_CPU_ENABLE_ASYNC_DISPATCH="false",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _MESH_X64,
                        os.path.join(DATA, "ds200k")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "MESH_X64_OK" in r.stdout

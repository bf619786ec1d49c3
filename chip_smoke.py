#!/usr/bin/env python
"""Smoke run of grom_tpu on a GPU: the CLI main path on the device engine,
checked against the reference-binary oracles and the host engine.

    python chip_smoke.py                  # one card: phases K, A, B, C
    python chip_smoke.py --length 4000000 # shorter Phase B chromosome
    python chip_smoke.py --four           # mesh engine over four cards only

Phases (every device run is its own child process under GROM_TPU_STRICT=1,
one after another, so one process holds a card at a time; this process
never initializes JAX):

  K  the chip-marked kernel tests (tests/test_chip.py): each device kernel
     compiled for the card against its plain reference, with timings;
  A  `python -m grom_tpu` on the device engine over every committed fixture
     with a reference oracle (ds200k, dup60k -M, sv400k, ctx2x60k + its
     ctx VCF, cnvrich -V 1e-4, cnvmany -V 1e-4 as generated by its test);
  B  one seeded 48 Mb chromosome at 30x (the size of human chr21) with
     planted SNPs, GC blocks, depressions, hotspots and repeats, through the
     CLI on the default engine (which must resolve to the device) and on the
     host engine; the VCFs must agree;
  C  the Phase B input with -P 2 on one card: equal to the serial run.

--four runs only Phase B's input through GROM_TPU_ENGINE=mesh over four
cards against the host engine, plus a mesh-step check that results are
spread over all four cards.

VCFs are compared after dropping ## header lines: byte for byte, except the
SD and Z of CNV rows, which may differ by 1e-4 relative (the tolerance the
README documents); CN and CS stay exact. The last line of stdout is one JSON
object: {"ok": ..., "device": {"platform", "kind", "count"}}. Without a GPU
or outside a checkout the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
WORK = os.path.join(REPO, ".smoke_data")
DEFAULT_LENGTH = 48_000_000
COVERAGE = 30.0
SEED = 2101
DATA_VERSION = 1

# (fixture, extra CLI flags, compare the ctx VCF too)
FIXTURES = [("ds200k", [], False),
            ("dup60k", ["-M"], False),
            ("sv400k", [], False),
            ("ctx2x60k", [], True),
            ("cnvrich", ["-V", "1e-4"], False),
            ("cnvmany", ["-V", "1e-4"], False)]


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["GROM_TPU_STRICT"] = "1"
    env.update(extra)
    return env


def run_child(name: str, cmd, env, timeout: int = 1200, cwd=None):
    """Run one child to completion; its output is kept under WORK/logs.
    Raises PhaseFailed on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=cwd or REPO, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    logs = os.path.join(WORK, "logs")
    os.makedirs(logs, exist_ok=True)
    stem = os.path.join(logs, name.replace(" ", "_").replace("/", "_"))
    with open(stem + ".out", "w") as f:
        f.write(r.stdout)
    with open(stem + ".err", "w") as f:
        f.write(r.stderr)
    if r.returncode != 0:
        raise PhaseFailed("%s exited %d after %.1fs:\n%s\n%s" % (
            name, r.returncode, wall, r.stdout[-3000:], r.stderr[-6000:]))
    return r, wall


def vcf_body(path: str):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("##")]


def _cnv_close(a: str, b: str) -> bool:
    ta, tb = a.split("\t"), b.split("\t")
    if len(ta) != len(tb) or ta[:9] != tb[:9] or len(ta) < 10:
        return False
    if not ta[8].startswith("SD:Z:CN"):
        return False
    fa, fb = ta[9].split(":"), tb[9].split(":")
    if len(fa) != 4 or len(fb) != 4 or fa[2:] != fb[2:]:
        return False
    return all(abs(float(x) - float(y)) <= 1e-4 * max(abs(float(y)), 1e-300)
               for x, y in zip(fa[:2], fb[:2]))


def compare_vcf(got: str, want: str):
    """(data rows, CNV rows within tolerance but not byte-equal); raises
    PhaseFailed at the first difference."""
    a, b = vcf_body(got), vcf_body(want)
    if len(a) != len(b):
        raise PhaseFailed("%s: %d lines vs %d in %s" % (got, len(a), len(b),
                                                       want))
    near = 0
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        if not _cnv_close(x, y):
            raise PhaseFailed("%s line %d differs from %s:\n  %s\n  %s"
                              % (got, i, want, x, y))
        near += 1
    return sum(1 for x in a if not x.startswith("#")), near


def engine_line(stderr: str) -> str:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("engine: ")]
    return lines[0] if lines else ""


def expect_engine(stderr: str, engine: str, n_cards: int = 1) -> str:
    line = engine_line(stderr)
    want = "engine: %s (gpu, " % engine
    if not line.startswith(want) or not line.endswith("n=%d)" % n_cards):
        raise PhaseFailed("expected %r... n=%d, got %r" % (want, n_cards,
                                                         line))
    if "overflow" in stderr:
        raise PhaseFailed("device bucket overflow fallback fired")
    return line


def timing_table(stderr: str):
    out, on = [], False
    for ln in stderr.splitlines():
        if ln.startswith("== grom_tpu timing =="):
            on = True
        if on:
            out.append(ln)
    return out


def cli(args):
    return [sys.executable, "-m", "grom_tpu"] + list(args)


# ---------------------------------------------------------------- phases

def phase_probe(env):
    code = ("import json, jax; d = jax.devices(); print(json.dumps(dict("
            "backend=jax.default_backend(), platform=d[0].platform, "
            "kind=d[0].device_kind, count=len(d))))")
    r, wall = run_child("probe", [sys.executable, "-c", code], env,
                        timeout=300)
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    log("phase probe: %s (%.1fs)" % (json.dumps(dev), wall))
    return dev


def phase_build(env):
    code = ("from grom_tpu.native import get_lib; import grom_tpu; "
            "assert get_lib() is not None, 'native library did not build'; "
            "import importlib.util as u; "
            "print('hugealloc', bool(u.find_spec('grom_tpu._hugealloc')))")
    r, wall = run_child("build", [sys.executable, "-c", code], env,
                        timeout=600)
    log("phase build: ok (%.1fs) native/_grom_native.so; %s"
        % (wall, r.stdout.strip()))


def phase_kernels(env):
    r, wall = run_child(
        "kernels", [sys.executable, "-m", "pytest", "tests/test_chip.py",
                    "-m", "chip", "-q", "-s", "-p", "no:cacheprovider",
                    "-p", "no:randomly", "-rs"],
        dict(env, JAX_PLATFORMS="cuda"), timeout=1200)
    for ln in r.stdout.splitlines():
        if "KERNEL " in ln:
            log("  " + ln[ln.index("KERNEL "):])
    tail = r.stdout.strip().splitlines()[-1]
    if "skipped" in tail or "passed" not in tail:
        raise PhaseFailed("kernel tests did not all run: " + tail)
    log("phase K kernels: ok (%.1fs) %s" % (wall, tail.strip("= ")))


def _fixture_inputs(name: str, env) -> str:
    """A scratch copy of a fixture's inputs (the CLI writes index and
    insert-size caches next to them)."""
    d = os.path.join(WORK, "fixtures", name)
    os.makedirs(d, exist_ok=True)
    if name == "cnvmany":
        if not os.path.exists(os.path.join(d, "ds.bam.bai")):
            code = ("from grom_tpu.testing import cnvmany; "
                    "cnvmany.build(%r)" % os.path.join(d, "ds"))
            run_child("A cnvmany data", [sys.executable, "-c", code], env,
                      timeout=600)
        return d
    for f in os.listdir(os.path.join(DATA, name)):
        if f.startswith("ds."):
            shutil.copy(os.path.join(DATA, name, f), os.path.join(d, f))
    return d


def phase_fixtures(env):
    for name, flags, with_ctx in FIXTURES:
        d = _fixture_inputs(name, env)
        out = os.path.join(WORK, "run", "A_%s.vcf" % name)
        r, wall = run_child(
            "A %s" % name,
            cli(["-i", os.path.join(d, "ds.bam"), "-r",
                 os.path.join(d, "ds.fa"), "-o", out] + flags),
            dict(env, GROM_TPU_ENGINE="device"))
        expect_engine(r.stderr, "device")
        rows, near = compare_vcf(out, os.path.join(DATA, name, "oracle.vcf"))
        msg = "%d rows, %d CNV rows within SD/Z tolerance" % (rows, near)
        if with_ctx:
            crows, _ = compare_vcf(out[:-4] + ".ctx.vcf",
                                   os.path.join(DATA, name, "oracle.ctx.vcf"))
            msg += ", ctx %d rows" % crows
        log("phase A %s: ok (%.1fs) == oracle: %s" % (name, wall, msg))


def bulk_params(length: int) -> dict:
    """Phase B's planted events, laid out for 48 Mb and scaled with a
    shorter --length so every event class stays."""
    def at(pos):
        return pos * length // DEFAULT_LENGTH
    return dict(
        coverage=COVERAGE, seed=SEED, snp_rate=1e-3,
        gc_blocks=[(at(s), at(e), f) for s, e, f in (
            (4_800_000, 5_200_000, 0.35), (20_000_000, 20_400_000, 0.62),
            (36_000_000, 36_300_000, 0.42))],
        depressions=[(at(s), at(e), f) for s, e, f in (
            (8_000_000, 8_040_000, 0.4), (16_000_000, 16_060_000, 0.5),
            (30_000_000, 30_030_000, 0.3), (44_000_000, 44_050_000, 0.45))],
        hotspots=[(at(s), at(e), f) for s, e, f in (
            (24_000_000, 24_050_000, 2.0), (40_000_000, 40_040_000, 1.8))],
        repeats=[(at(s), at(e), r) for s, e, r in (
            (12_000_000, 12_020_000, b"AC"), (33_000_000, 33_010_000, b"AT"))])


def phase_data(length: int, env):
    """Generate (or reuse) Phase B's chromosome under .smoke_data/, keyed
    by its parameters."""
    key = "bulk_L%d_c%d_s%d_v%d" % (length, int(COVERAGE), SEED,
                                     DATA_VERSION)
    d = os.path.join(WORK, key)
    prefix = os.path.join(d, "ds")
    if os.path.exists(os.path.join(d, "done")):
        log("phase B data: reused %s" % d)
        return prefix + ".fa", prefix + ".bam"
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    code = ("from grom_tpu.testing.bulk_sim import bulk_dataset; "
            "bulk_dataset(%r, %d, **%r)" % (prefix, length,
                                             bulk_params(length)))
    _, wall = run_child("B data", [sys.executable, "-c", code],
                        env, timeout=1200)
    open(os.path.join(d, "done"), "w").close()
    log("phase B data: generated %d bp at %.0fx in %.1fs"
        % (length, COVERAGE, wall))
    return prefix + ".fa", prefix + ".bam"


def _rows_of(path: str):
    body = [ln for ln in vcf_body(path) if not ln.startswith("#")]
    fmt = [ln.split("\t")[8] for ln in body]
    n_cnv = sum(1 for f in fmt if f.startswith("SD:Z:CN"))
    n_snv = sum(1 for f in fmt if f.startswith("GT:PR:AF:A:C:G:T:"))
    return len(body), n_snv, n_cnv


def phase_bulk(fa: str, bam: str, env):
    run_dir = os.path.join(WORK, "run")
    dev_out = os.path.join(run_dir, "B_device.vcf")
    host_out = os.path.join(run_dir, "B_host.vcf")
    r, wall_dev = run_child(
        "B device", cli(["-i", bam, "-r", fa, "-o", dev_out]),
        dict(env, GROM_TPU_TIMING="1"))
    line = expect_engine(r.stderr, "device")
    log("phase B device: ok (%.1fs) auto engine -> %s" % (wall_dev, line))
    for ln in timing_table(r.stderr):
        log("  device | " + ln)
    r, wall_host = run_child(
        "B host", cli(["-i", bam, "-r", fa, "-o", host_out]),
        dict(env, GROM_TPU_ENGINE="host", GROM_TPU_TIMING="1"))
    if engine_line(r.stderr) != "engine: host":
        raise PhaseFailed("host run: " + engine_line(r.stderr))
    log("phase B host: ok (%.1fs)" % wall_host)
    for ln in timing_table(r.stderr):
        log("  host   | " + ln)
    rows, near = compare_vcf(dev_out, host_out)
    ctx_rows, _ = compare_vcf(dev_out[:-4] + ".ctx.vcf",
                              host_out[:-4] + ".ctx.vcf")
    n, n_snv, n_cnv = _rows_of(dev_out)
    if n_snv < 1 or n_cnv < 1:
        raise PhaseFailed("Phase B emitted %d SNV and %d CNV rows"
                          % (n_snv, n_cnv))
    log("phase B compare: ok device == host: %d rows (%d SNV, %d CNV, %d "
        "CNV within SD/Z tolerance), ctx %d rows; wall device %.1fs, host "
        "%.1fs" % (rows, n_snv, n_cnv, near, ctx_rows, wall_dev, wall_host))
    return dev_out


def phase_parallel(fa: str, bam: str, serial_out: str, env):
    out = os.path.join(WORK, "run", "C_P2.vcf")
    r, wall = run_child(
        "C P2", cli(["-i", bam, "-r", fa, "-o", out, "-P", "2"]), env)
    slots = [ln for ln in r.stderr.splitlines()
             if ln.startswith("worker slot")]
    engines = [ln for ln in r.stderr.splitlines()
               if ln.startswith("engine: ")]
    held = [ln for ln in slots if ": card " in ln]
    if len(held) != 1 or len(slots) != 2:
        raise PhaseFailed("expected one of two slots on the card: %s"
                          % slots)
    # the one chromosome job must have run on the card's worker
    if (len(engines) != 1
            or not engines[0].startswith("engine: device (gpu, ")
            or not engines[0].endswith("n=1)")):
        raise PhaseFailed("expected the chromosome on the device engine: %s"
                          % engines)
    if "overflow" in r.stderr:
        raise PhaseFailed("device bucket overflow fallback fired")
    rows, near = compare_vcf(out, serial_out)
    log("phase C -P 2: ok (%.1fs) == serial device run (%d rows); %s; "
        "chromosome ran on: %s" % (wall, rows, "; ".join(slots),
                                   "; ".join(engines)))


_MESH_PLACEMENT = r"""
import json, sys, time
import numpy as np
import jax
from grom_tpu.call import scan as scan_mod
from grom_tpu.parallel import pipeline
from grom_tpu.testing.fixtures import chrom_inputs
rec = []
orig = pipeline.build_mesh_step
def build(*a, **k):
    step = orig(*a, **k)
    def timed(*args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*args))
        rec.append(dict(step_s=time.perf_counter() - t0,
                        shard_devices=sorted({str(s.device) for s in
                                              out[0].addressable_shards}),
                        sharding_devices=len(out[0].sharding.device_set)))
        return out
    return timed
pipeline.build_mesh_step = build
ci = chrom_inputs(sys.argv[1])
arr = scan_mod.accumulate_chromosome(ci.chrom, ci.batch, ci.cfg, ci.drv,
                                     ci.scan_start)
acc = pipeline.MeshAccumulator()
for _ in range(3):
    res = acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
base_tot, dev, rd, _ = res
assert np.array_equal(base_tot, arr.snv.sum(0) + arr.snv_lowmq.sum(0))
for a, b in zip(rd, (arr.rd_mq, arr.rd_hi, arr.rd_lo)):
    assert np.array_equal(a, b)
print(json.dumps(dict(mesh=[acc.n_dp, acc.n_sp], steps=rec)))
"""


def phase_mesh_placement(env, n_cards: int):
    r, wall = run_child(
        "four placement", [sys.executable, "-c", _MESH_PLACEMENT,
                           os.path.join(DATA, "ds200k")], env)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    last = res["steps"][-1]
    if len(last["shard_devices"]) != n_cards:
        raise PhaseFailed("mesh step results on %s, not %d cards"
                          % (last["shard_devices"], n_cards))
    warm = [s["step_s"] for s in res["steps"][len(res["steps"]) // 3:]]
    log("phase four placement: ok (%.1fs) mesh (dp, sp)=%s; step results "
        "sharded over %s; == host engine on ds200k; warm step %.4fs "
        "(min of %d), first step %.3fs" % (
            wall, tuple(res["mesh"]), last["shard_devices"], min(warm),
            len(warm), res["steps"][0]["step_s"]))


def phase_four(fa: str, bam: str, env, n_cards: int):
    run_dir = os.path.join(WORK, "run")
    mesh_out = os.path.join(run_dir, "four_mesh.vcf")
    host_out = os.path.join(run_dir, "four_host.vcf")
    r, wall_mesh = run_child(
        "four mesh", cli(["-i", bam, "-r", fa, "-o", mesh_out]),
        dict(env, GROM_TPU_ENGINE="mesh", GROM_TPU_TIMING="1"))
    line = expect_engine(r.stderr, "mesh", n_cards)
    log("phase four mesh: ok (%.1fs) %s" % (wall_mesh, line))
    for ln in timing_table(r.stderr):
        log("  mesh | " + ln)
    _, wall_host = run_child(
        "four host", cli(["-i", bam, "-r", fa, "-o", host_out]),
        dict(env, GROM_TPU_ENGINE="host"))
    rows, near = compare_vcf(mesh_out, host_out)
    ctx_rows, _ = compare_vcf(mesh_out[:-4] + ".ctx.vcf",
                              host_out[:-4] + ".ctx.vcf")
    log("phase four compare: ok mesh == host: %d rows (%d CNV within SD/Z "
        "tolerance), ctx %d rows; wall mesh %.1fs, host %.1fs"
        % (rows, near, ctx_rows, wall_mesh, wall_host))
    phase_mesh_placement(env, n_cards)


def card_lines():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise OSError(r.stderr.strip())
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--length", type=int, default=DEFAULT_LENGTH,
                    help="Phase B chromosome length (default 48 Mb)")
    ap.add_argument("--four", action="store_true",
                    help="only the mesh engine over four cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "grom_tpu")):
        print("chip_smoke: no grom_tpu checkout next to this script",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four else 1
    try:
        cards = card_lines()
    except (OSError, subprocess.SubprocessError) as exc:
        print("chip_smoke: no GPU (nvidia-smi: %s)" % exc, file=sys.stderr)
        return 2
    if len(cards) < n_cards:
        print("chip_smoke: %d card(s), need %d" % (len(cards), n_cards),
              file=sys.stderr)
        return 2
    env = child_env()
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i)
                                               for i in range(n_cards))
    shutil.rmtree(os.path.join(WORK, "run"), ignore_errors=True)
    shutil.rmtree(os.path.join(WORK, "logs"), ignore_errors=True)
    os.makedirs(os.path.join(WORK, "run"))
    for ln in cards[:n_cards]:
        log("card: %s" % ln)
    try:
        dev = phase_probe(env)
    except PhaseFailed as exc:
        print("chip_smoke: device probe failed: %s" % exc, file=sys.stderr)
        return 2
    if dev["platform"] != "gpu" or dev["count"] != n_cards:
        print("chip_smoke: JAX found %s, need %d GPU card(s)"
              % (json.dumps(dev), n_cards), file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    ok = True
    try:
        phase_build(env)
        if args.four:
            fa, bam = phase_data(args.length, env)
            phase_four(fa, bam, env, n_cards)
        else:
            phase_kernels(env)
            phase_fixtures(env)
            fa, bam = phase_data(args.length, env)
            serial = phase_bulk(fa, bam, env)
            phase_parallel(fa, bam, serial, env)
    except (PhaseFailed, subprocess.TimeoutExpired) as exc:
        ok = False
        log("FAILED: %s" % exc)
    log("total %.1fs" % (time.perf_counter() - t0))
    for ln in cards[:n_cards]:
        log("card: %s" % ln)
    print(json.dumps({"ok": ok, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

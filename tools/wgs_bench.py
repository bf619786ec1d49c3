#!/usr/bin/env python
"""Whole-genome -P benchmark: ours vs the reference binary on one
multi-chromosome simulated genome (north-star #3's shape, BASELINE.md).

Generates an N-chromosome genome with testing/bulk_sim.bulk_genome, then
runs `python -m grom_tpu -P K` and `GROM -P K` on the same input,
recording wall + peak RSS for both sides into a JSON artifact.

Usage:
    python tools/wgs_bench.py [--gb 1.0] [--procs 2] [--cov 30]
                              [--dir /tmp/grom_wgs] [--skip-ref]

--gb 2.5 gives a 24-chromosome genome; the default 1.0Gb (10
chromosomes) keeps one run to tens of minutes on a small host. The
worker count defaults to the host's cores (the reference runs 2 threads
per chromosome process; README.md:86)."""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# human-like length fractions, scaled to --gb
CHROM_FRACS = [240, 200, 180, 160, 150, 140, 130, 120, 100, 80,
               70, 60, 55, 50, 48, 45, 42, 40, 38, 35, 32, 28, 26, 24]


_WRAPPER = """\
import json, resource, subprocess, sys, time
t0 = time.time()
with open(sys.argv[1], "w") as lf:
    rc = subprocess.run(sys.argv[2:], stdout=lf,
                        stderr=subprocess.STDOUT).returncode
ru = resource.getrusage(resource.RUSAGE_CHILDREN)
print(json.dumps(dict(wall_s=round(time.time() - t0, 1),
                      peak_rss_gb=round(ru.ru_maxrss / 1048576, 2),
                      cpu_s=round(ru.ru_utime + ru.ru_stime, 1), rc=rc)))
"""


def _measure(cmd, env, log_path):
    # a FRESH wrapper process isolates ru_maxrss per measured run:
    # RUSAGE_CHILDREN is a high-water over every child a process ever
    # waited, so measuring two runs from one parent masks the second
    # side's peak behind the first's
    r = subprocess.run([sys.executable, "-c", _WRAPPER, log_path, *cmd],
                       env=env, capture_output=True, text=True)
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return dict(wall_s=-1.0, peak_rss_gb=-1.0, cpu_s=-1.0, rc=-9,
                    error=r.stderr[-500:])


def _compare(ours_path, ref_path):
    """Per-chromosome row comparison of the two VCFs.

    The reference's -P mode SILENTLY DROPS the last chromosome of the
    FASTA: src/GROM.c never writes g_fasta_file_position[n_chr] (the
    one-past-the-end sentinel, GROM.c:1385 fills indices 0..n-1 of a
    zeroed global), so launch_one_chromosome(.., size = pos[i+1] - pos[i])
    gets a NEGATIVE size for the last chromosome (GROM.c:20999), its
    `while (size > 0)` launches no child, and add_one_chromosome_result
    returns on g_child_count==0 (GROM.c:608). We process every chromosome,
    so parity is scored on the chromosomes the reference emitted."""

    def by_chrom(path):
        d = {}
        with open(path, "rb") as f:
            for ln in f:
                if ln.startswith(b"#"):
                    continue
                d.setdefault(ln.split(b"\t", 1)[0], []).append(ln)
        return d

    ours, ref = by_chrom(ours_path), by_chrom(ref_path)
    common = [c for c in ours if c in ref]
    diff_lines = 0
    for c in common:
        a, b = ours[c], ref[c]
        if a != b:
            # multiset diff (Counter): exact under duplicate identical rows
            # and reordering; a changed row counts once (max of each side's
            # unmatched rows)
            from collections import Counter
            ca, cb = Counter(a), Counter(b)
            only_a = sum((ca - cb).values())
            only_b = sum((cb - ca).values())
            diff_lines += max(only_a, only_b)
    return {
        "ours_rows": sum(len(v) for v in ours.values()),
        "ref_rows": sum(len(v) for v in ref.values()),
        "common_chrom_rows_equal": all(ours[c] == ref[c] for c in common),
        "diff_rows_common_chroms": diff_lines,
        "chroms_only_ours": sorted(c.decode() for c in ours if c not in ref),
        "chroms_only_ref": sorted(c.decode() for c in ref if c not in ours),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--cov", type=float, default=30.0)
    ap.add_argument("--procs", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--dir", default="/tmp/grom_wgs")
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--skip-ours", action="store_true",
                    help="re-measure only the reference side (ours.vcf must "
                         "exist from a prior run for the parity section)")
    ap.add_argument("--skip-gen", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    total_mb = args.gb * 1000
    lens = []
    for frac in CHROM_FRACS:
        if sum(lens) + frac > total_mb:
            break
        lens.append(frac)
    specs = [dict(name="chr%d" % (i + 1), length=int(mb * 1_000_000),
                  coverage=args.cov, seed=100 + i,
                  snp_rate=1e-3,
                  hotspots=[(mb * 300_000, mb * 300_000 + 40_000, 3.0)],
                  depressions=[(mb * 600_000, mb * 600_000 + 60_000, 0.4)])
             for i, mb in enumerate(lens)]
    prefix = os.path.join(args.dir, "wgs")
    fa, bam = prefix + ".fa", prefix + ".bam"
    result = {"genome_gb": round(sum(lens) / 1000, 3),
              "n_chromosomes": len(lens), "coverage": args.cov,
              "procs": args.procs, "host_cpus": os.cpu_count()}

    if not args.skip_gen or not os.path.exists(bam):
        from grom_tpu.testing.bulk_sim import bulk_genome
        t0 = time.time()
        bulk_genome(prefix, specs)
        result["gen_s"] = round(time.time() - t0, 1)
        print("generated %.2fGb genome in %.0fs"
              % (result["genome_gb"], result["gen_s"]), flush=True)
        try:
            # the generator's freed buffers otherwise sit retained in this
            # process's slab pool (>20GB observed) for the whole benchmark
            from grom_tpu import _hugealloc
            _hugealloc.trim()
        except Exception:
            pass

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    if not args.skip_ours:
        result["ours"] = _measure(
            [sys.executable, "-m", "grom_tpu", "-i", bam, "-r", fa,
             "-o", os.path.join(args.dir, "ours.vcf"),
             "-P", str(args.procs)],
            env, os.path.join(args.dir, "ours.log"))
        print("ours:", json.dumps(result["ours"]), flush=True)

    if not args.skip_ref:
        from grom_tpu.testing.oracle import _binary, oracle_available
        if oracle_available():
            result["reference"] = _measure(
                [_binary(), "-i", bam, "-r", fa,
                 "-o", os.path.join(args.dir, "ref.vcf"),
                 "-P", str(args.procs)],
                dict(os.environ), os.path.join(args.dir, "ref.log"))
            print("reference:", json.dumps(result["reference"]), flush=True)
            ref_ok = result["reference"]["rc"] == 0
            if "ours" in result and result["ours"]["rc"] == 0 and ref_ok:
                result["speedup_vs_reference"] = round(
                    result["reference"]["wall_s"]
                    / result["ours"]["wall_s"], 3)
            if ref_ok and os.path.exists(os.path.join(args.dir, "ours.vcf")):
                result["parity"] = _compare(
                    os.path.join(args.dir, "ours.vcf"),
                    os.path.join(args.dir, "ref.vcf"))

    out = os.path.join(args.dir, "wgs_bench.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""Command-line interface mirroring the reference binary's flag surface
(src/GROM.c:21908-22099, README.md:93-253), including the undocumented flags
(-l/-F/-N/-R/-G/-f/-c). Invoke as ``python -m grom_tpu`` or via the
``grom-tpu`` console script.
"""

from __future__ import annotations

import getopt
import multiprocessing
import os
import sys
from typing import List, Optional

from grom_tpu.config import FLAG_MAP, TOGGLE_MAP, GromConfig

# -Q (CNV mapq) is accepted but a no-op like the reference: g_rd_min_mapq is
# unconditionally overwritten by g_min_mapq after getopt (src/GROM.c:21965-21967,
# :22101-22102)
_GETOPT = "i:r:o:g:p:b:q:Q:v:e:V:d:j:u:w:y:z:a:n:x:k:m:s:A:D:E:K:L:U:W:X:Y:Z:N:B:G:l:F:R:P:c:MSfh"

HELP = """GROM-TPU — integrated germline variant caller (SNV/indel/SV/CNV)

Usage: grom-tpu -i <bam> -r <fasta> -o <out.vcf> [options]

Required:
  -i FILE   coordinate-sorted, indexed BAM
  -r FILE   reference FASTA
  -o FILE   output VCF (translocations go to <out>.ctx.vcf)

Common options (defaults mirror the reference, code over README):
  -M        enable duplicate-read filtering            [off]
  -S        disable split-read analysis                [on]
  -g INT    gender: 0 female, 1 male                   [0]
  -p INT    ploidy                                     [2]
  -P INT    process chromosomes in parallel with N workers
  -b INT    min base quality                           [20]
  -q INT    min mapping quality                        [20]
  -v FLOAT  probability threshold (SNV/indel/SV)       [0.001]
  -e FLOAT  probability threshold for insertions       [1e-10]
  -V FLOAT  probability threshold for CNVs             [1e-9]
  -d INT    min reads supporting a breakpoint          [3]
  -a/-n/-x  SNV ratio / min reads / min avg bq         [0.2 / 3 / 15]
  -j/-u     SV ratio / max weak-evidence ratio         [0.05 / 0.25]
  -k/-m     max homopolymer / min indel ratio          [10 / 0.125]
  -w/-y/-z  ins-range / split loss / min split length  [10 / 20 / 30]
  -s FLOAT  SDs for insert-size concordance            [3]
  CNV: -A sampling  -D/-E repeat len/SD  -K ranks  -L dup-cov
       -U excessive-cov  -W/-X window min/max  -Y blocks  -Z block size
  Internal/undocumented (kept for parity): -B max chr len, -G list size,
       -l overlap mult, -F mapq factor, -N 1000genomes window,
       -R sub-region Mb, -c chr,sub,start,end, -f tabular output
"""


def parse_args(argv: List[str]) -> Optional[GromConfig]:
    try:
        opts, _ = getopt.getopt(argv, _GETOPT)
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return None
    cfg = GromConfig()
    kw = {}
    for flag, val in opts:
        f = flag.lstrip("-")
        if f == "h":
            print(HELP)
            return None
        if f in TOGGLE_MAP:
            field, value = TOGGLE_MAP[f]
            kw[field] = value
        elif f in FLAG_MAP:
            field, typ = FLAG_MAP[f]
            kw[field] = typ(val)
    cfg = cfg.replace(**kw)
    if not cfg.bam:
        print("ERROR: No bam file specified.", file=sys.stderr)
        return None
    if not cfg.ref_fasta:
        print("ERROR: No reference file specified.", file=sys.stderr)
        return None
    if not cfg.out_vcf:
        print("ERROR: No output file specified.", file=sys.stderr)
        return None
    return cfg


def split_regions(ref_len: int, cfg) -> List:
    """Sub-region splits for one chromosome, mirroring the reference's
    launch loop (src/GROM.c:557-566): regions of -R Mb with a 10kb overlap
    on each region's end; the last region absorbs up to 1.25x a region."""
    S = cfg.sub_region_mb * 1_000_000
    if S <= 0:
        return [(0, 0, ref_len)]
    out = []
    size = ref_len
    sub = 0
    while size > 0:
        start = sub * S
        if size > S // 4 * 5:
            end = (sub + 1) * S + cfg.sub_region_overlap
            size -= S
        else:
            end = start + size
            size = 0
        out.append((sub, start, end))
        sub += 1
    return out


def _run_one_chromosome(args):
    """Worker: call one chromosome (or one sub-region of it). Rows stream to
    an on-disk part file (the reference's per-child ``out.vcf.<chr>-<n>``
    files, src/GROM.c:20678-20693) so the parent never buffers a
    chromosome's records in memory; ctx candidate records (sparse) come back
    directly for the global merge. Returns ((refid, sub), part_path, n_rows,
    ctx_records)."""
    global _CLAIMED
    cfg_json, refid, sub, rstart, rend, part_path = args
    if _CLAIMED is not None:
        with _CLAIMED.get_lock():
            _CLAIMED.value += 1
        _CLAIMED = None
    import numpy as np

    from grom_tpu.config import DerivedConfig, GromConfig
    from grom_tpu.driver import (call_chromosome, call_chromosome_streamed,
                                 resolve_engine, start_engine)
    from grom_tpu.ingest import bam as bam_mod
    from grom_tpu.ingest import fasta as fasta_mod
    from grom_tpu.ingest.insert_size import load_or_estimate
    from grom_tpu.stats import binom

    cfg = GromConfig.from_json(cfg_json)
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    key = (refid, sub)
    ins = load_or_estimate(cfg.bam, None, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    header = bam_mod.read_bam_header(cfg.bam)
    bam_name = header.ref_names[refid]
    fa_name = fasta_mod.match_chromosome(bam_name, info.names)
    if fa_name is None:
        return key, None, 0, []
    out_name = fa_name.lower()
    if fasta_mod.is_chry(fa_name) and cfg.gender == 0:
        return key, None, 0, []
    mq_table = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                                    cfg.max_trials)
    hez_table = binom.build_hez_table(cfg.max_trials)
    chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
    engine = resolve_engine()
    start_engine(engine)
    res = None
    if rstart is None:
        # whole chromosome: bounded-memory chunked streaming, same engine
        # selection as the serial driver (this is the regime where the
        # reference's RAM multiplies by the worker count,
        # src/GROM.c:549-598 / README.md:12's 13GB -> 128GB)
        def fetch(t0, t1):
            return bam_mod.read_bam_region(cfg.bam, refid, t0, t1)[1]
        res = call_chromosome_streamed(chrom, refid, out_name, cfg, drv,
                                       mq_table, hez_table, fetch,
                                       engine=engine)
    if res is None:
        # sub-region job (-R split) or streamed-path rejection: regional
        # whole-batch fallback
        if rstart is None:
            _, reads = bam_mod.read_bam_region(cfg.bam, refid)
            sel = np.arange(len(reads))
            region_start = 0
        else:
            _, reads = bam_mod.read_bam_region(cfg.bam, refid,
                                               max(rstart, 0), rend)
            ends = bam_mod.alignment_ends(reads)
            sel = np.flatnonzero((reads.pos < rend - 1) & (ends > rstart))
            region_start = rstart
        res = call_chromosome(chrom, reads, sel, refid, out_name, cfg, drv,
                              mq_table, hez_table, region_start=region_start,
                              engine=engine)
    rows, ctx = res
    with open(part_path, "w") as f:
        for r in rows:
            f.write(r if r.endswith("\n") else r + "\n")
    return key, part_path, len(rows), ctx


def worker_env(slot: int, cards: List[str]) -> dict:
    """Environment for -P worker ``slot``: one process per card. Slots below
    the card count own one card each and resolve their engine as usual;
    every other slot runs the host engine and sees no card (a JAX process
    reserves most of a card's memory, so a second one on the same card
    fails)."""
    if slot < len(cards):
        return {"CUDA_VISIBLE_DEVICES": cards[slot]}
    return {"CUDA_VISIBLE_DEVICES": "", "GROM_TPU_ENGINE": "host"}


# set in a card slot's worker until its first job counts itself in ``claimed``
_CLAIMED = None


def _init_worker(counter, claimed, cards: List[str]) -> None:
    """Pool initializer: take a slot from the shared counter and set the
    slot's environment before this worker first imports JAX. A host slot
    takes no job until every card's worker holds one, so the cards get the
    first (largest) chromosomes."""
    global _CLAIMED
    with counter.get_lock():
        slot = counter.value
        counter.value += 1
    env = worker_env(slot, cards)
    os.environ.update(env)
    if "GROM_TPU_ENGINE" not in env:
        _CLAIMED = claimed
        print("worker slot %d: card %s" % (slot, env["CUDA_VISIBLE_DEVICES"]),
              file=sys.stderr, flush=True)
        return
    print("worker slot %d: host engine, no card (%d card(s) visible)"
          % (slot, len(cards)), file=sys.stderr, flush=True)
    import time
    while claimed.value < len(cards):
        time.sleep(0.05)


def run_parallel(cfg: GromConfig) -> None:
    """-P mode: chromosome-level parallelism via a process pool — the
    replacement of the reference's fork/execv scheduler (src/GROM.c:354-624),
    with one worker process per card (worker_env). Output order stays
    deterministic (BAM header order), unlike the reference's
    completion-order concatenation."""
    import numpy as np

    from grom_tpu.call.ctx import write_ctx_vcf
    from grom_tpu.config import DerivedConfig
    from grom_tpu.driver import _ctx_path, visible_cards
    from grom_tpu.ingest import bam as bam_mod
    from grom_tpu.ingest import fasta as fasta_mod
    from grom_tpu.ingest.insert_size import load_or_estimate
    from grom_tpu.vcfio.writer import VcfWriter

    header = bam_mod.read_bam_header(cfg.bam)
    if os.path.exists(cfg.bam + ".bai"):
        # bounded-memory insert estimation (stops at the 10M-record sample);
        # writes the cache the workers read
        from grom_tpu.driver import _streaming_insert_stats
        ins = _streaming_insert_stats(cfg, header)
    else:
        ins = load_or_estimate(cfg.bam, None, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    jobs = []
    # largest-chromosome-first scheduling for load balance
    # (src/GROM.c:22318-22336); output order stays header order via the sort
    # over results below
    order = sorted(range(header.n_ref),
                   key=lambda r: -int(header.ref_lengths[r]))
    for refid in order:
        regs = split_regions(header.ref_lengths[refid], cfg)
        if len(regs) <= 1:
            # single region == whole chromosome: identical to serial
            jobs.append((cfg.to_json(), refid, 0, None, None,
                         "%s.part.%d-0" % (cfg.out_vcf, refid)))
        else:
            for sub, start, end in regs:
                jobs.append((cfg.to_json(), refid, sub, start, end,
                             "%s.part.%d-%d" % (cfg.out_vcf, refid, sub)))
    pool_cap_set = False
    if "GROM_TPU_POOL_CAP" not in os.environ:
        # the allocator's default slab-pool cap (half of physical RAM,
        # grom_tpu/__init__.py) is sized for ONE pipeline; spawn workers
        # each install their own pool, so divide it by the worker count or
        # P workers retain P x half-RAM of warm slabs. No floor: the
        # aggregate across workers must stay <= half of physical RAM
        # (spawned workers inherit the env; restored in the parent below)
        try:
            half = (os.sysconf("SC_PHYS_PAGES")
                    * os.sysconf("SC_PAGE_SIZE")) // 2
            per = max(64 << 20, half // max(cfg.processes, 1))
            # ceiling: a streamed worker's live set is chunk-sized (~8GB
            # at the 16Mb default), so retention beyond that only inflates
            # RSS without avoiding any re-acquisition (measured: 2GiB cap
            # cost no wall on the 2x100Mb -P 2 experiment)
            per = min(per, 4 << 30)
            os.environ["GROM_TPU_POOL_CAP"] = str(per)
            pool_cap_set = True
        except (ValueError, OSError, AttributeError):
            pass
    ctx = multiprocessing.get_context("spawn")
    counter, claimed = ctx.Value("i", 0), ctx.Value("i", 0)
    try:
        # the pool terminates on exit, also a host slot still waiting for
        # the cards when there are fewer jobs than cards
        with ctx.Pool(cfg.processes, initializer=_init_worker,
                      initargs=(counter, claimed, visible_cards())) as pool:
            results = pool.map(_run_one_chromosome, jobs)
    finally:
        if pool_cap_set:
            del os.environ["GROM_TPU_POOL_CAP"]
    results.sort(key=lambda t: t[0])
    prelude = None
    if not cfg.vcf_output:
        from grom_tpu.vcfio.tabular import main_prelude
        prelude = main_prelude(drv.insert_mean, drv.insert_min,
                               drv.insert_max, drv.read_len)
    writer = VcfWriter(cfg.out_vcf, cfg.ref_fasta, prelude=prelude)
    all_ctx = []
    for _, part, _n, ctx in results:
        if part is not None:
            writer.append_file(part)
            os.remove(part)
        all_ctx.extend(ctx)
    writer.close()
    write_ctx_vcf(_ctx_path(cfg.out_vcf), all_ctx, header.ref_names, cfg, drv)


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if cfg is None:
        return 1
    try:
        if cfg.processes > 1:
            run_parallel(cfg)
        else:
            from grom_tpu.driver import run
            run(cfg)
    except FileNotFoundError as exc:
        # clean message instead of a traceback (the reference prints
        # "Error opening file %s", src/GROM.c:22116-22143)
        print("Error opening file %s" % (exc.filename or exc))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device accumulate + SNV screen for the REAL calling pipeline.

This is the jax/XLA re-expression of the per-base tally half of the
reference's scan loop (src/GROM.c:6605-6984 + the SNV screen
:11126-11199), producing bit-identical integer statistics to the host
engines (native/grom_scan.c and call/scan.py — differential-tested in
tests/test_device_accumulate.py):

  * the chromosome is processed in fixed-size POSITION TILES (2^18 bases);
    spans are split at tile edges on the host, so every tile compiles to the
    same executable (one compilation for the whole genome) and device memory
    stays bounded (~1.5 GB) regardless of chromosome length;
  * span expansion, per-base gathers, quality split — integer ops, exact on
    any backend;
  * exact read-name dedup — the slot semantics are re-expressed as stable
    int32 sorts over the (rare) high-quality-mismatch event subset:
    (pos, name) grouping -> first-occurrence detection -> per-position
    first-arrival ranking of short names; an event is skipped iff its name
    ranks < min_snv among short names at its position and the event is not
    the name's first occurrence.  Dedup state is position-local, so tiling
    is exact.  No hashing, no approximation;
  * per-base scatter-adds with ``indices_are_sorted=True`` after one
    stable sort by position;
  * the SNV candidate screen (alt mask, count and float32-ratio thresholds)
    runs on-device with a small downward ratio margin and returns a SPARSE
    SUPERSET candidate set; the host re-derives the exact reference float32
    decisions from the returned integer counts (call/snv.py:
    candidates_from_device), so backend division rounding can never change
    a call.

Per tile only O(candidates) stats plus one dense int32 array (base_tot, for
the indel detector) leave the chip.  The caf_rd_* depth lists keep their
whole-span boundary rule on the host (call/scan.py:_accumulate_rd_lists) —
tile-splitting would change that rule at tile edges.

The host keeps: p-value table lookups (f64), the mean-base-quality gate (f64,
applied per candidate), emission.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

NT = 4

TILE_L = 1 << 18      # positions per tile (position width of the kernel)
E_B = 1 << 24         # event bucket (aligned bases per tile, padded)
M_B = 1 << 21         # hi-mismatch event bucket
K_B = 1 << 14         # candidate bucket
S_B = 1 << 19         # span bucket
R_B = 1 << 19         # read bucket
Q_B = 1 << 25         # seq/qual byte bucket
MIN_SUBTILE = 1 << 12  # adaptive halving floor on bucket overflow


def tile_kernel_core(span_read, span_ref, span_readoff, cum0,
                     elig, mapq, flag, lseq, seq_off, seq, qual,
                     name_id, name_len, chrom_up, chrom_is_n, gate,
                     min_ratio_f32, n_span,
                     min_mapq: int, min_bq: int, min_snv: int,
                     name_len_cap: int,
                     e_cap: int = E_B, m_cap: int = M_B, k_cap: int = K_B):
    """The per-position-tile accumulate + SNV screen, trace-time sized by its
    inputs: tile width L = gate.shape[0]; the event / mismatch / candidate
    capacities are the static ``*_cap`` args. Reused by both the sequential
    DeviceAccumulator (big buckets) and the sharded mesh pipeline
    (parallel/pipeline.py, small per-cell buckets)."""
    import jax
    import jax.numpy as jnp

    i32 = jnp.int32
    L = gate.shape[0]
    E, M, K = e_cap, m_cap, k_cap

    # ---- span expansion (segment ids by scatter + cumsum) ---------------
    e = jnp.arange(E, dtype=i32)
    marks = jnp.zeros(E, i32).at[jnp.minimum(cum0[1:], E - 1)].add(
        jnp.where(jnp.arange(cum0.shape[0] - 1) < n_span, 1, 0))
    sid = jnp.minimum(jnp.cumsum(marks), n_span).astype(i32)
    within = e - jnp.take(cum0, sid, mode="clip")
    rid = jnp.take(span_read, sid, mode="clip")
    pos = jnp.take(span_ref, sid, mode="clip") + within
    ridx = jnp.take(span_readoff, sid, mode="clip") + within
    pad = sid >= n_span

    ok = (~pad) & (jnp.take(elig, rid, mode="clip") > 0) & \
        (pos >= 0) & (pos < L)
    posc = jnp.where(ok, pos, L)

    flat = jnp.where(ok, jnp.take(seq_off, rid, mode="clip") + ridx, 0)
    sb = jnp.take(seq, flat, mode="clip").astype(i32)
    lut = jnp.full(256, 4, jnp.int32)
    for _i, _ch in enumerate(b"ACGT"):
        lut = lut.at[_ch].set(_i).at[_ch | 0x20].set(_i)
    code = jnp.take(lut, sb)
    q = jnp.take(qual, flat, mode="clip").astype(i32)
    mq = jnp.take(mapq, rid, mode="clip").astype(i32)
    fwd = (jnp.take(flag, rid, mode="clip") & 16) == 0
    lsq = jnp.take(lseq, rid, mode="clip").astype(i32)
    nid = jnp.take(name_id, rid, mode="clip")
    nshort = jnp.take(name_len, rid, mode="clip").astype(i32) < name_len_cap

    hi_mq = mq >= min_mapq
    hi = ok & hi_mq & (q >= min_bq)
    # mismatch is BYTE-level: toupper(ref) != read base byte
    # (src/GROM.c:6846) — IUPAC codes must not collide
    rb = jnp.take(chrom_up, posc, mode="clip").astype(i32)
    mm = ok & (rb != sb)

    # ---- sort all events by position (stable; pads/trash last) ----------
    posc_s, perm = jax.lax.sort_key_val(posc, e, is_stable=True)
    g = lambda x: jnp.take(x, perm)
    ok_s, hi_s, mm_s = g(ok), g(hi), g(mm)
    code_s, q_s, mq_s = g(code), g(q), g(mq)
    fwd_s, lsq_s, ridx_s = g(fwd), g(lsq), g(ridx)
    nid_s, nshort_s = g(nid), g(nshort)

    # ---- exact read-name dedup on the hi&mismatch subset ----------------
    sel = hi_s & mm_s
    n_mm = sel.sum()
    src = jnp.nonzero(sel, size=M, fill_value=E - 1)[0].astype(i32)
    valid = jnp.arange(M, dtype=i32) < n_mm
    d_pos = jnp.where(valid, jnp.take(posc_s, src), L)
    d_nid = jnp.where(valid, jnp.take(nid_s, src), -1)
    d_short = valid & jnp.take(nshort_s, src)
    d_arr = jnp.arange(M, dtype=i32)

    # (pos, nid) lexicographic grouping via two stable int32 sorts
    _, p1 = jax.lax.sort_key_val(d_nid, d_arr, is_stable=True)
    k_pos1 = jnp.take(d_pos, p1)
    _, p2 = jax.lax.sort_key_val(k_pos1, jnp.arange(M, dtype=i32),
                                 is_stable=True)
    order1 = jnp.take(p1, p2)
    s_pos = jnp.take(d_pos, order1)
    s_nid = jnp.take(d_nid, order1)
    s_short = jnp.take(d_short, order1)

    jdx = jnp.arange(M, dtype=i32)
    first = (jdx == 0) | (s_pos != jnp.roll(s_pos, 1)) | \
        (s_nid != jnp.roll(s_nid, 1))
    gs = jax.lax.cummax(jnp.where(first, jdx, -1))
    grp_first_arr = jnp.take(order1, gs)

    # rank short groups per position by first arrival
    INF = jnp.int32(2147483647)
    k2 = jnp.where(first & s_short, grp_first_arr, INF)
    _, q1 = jax.lax.sort_key_val(k2, jdx, is_stable=True)
    k_pos2 = jnp.take(s_pos, q1)
    _, q2 = jax.lax.sort_key_val(k_pos2, jnp.arange(M, dtype=i32),
                                 is_stable=True)
    order2 = jnp.take(q1, q2)
    r_pos = jnp.take(s_pos, order2)
    r_rep = jnp.take(first & s_short, order2)
    kdx = jnp.arange(M, dtype=i32)
    seg_start = jax.lax.cummax(
        jnp.where((kdx == 0) | (r_pos != jnp.roll(r_pos, 1)), kdx, 0))
    rank = kdx - seg_start
    stored_rep = r_rep & (rank < min_snv)
    grp_stored = jnp.zeros(M, jnp.int32).at[
        jnp.take(gs, order2)].max(stored_rep.astype(jnp.int32))
    skip1 = (~first) & (jnp.take(grp_stored, gs) > 0)
    skip_sub = jnp.zeros(M, jnp.bool_).at[order1].set(skip1)
    skip_s = jnp.zeros(E, jnp.bool_).at[src].set(skip_sub & valid)

    # ---- per-base tallies (sorted scatters) -----------------------------
    counted = ok_s & hi_s & ~skip_s & (code_s < NT)
    low = ok_s & ~hi_s & (code_s < NT)

    def sadd(weights):
        return jnp.zeros(L + 1, jnp.int32).at[posc_s].add(
            weights.astype(jnp.int32), indices_are_sorted=True)[:L]

    snv, lowmq, fstr, pirs = [], [], [], []
    pir = jnp.where(mm_s | fwd_s, ridx_s, lsq_s - ridx_s)
    for c in range(NT):
        mc = counted & (code_s == c)
        snv.append(sadd(mc))
        lowmq.append(sadd(low & (code_s == c)))
        fstr.append(sadd(mc & fwd_s))
        pirs.append(sadd(jnp.where(mc, pir, 0)))
    snv = jnp.stack(snv)
    lowmq = jnp.stack(lowmq)
    fstrand = jnp.stack(fstr)
    pos_in_read = jnp.stack(pirs)

    bq = sadd(jnp.where(counted, q_s, 0))
    bq_all = bq + sadd(jnp.where(low, q_s, 0))
    mq_sum = sadd(jnp.where(counted, mq_s, 0))
    mq_all = mq_sum + sadd(jnp.where(low, mq_s, 0))
    n_hi = sadd(counted)
    rc_all = n_hi + sadd(low)

    total = snv.sum(axis=0)
    base_tot = total + lowmq.sum(axis=0)

    # ---- SUPERSET SNV screen (src/GROM.c:11126-11199) -------------------
    pidx = jnp.arange(L)
    ref_code_d = jnp.take(lut, jnp.take(chrom_up, pidx, mode="clip")
                          .astype(i32))
    not_n = ~jnp.take(chrom_is_n, pidx, mode="clip")
    is_alt = jnp.arange(NT, dtype=i32)[:, None] != ref_code_d[None, :]
    ratio = snv.astype(jnp.float32) / total.astype(jnp.float32)
    thr = min_ratio_f32 * jnp.float32(1.0 - 1e-3) - jnp.float32(1e-9)
    qual_m = (is_alt & (ratio >= thr) & (snv >= min_snv)
              & (gate > 0)[None, :] & not_n[None, :])
    any_q = qual_m.any(axis=0)
    n_cand = any_q.sum()
    w = jnp.nonzero(any_q, size=K, fill_value=L)[0]

    gat = lambda a: jnp.take(a, w, mode="clip")
    gat2 = lambda a: jnp.take(a, w, axis=1, mode="clip")
    cand = dict(
        pos=w,
        counts=gat2(snv), lowmq=gat2(lowmq),
        bq=gat(bq), bq_all=gat(bq_all), mq=gat(mq_sum), mq_all=gat(mq_all),
        bq_read_count=gat(n_hi), mq_read_count=gat(n_hi),
        read_count_all=gat(rc_all),
        pos_in_read=gat2(pos_in_read), fstrand=gat2(fstrand),
    )
    return base_tot, n_cand, n_mm, cand


_tile_kernel = functools.partial(
    __import__("jax").jit,
    static_argnames=("min_mapq", "min_bq", "min_snv", "name_len_cap",
                     "e_cap", "m_cap", "k_cap"))(tile_kernel_core)


def _pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(a) >= n:
        return np.ascontiguousarray(a[:n])
    out = np.full(n, fill, a.dtype)
    out[:len(a)] = a
    return out


class SpanIndex:
    """M-span table sorted by reference start with per-range clipping —
    the host-side tiling step shared by the sequential DeviceAccumulator and
    the sharded mesh pipeline (parallel/pipeline.py). Splitting spans at
    tile/cell edges keeps every per-base statistic position-local, so tiling
    (and sharding) is exact."""

    def __init__(self, batch):
        sref = batch.span_ref.astype(np.int64)
        slen = batch.span_len.astype(np.int64)
        sread = batch.span_read.astype(np.int64)
        soff = batch.span_readoff.astype(np.int64)
        if len(sref):
            order = np.argsort(sref, kind="stable")
            sref, slen, sread, soff = (sref[order], slen[order],
                                       sread[order], soff[order])
        self.sref, self.slen, self.sread, self.soff = sref, slen, sread, soff
        self.send = sref + slen
        self.max_len = int(slen.max()) if len(slen) else 0

    def slice_range(self, t0: int, t1: int):
        """Spans clipped to [t0, t1): (read_idx, cell-local ref start,
        read-base offset, length) — all spans wholly inside the range after
        clipping, in sorted-start order."""
        lo = int(np.searchsorted(self.sref, t0 - self.max_len, side="left"))
        hi = int(np.searchsorted(self.sref, t1, side="left"))
        m = self.send[lo:hi] > t0
        t_ref = self.sref[lo:hi][m]
        t_end = np.minimum(self.send[lo:hi][m], t1)
        t_read = self.sread[lo:hi][m]
        t_off = self.soff[lo:hi][m]
        delta = np.maximum(t0 - t_ref, 0)
        t_len = t_end - (t_ref + delta)
        keep = t_len > 0
        return (t_read[keep], (t_ref + delta - t0)[keep],
                (t_off + delta)[keep], t_len[keep])


_EMPTY = {"n": 0, "pos": np.empty(0, np.int64),
          "counts": np.empty((4, 0), np.int64),
          "lowmq": np.empty((4, 0), np.int64),
          "pos_in_read": np.empty((4, 0), np.int64),
          "fstrand": np.empty((4, 0), np.int64),
          "bq": np.empty(0, np.int64), "bq_all": np.empty(0, np.int64),
          "mq": np.empty(0, np.int64), "mq_all": np.empty(0, np.int64),
          "bq_read_count": np.empty(0, np.int64),
          "mq_read_count": np.empty(0, np.int64),
          "read_count_all": np.empty(0, np.int64)}


def read_names(reads):
    """(name_id, name_len) for the exact read-name dedup. The device engines
    need the native BAM decoder's interned names; a read-less batch gets
    empty arrays."""
    if reads.name_id is not None and reads.name_len is not None:
        return reads.name_id, reads.name_len
    if len(reads.pos) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.uint8)
    raise RuntimeError("the device engines need interned read names from "
                       "the native BAM decoder (build native/ with make)")


class DeviceAccumulator:
    """Host wrapper: splits one chromosome into fixed tiles, uploads each
    tile's span/read slices, runs the tile kernel, merges results. Returns
    None (the caller runs the host engine) only when a bucket still
    overflows at MIN_SUBTILE width."""

    def __init__(self):
        import jax
        self._jax = jax

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: np.ndarray = None, gate_base: int = 0,
            base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range (the
        streamed chunked mode — spans are clipped at the range edges exactly
        like tile edges); ``base_tot_out`` accumulates base_tot in place
        across chunked calls. ``gate``/``base_tot_out`` may be chunk-local
        arrays whose index 0 is ``gate_base``/``base_tot_base``."""
        import jax.numpy as jnp
        reads = batch.reads
        name_id, name_len = read_names(reads)
        L = len(chrom)
        hi = hi if hi > 0 else L

        sindex = SpanIndex(batch)

        up = np.where(chrom >= 97, chrom - 32, chrom).astype(np.uint8)
        is_n = (up == ord("N"))
        elig_u8 = np.append(eligible.astype(np.uint8), 0)
        gate_u8 = (gate > 0).astype(np.uint8)
        seq_off64 = reads.seq_off.astype(np.int64)

        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(L, np.int64))
        cand_parts = []

        def _cap(n, floor, ceil):
            # power-of-FOUR ladder above a high floor: adaptive enough to
            # kill transfer padding on dense data, coarse enough that a
            # machine sees only 1-2 distinct compiled shapes
            v = floor
            while v < n:
                v *= 4
            return min(v, ceil)

        # ONE bucket-shape set per run, sized by the maxima over all tiles:
        # per-tile shapes would trigger a compile per distinct combination;
        # chromosome-level caps give a single executable per chromosome
        # profile, reused across chromosomes and runs via the persistent
        # compile cache.
        run_caps = {}
        tile_stats = []
        for w0 in range(lo, hi, TILE_L):
            w1 = min(w0 + TILE_L, hi)
            t_read, _, _, t_len = sindex.slice_range(w0, w1)
            S = len(t_len)
            if S == 0:
                continue
            r0 = int(t_read.min())
            r1 = int(t_read.max()) + 1
            tile_stats.append((S, int(t_len.sum()), r1 - r0,
                               int(seq_off64[r1]) - int(seq_off64[r0])))
        if tile_stats:
            run_caps = dict(
                s_cap=_cap(max(t[0] for t in tile_stats) + 1, 1 << 16, S_B),
                e_cap=_cap(max(t[1] for t in tile_stats) + 1, 1 << 23, E_B),
                r_cap=_cap(max(t[2] for t in tile_stats) + 1, 1 << 16, R_B),
                q_cap=_cap(max(t[3] for t in tile_stats), 1 << 23, Q_B))

        def submit(t0, t1):
            """Dispatch one kernel call over [t0, t1) (width <= TILE_L) with
            ADAPTIVE pow2 bucket sizes — sized by the range's actual span /
            event / read / byte counts (floors bound the number of distinct
            compiled shapes). Returns (t0, t1, caps, out) to collect later —
            dispatch is async, so the next range's host prep and transfers
            overlap this range's device compute. Recursively halves the
            range when even the max buckets overflow; None only when an
            overflow persists at MIN_SUBTILE width."""
            t_read, t_ref2, t_off2, t_len = sindex.slice_range(t0, t1)
            S = len(t_len)
            if S == 0:
                return []
            total_ev = int(t_len.sum())
            over = S + 1 > S_B or total_ev + 1 > E_B
            r0 = r1 = q0 = q1 = 0
            if not over:
                r0 = int(t_read.min())
                r1 = int(t_read.max()) + 1
                q0 = int(seq_off64[r0])
                q1 = int(seq_off64[r1])
                over = (r1 - r0 > R_B) or (q1 - q0 > Q_B)
            if over:
                if t1 - t0 <= MIN_SUBTILE:
                    return None
                mid = (t0 + t1) // 2
                a = submit(t0, mid)
                b = submit(mid, t1)
                if a is None or b is None:
                    return None
                return a + b

            s_cap = max(run_caps.get("s_cap", 0), _cap(S + 1, 1 << 16, S_B))
            e_cap = max(run_caps.get("e_cap", 0),
                        _cap(total_ev + 1, 1 << 23, E_B))
            r_cap = max(run_caps.get("r_cap", 0),
                        _cap(r1 - r0 + 1, 1 << 16, R_B))
            q_cap = max(run_caps.get("q_cap", 0), _cap(q1 - q0, 1 << 23, Q_B))
            m_cap = max(e_cap // 8, 1 << 12)
            k_cap = K_B
            cum = np.zeros(s_cap + 1, np.int32)
            cum[1:S + 1] = np.cumsum(t_len)
            cum[S + 1:] = cum[S]

            out = _tile_kernel(
                jnp.asarray(_pad_to((t_read - r0).astype(np.int32), s_cap,
                                    r1 - r0)),
                jnp.asarray(_pad_to(t_ref2.astype(np.int32), s_cap, TILE_L)),
                jnp.asarray(_pad_to(t_off2.astype(np.int32), s_cap)),
                jnp.asarray(cum),
                jnp.asarray(_pad_to(elig_u8[r0:r1], r_cap + 1)),
                jnp.asarray(_pad_to(reads.mapq[r0:r1].astype(np.uint8),
                                    r_cap + 1)),
                jnp.asarray(_pad_to(reads.flag[r0:r1].astype(np.int32),
                                    r_cap + 1)),
                jnp.asarray(_pad_to(reads.lseq[r0:r1].astype(np.int32),
                                    r_cap + 1)),
                jnp.asarray(_pad_to((seq_off64[r0:r1] - q0).astype(np.int32),
                                    r_cap + 1)),
                jnp.asarray(_pad_to(reads.seq[q0:q1].astype(np.uint8), q_cap)),
                jnp.asarray(_pad_to(reads.qual[q0:q1].astype(np.uint8),
                                    q_cap)),
                jnp.asarray(_pad_to(name_id[r0:r1].astype(np.int32),
                                    r_cap + 1, -1)),
                jnp.asarray(_pad_to(name_len[r0:r1].astype(np.uint8),
                                    r_cap + 1)),
                jnp.asarray(_pad_to(np.append(up[t0:t1], np.uint8(0)),
                                    TILE_L + 1)),
                jnp.asarray(_pad_to(np.append(is_n[t0:t1], True),
                                    TILE_L + 1, True)),
                jnp.asarray(_pad_to(gate_u8[t0 - gate_base:t1 - gate_base],
                                    TILE_L)),
                jnp.float32(cfg.min_snv_ratio),
                jnp.int32(S),
                min_mapq=cfg.min_mapq, min_bq=cfg.min_base_qual,
                min_snv=cfg.min_snv, name_len_cap=50,
                e_cap=e_cap, m_cap=m_cap, k_cap=k_cap)
            return [(t0, t1, m_cap, k_cap, out)]

        def collect(entry):
            t0, t1, m_cap, k_cap, out = entry
            bt, n_cand, n_mm, cand = out
            n_cand = int(n_cand)
            if int(n_mm) > m_cap or n_cand > k_cap:
                # rare bucket overflow detected at collect: redo halved
                if t1 - t0 <= MIN_SUBTILE:
                    return False
                mid = (t0 + t1) // 2
                sub = submit(t0, mid)
                sub2 = submit(mid, t1)
                if sub is None or sub2 is None:
                    return False
                return all(collect(e) for e in sub + sub2)
            base_tot[t0 - base_tot_base:t1 - base_tot_base] = \
                np.asarray(bt)[:t1 - t0]
            if n_cand:
                part = {k: np.asarray(v) for k, v in cand.items()}
                part["pos"] = part["pos"][:n_cand].astype(np.int64) + t0
                ok_cand = part["pos"] < t1   # clip screen hits beyond range
                part["pos"] = part["pos"][ok_cand]
                for k in ("counts", "lowmq", "pos_in_read", "fstrand"):
                    part[k] = part[k][:, :n_cand][:, ok_cand]
                for k in ("bq", "bq_all", "mq", "mq_all", "bq_read_count",
                          "mq_read_count", "read_count_all"):
                    part[k] = part[k][:n_cand][ok_cand]
                if len(part["pos"]):
                    cand_parts.append(part)
            return True

        pending = []
        for w0 in range(lo, hi, TILE_L):
            sub = submit(w0, min(w0 + TILE_L, hi))
            if sub is None:
                return None
            pending.extend(sub)
        for entry in pending:
            if not collect(entry):
                return None

        if cand_parts:
            dev = {"n": int(sum(len(p["pos"]) for p in cand_parts))}
            dev["pos"] = np.concatenate([p["pos"] for p in cand_parts])
            for k in ("counts", "lowmq", "pos_in_read", "fstrand"):
                dev[k] = np.concatenate([p[k] for p in cand_parts], axis=1)
            for k in ("bq", "bq_all", "mq", "mq_all", "bq_read_count",
                      "mq_read_count", "read_count_all"):
                dev[k] = np.concatenate([p[k] for p in cand_parts])
        else:
            dev = dict(_EMPTY)
        return base_tot, dev


_ACC: Optional[DeviceAccumulator] = None


def get_accumulator() -> DeviceAccumulator:
    global _ACC
    if _ACC is None:
        _ACC = DeviceAccumulator()
    return _ACC

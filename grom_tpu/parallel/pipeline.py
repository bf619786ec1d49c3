"""Sharded execution of the REAL calling pipeline over a device mesh.

The genome coordinate is the sequence axis. A chromosome is cut into
fixed-width CELLS; each launch processes one cell per device over a 2-D
``(dp, sp)`` mesh — ``dp`` strides genome tiles, ``sp`` strides segments
within a tile. This is the device-mesh re-expression of the reference's
process parallelism: the fork/exec chromosome scheduler (src/GROM.c:354-624)
becomes data-parallel genome cells, the 10 kb sub-region halo
(src/GROM.c:75-78) becomes exact span splitting at cell edges plus a
cross-cell carry collective, and the ``cat``-file result merge
(src/GROM.c:603-624) becomes device→host gathers of sparse candidates.

Exactness: every per-base statistic of the sequential device engine
(ops/accumulate.py) is position-local once M-spans are split at cell edges
(SpanIndex.slice_range), so the mesh result is bit-identical to the
sequential device result, which is bit-identical to the host engines — the
full VCF is byte-identical regardless of mesh shape (tests/test_mesh_pipeline
+ __graft_entry__.dryrun_multichip assert this end-to-end).

Cross-shard communication:
  * caf_rd_* span depth (src/GROM.c:6605-6664): endpoint ±weight deltas are
    deposited in the cell that OWNS each endpoint position (spans are NOT
    split for these); the running depth at any position needs the total of
    every earlier cell's deltas — an ``all_gather`` of per-cell delta sums
    over both mesh axes + an exclusive prefix supplies the carry. Evidence
    that straddles a cell boundary (a span starting in one shard and ending
    in another) rides this collective.
  * a genome-wide high-mapq depth histogram reduces with ``psum`` over both
    axes (observability + a cross-check of the carry logic; the reference
    has no global view at all — children only merge files).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from grom_tpu.ops.accumulate import (_EMPTY, SpanIndex, _pad_to,
                                     read_names, tile_kernel_core)
from grom_tpu.parallel.mesh import make_mesh

HIST_BINS = 256


def _pow2(n: int, floor: int = 8) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def build_mesh_step(mesh, seg_l: int, caps: Tuple[int, ...],
                    min_mapq: int, min_bq: int, min_snv: int):
    """One jitted sharded step: [n_dp, n_sp] cells in, per-cell tallies +
    carried rd depth + psum'd global histogram out."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    S_B, E_B, M_B, K_B, R_B, Q_B, D_B = caps
    n_dp, n_sp = mesh.devices.shape
    i32 = jnp.int32

    def cell_fn(span_read, span_ref, span_readoff, cum0,
                elig, mapq, flag, lseq, seq_off, seq, qual,
                name_id, name_len, chrom_up, chrom_is_n, gate,
                n_span, min_ratio,
                d_pos, d_mq, d_hi, d_lo, n_d):
        base_tot, n_cand, n_mm, cand = tile_kernel_core(
            span_read, span_ref, span_readoff, cum0,
            elig, mapq, flag, lseq, seq_off, seq, qual,
            name_id, name_len, chrom_up, chrom_is_n, gate,
            min_ratio, n_span,
            min_mapq=min_mapq, min_bq=min_bq, min_snv=min_snv,
            name_len_cap=50, e_cap=E_B, m_cap=M_B, k_cap=K_B)
        # rd endpoint deltas → dense per-cell delta arrays (pads → seg_l row)
        valid = jnp.arange(D_B, dtype=i32) < n_d
        dp_ = jnp.where(valid, d_pos, seg_l)
        z = lambda w: jnp.zeros(seg_l + 1, i32).at[dp_].add(
            jnp.where(valid, w, 0), indices_are_sorted=True)[:seg_l]
        return (base_tot, n_cand, n_mm, cand,
                z(d_mq), z(d_hi.astype(i32)), z(d_lo.astype(i32)))

    def step(*args):
        stacked, carry_in = args[:24], args[24]
        # local block: [t_l, s_l, ...] (t_l = s_l = 1 on a full mesh)
        res = jax.vmap(jax.vmap(cell_fn))(*stacked[:23])
        base_tot, n_cand, n_mm, cand, dmq, dhi, dlo = res
        t_l, s_l = dmq.shape[0], dmq.shape[1]

        # ---- cross-cell carry: all_gather per-cell delta totals ----------
        tot = jnp.stack([dmq.sum(-1), dhi.sum(-1), dlo.sum(-1)])  # [3,t_l,s_l]
        g = jax.lax.all_gather(tot, "sp", axis=2, tiled=True)     # [3,t_l,S]
        g = jax.lax.all_gather(g, "dp", axis=1, tiled=True)       # [3,T,S]
        T, S = n_dp * t_l, n_sp * s_l
        flat = g.reshape(3, T * S)
        excl = jnp.cumsum(flat, axis=1) - flat                     # [3, T*S]
        excl = excl.reshape(3, T, S)
        # explicit int32 indices: under JAX_ENABLE_X64 a bare 0 is int64
        # and dynamic_slice rejects mixed index dtypes
        di = (jax.lax.axis_index("dp") * t_l).astype(i32)
        si = (jax.lax.axis_index("sp") * s_l).astype(i32)
        mine = jax.lax.dynamic_slice(excl, (i32(0), di, si), (3, t_l, s_l))
        base = mine + carry_in[:, None, None]   # + cross-launch carry
        rd_mq = base[0][..., None] + jnp.cumsum(dmq, axis=-1)
        rd_hi = base[1][..., None] + jnp.cumsum(dhi, axis=-1)
        rd_lo = base[2][..., None] + jnp.cumsum(dlo, axis=-1)

        # ---- psum'd genome-wide high-mq depth histogram ------------------
        npos = stacked[23]                      # [t_l, s_l] valid width
        pidx = jnp.arange(seg_l, dtype=i32)
        vmask = pidx[None, None, :] < npos[..., None]
        bins = jnp.where(vmask, jnp.clip(rd_hi, 0, HIST_BINS - 1), HIST_BINS)
        hist = jnp.zeros(HIST_BINS + 1, i32).at[bins.reshape(-1)].add(1)
        hist = hist[:HIST_BINS]
        hist = jax.lax.psum(jax.lax.psum(hist, "sp"), "dp")

        return base_tot, n_cand, n_mm, cand, rd_mq, rd_hi, rd_lo, hist

    cell = P("dp", "sp")
    in_specs = (cell,) * 24 + (P(),)
    out_specs = (cell, cell, cell,
                 {k: cell for k in ("pos", "counts", "lowmq", "bq", "bq_all",
                                    "mq", "mq_all", "bq_read_count",
                                    "mq_read_count", "read_count_all",
                                    "pos_in_read", "fstrand")},
                 cell, cell, cell, P())
    try:
        sm = shard_map(step, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    except TypeError:  # older jax spells it check_rep
        sm = shard_map(step, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_rep=False)
    return jax.jit(sm)


class MeshAccumulator:
    """Runs the real per-base accumulate + SNV screen of one chromosome
    sharded over a jax device mesh, plus the caf_rd_* depth lists with an
    all_gather'd cross-cell carry. Drop-in alternative to the sequential
    DeviceAccumulator: returns (base_tot, cand, (rd_mq, rd_hi, rd_lo), hist),
    or None when a bucket overflows (the caller runs the host engine)."""

    def __init__(self, mesh=None, seg_l: Optional[int] = None,
                 devices=None):
        import jax
        if mesh is None:
            devices = devices if devices is not None else jax.devices()
            n = len(devices)
            n_sp = 2 if n % 2 == 0 and n > 1 else 1
            mesh = make_mesh(n // n_sp, n_sp, devices=devices)
        self.mesh = mesh
        self.n_dp, self.n_sp = mesh.devices.shape
        self.n_cells_launch = self.n_dp * self.n_sp
        self.seg_l = seg_l
        self._steps: Dict[tuple, object] = {}
        # multi-host (DCN) mode: the mesh spans devices of several jax
        # processes; inputs are built shard-wise per process and outputs
        # are re-assembled with an allgather across hosts
        self.multihost = jax.process_count() > 1

    def _seg_l_for(self, L: int) -> int:
        if self.seg_l:
            return self.seg_l
        # aim for ~2 launches of work but keep cells big enough to
        # amortize a launch and small enough to bound per-device memory
        target = max(1 << 14, L // (2 * self.n_cells_launch) + 1)
        return min(_pow2(target), 1 << 18)

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: Optional[np.ndarray] = None,
            rd_out: Optional[Tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] = None,
            gate_base: int = 0, base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range — the
        streamed chunked mode (src/GROM.c:75-78's sub-region halo,
        re-expressed as exact span clipping at range edges). Because spans
        are clipped to [lo, hi), each call's delta set reconstructs the
        EXACT absolute depth over its range from zero — chunked calls need
        no cross-call carry (every read overlapping the range is in the
        chunk's batch; the within-call cross-launch carry still applies).
        ``base_tot_out``/``rd_out`` accumulate into caller arrays so a
        chromosome of any length streams through bounded chunk memory."""
        import jax.numpy as jnp
        reads = batch.reads
        names = read_names(reads)
        L = len(chrom)
        hi = hi if hi > 0 else L
        span = hi - lo
        seg_l = self._seg_l_for(span)
        n_cells = -(-span // seg_l)
        n_rounds = -(-n_cells // self.n_cells_launch)

        sindex = SpanIndex(batch)
        up = np.where(chrom >= 97, chrom - 32, chrom).astype(np.uint8)
        is_n = (up == ord("N"))
        elig_u8 = np.append(eligible.astype(np.uint8), 0)
        gate_u8 = (gate > 0).astype(np.uint8)
        seq_off64 = reads.seq_off.astype(np.int64)

        # ---- rd endpoint delta events, owner = cell containing the pos ----
        # spans are CLIPPED to [lo, hi) (mirroring scan._accumulate_rd_lists)
        # so chunked calls partition every span's contribution exactly
        sel = eligible[batch.span_read]
        ref = batch.span_ref[sel].astype(np.int64)
        ln = batch.span_len[sel].astype(np.int64)
        rid = batch.span_read[sel]
        oks = (ref >= 0) & (ref + ln < L)   # whole-span rule (scan.py)
        ref, ln, rid = ref[oks], ln[oks], rid[oks]
        s_cl = np.maximum(ref, lo)
        e_cl = np.minimum(ref + ln, hi)
        keep_cl = e_cl > s_cl
        s_cl, e_cl, rid = s_cl[keep_cl], e_cl[keep_cl], rid[keep_cl]
        mq_w = batch.mapq[rid].astype(np.int32)
        hi_w = (mq_w >= cfg.min_mapq).astype(np.int8)
        lo_w = (1 - hi_w).astype(np.int8)
        d_pos = np.concatenate([s_cl, e_cl])
        d_mq = np.concatenate([mq_w, -mq_w])
        d_hi = np.concatenate([hi_w, -hi_w])
        d_lo = np.concatenate([lo_w, -lo_w])
        order = np.argsort(d_pos, kind="stable")
        d_pos, d_mq, d_hi, d_lo = (d_pos[order], d_mq[order],
                                   d_hi[order], d_lo[order])

        # ---- per-cell prep + bucket sizing --------------------------------
        cells = []
        for c in range(n_cells):
            t0, t1 = lo + c * seg_l, min(lo + (c + 1) * seg_l, hi)
            t_read, t_ref2, t_off2, t_len = sindex.slice_range(t0, t1)
            S = len(t_len)
            if S:
                r0 = int(t_read.min())
                r1 = int(t_read.max()) + 1
                q0, q1 = int(seq_off64[r0]), int(seq_off64[r1])
            else:
                r0 = r1 = q0 = q1 = 0
            dlo_i = int(np.searchsorted(d_pos, t0, side="left"))
            dhi_i = int(np.searchsorted(d_pos, t1, side="left"))
            cells.append((t0, t1, t_read, t_ref2, t_off2, t_len,
                          r0, r1, q0, q1, dlo_i, dhi_i))

        S_B = _pow2(max((len(c[5]) for c in cells), default=1) + 1)
        E_B = _pow2(max((int(c[5].sum()) for c in cells), default=1) + 1)
        R_B = _pow2(max((c[7] - c[6] for c in cells), default=1) + 1)
        Q_B = _pow2(max((c[9] - c[8] for c in cells), default=1) + 1)
        D_B = _pow2(max((c[11] - c[10] for c in cells), default=1) + 1)
        M_B = min(E_B, _pow2(max(E_B // 8, 1 << 10)))
        K_B = min(_pow2(max(seg_l // 8, 1 << 10)), seg_l)
        caps = (S_B, E_B, M_B, K_B, R_B, Q_B, D_B)

        key = (seg_l, caps, cfg.min_mapq, cfg.min_base_qual, cfg.min_snv)
        step = self._steps.get(key)
        if step is None:
            step = build_mesh_step(self.mesh, seg_l, caps, cfg.min_mapq,
                                   cfg.min_base_qual, cfg.min_snv)
            self._steps[key] = step

        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(L, np.int64))
        if rd_out is not None:
            rd_mq, rd_hi, rd_lo = rd_out
        else:
            rd_mq = np.zeros(L, np.int32)
            rd_hi = np.zeros(L, np.int32)
            rd_lo = np.zeros(L, np.int32)
        hist = np.zeros(HIST_BINS, np.int64)
        cand_parts: List[dict] = []
        carry = np.zeros(3, np.int64)   # cross-launch rd carry

        for r in range(n_rounds):
            lo_c = r * self.n_cells_launch
            batch_cells = cells[lo_c:lo_c + self.n_cells_launch]
            stacked = self._stack_cells(batch_cells, seg_l, caps, cfg,
                                        reads, names, elig_u8, gate_u8, up,
                                        is_n,
                                        seq_off64, d_pos, d_mq, d_hi, d_lo,
                                        gate_base)
            reshaped = [a.reshape((self.n_dp, self.n_sp) + a.shape[1:])
                        for a in stacked]
            if not self.multihost:
                shaped = [jnp.asarray(a) for a in reshaped]
                carry_dev = jnp.asarray(carry, np.int32)
            else:
                # every process runs identical host prep; each materializes
                # only its addressable shards of the global arrays
                import jax
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P
                cell_sh = NamedSharding(self.mesh, P("dp", "sp"))
                rep_sh = NamedSharding(self.mesh, P())
                shaped = [jax.make_array_from_callback(
                    a.shape, cell_sh, lambda idx, a=a: a[idx])
                    for a in reshaped]
                carry32 = carry.astype(np.int32)
                carry_dev = jax.make_array_from_callback(
                    (3,), rep_sh, lambda idx: carry32[idx])
            out = step(*shaped, carry_dev)
            (bt, n_cand, n_mm, cand, r_mq, r_hi, r_lo, h) = out
            if self.multihost:
                from jax.experimental import multihost_utils as mh
                (bt, n_cand, n_mm, cand, r_mq, r_hi, r_lo) = \
                    mh.process_allgather(
                        (bt, n_cand, n_mm, cand, r_mq, r_hi, r_lo),
                        tiled=True)
                h = np.asarray(h.addressable_shards[0].data)
            n_cand = np.asarray(n_cand).reshape(-1)
            n_mm = np.asarray(n_mm).reshape(-1)
            if (n_mm > M_B).any() or (n_cand > K_B).any():
                return None
            bt = np.asarray(bt).reshape(-1, seg_l)
            r_mq = np.asarray(r_mq).reshape(-1, seg_l)
            r_hi = np.asarray(r_hi).reshape(-1, seg_l)
            r_lo = np.asarray(r_lo).reshape(-1, seg_l)
            cand = {k: np.asarray(v) for k, v in cand.items()}
            for k in ("pos", "bq", "bq_all", "mq", "mq_all", "bq_read_count",
                      "mq_read_count", "read_count_all"):
                cand[k] = cand[k].reshape(-1, cand[k].shape[-1])
            for k in ("counts", "lowmq", "pos_in_read", "fstrand"):
                v = cand[k]
                cand[k] = v.reshape(-1, v.shape[-2], v.shape[-1])
            for i, cell in enumerate(batch_cells):
                t0, t1 = cell[0], cell[1]
                w = t1 - t0
                base_tot[t0 - base_tot_base:t1 - base_tot_base] = bt[i, :w]
                # rd depth already includes the in-launch all_gather carry
                # plus the cross-launch carry_in added on device
                rd_mq[t0:t1] = r_mq[i, :w]
                rd_hi[t0:t1] = r_hi[i, :w]
                rd_lo[t0:t1] = r_lo[i, :w]
                nc = int(n_cand[i])
                if nc:
                    part = {"pos": cand["pos"][i, :nc].astype(np.int64) + t0}
                    keepc = part["pos"] < t1
                    part["pos"] = part["pos"][keepc]
                    for k in ("counts", "lowmq", "pos_in_read", "fstrand"):
                        part[k] = cand[k][i, :, :nc][:, keepc]
                    for k in ("bq", "bq_all", "mq", "mq_all", "bq_read_count",
                              "mq_read_count", "read_count_all"):
                        part[k] = cand[k][i, :nc][keepc]
                    if len(part["pos"]):
                        cand_parts.append(part)
            # next launch's carry = absolute depth at the end of this one
            # (the device values already fold all earlier launches in)
            last = batch_cells[-1]
            w_last = last[1] - last[0]
            i_last = len(batch_cells) - 1
            carry = np.array([r_mq[i_last, w_last - 1],
                              r_hi[i_last, w_last - 1],
                              r_lo[i_last, w_last - 1]], np.int64)
            hist += np.asarray(h, np.int64)

        dev = self._merge_cands(cand_parts)
        return base_tot, dev, (rd_mq, rd_hi, rd_lo), hist

    @staticmethod
    def _merge_cands(cand_parts: List[dict]) -> dict:
        if not cand_parts:
            return dict(_EMPTY)
        dev = {"n": int(sum(len(p["pos"]) for p in cand_parts))}
        dev["pos"] = np.concatenate([p["pos"] for p in cand_parts])
        for k in ("counts", "lowmq", "pos_in_read", "fstrand"):
            dev[k] = np.concatenate([p[k] for p in cand_parts], axis=1)
        for k in ("bq", "bq_all", "mq", "mq_all", "bq_read_count",
                  "mq_read_count", "read_count_all"):
            dev[k] = np.concatenate([p[k] for p in cand_parts])
        return dev

    def _stack_cells(self, batch_cells, seg_l, caps, cfg, reads, names,
                     elig_u8, gate_u8, up, is_n, seq_off64, d_pos, d_mq, d_hi,
                     d_lo, gate_base=0):
        S_B, E_B, M_B, K_B, R_B, Q_B, D_B = caps
        name_id, name_len = names
        n = self.n_cells_launch
        arrs = {name: [] for name in range(24)}

        def empty_cell():
            cum = np.zeros(S_B + 1, np.int32)
            return [np.full(S_B, 0, np.int32), np.full(S_B, seg_l, np.int32),
                    np.zeros(S_B, np.int32), cum,
                    np.zeros(R_B + 1, np.uint8), np.zeros(R_B + 1, np.uint8),
                    np.zeros(R_B + 1, np.int32), np.zeros(R_B + 1, np.int32),
                    np.zeros(R_B + 1, np.int32), np.zeros(Q_B, np.uint8),
                    np.zeros(Q_B, np.uint8),
                    np.full(R_B + 1, -1, np.int32), np.zeros(R_B + 1, np.uint8),
                    np.zeros(seg_l + 1, np.uint8),
                    np.ones(seg_l + 1, bool), np.zeros(seg_l, np.uint8),
                    np.int32(0), np.float32(cfg.min_snv_ratio),
                    np.zeros(D_B, np.int32), np.zeros(D_B, np.int32),
                    np.zeros(D_B, np.int8), np.zeros(D_B, np.int8),
                    np.int32(0), np.int32(0)]

        rows = []
        for cell in batch_cells:
            (t0, t1, t_read, t_ref2, t_off2, t_len,
             r0, r1, q0, q1, dlo_i, dhi_i) = cell
            S = len(t_len)
            cum = np.zeros(S_B + 1, np.int32)
            if S:
                cum[1:S + 1] = np.cumsum(t_len)
                cum[S + 1:] = cum[S]
            nd = dhi_i - dlo_i
            rows.append([
                _pad_to((t_read - r0).astype(np.int32), S_B,
                        max(r1 - r0, 0)),
                _pad_to(t_ref2.astype(np.int32), S_B, seg_l),
                _pad_to(t_off2.astype(np.int32), S_B),
                cum,
                _pad_to(elig_u8[r0:r1], R_B + 1),
                _pad_to(reads.mapq[r0:r1].astype(np.uint8), R_B + 1),
                _pad_to(reads.flag[r0:r1].astype(np.int32), R_B + 1),
                _pad_to(reads.lseq[r0:r1].astype(np.int32), R_B + 1),
                _pad_to((seq_off64[r0:r1] - q0).astype(np.int32), R_B + 1),
                _pad_to(reads.seq[q0:q1].astype(np.uint8), Q_B),
                _pad_to(reads.qual[q0:q1].astype(np.uint8), Q_B),
                _pad_to(name_id[r0:r1].astype(np.int32), R_B + 1, -1),
                _pad_to(name_len[r0:r1].astype(np.uint8), R_B + 1),
                _pad_to(np.append(up[t0:t1], np.uint8(0)), seg_l + 1),
                _pad_to(np.append(is_n[t0:t1], True), seg_l + 1, True),
                _pad_to(gate_u8[t0 - gate_base:t1 - gate_base], seg_l),
                np.int32(S),
                np.float32(cfg.min_snv_ratio),
                _pad_to((d_pos[dlo_i:dhi_i] - t0).astype(np.int32), D_B,
                        seg_l),
                _pad_to(d_mq[dlo_i:dhi_i], D_B),
                _pad_to(d_hi[dlo_i:dhi_i], D_B),
                _pad_to(d_lo[dlo_i:dhi_i], D_B),
                np.int32(nd),
                np.int32(t1 - t0),
            ])
        while len(rows) < n:
            rows.append(empty_cell())
        return [np.stack([r[j] for r in rows]) for j in range(24)]


_MESH_ACC: Optional[MeshAccumulator] = None


def get_mesh_accumulator() -> MeshAccumulator:
    """Singleton mesh accumulator over all local devices."""
    global _MESH_ACC
    if _MESH_ACC is None:
        _MESH_ACC = MeshAccumulator()
    return _MESH_ACC

"""Vectorized SV detection screen: the data-parallel half of the per-position
SV detectors (src/GROM.c:11750-13553).

The reference walks every genome position and, at each, evaluates up to
twelve breakpoint tests (soft-clip INS left/right, CTX_F/R, DUP start/end,
DEL start/end, INV_F and INV_R start/end), each a binomial-table gather plus
integer gates.  Here that per-position work is batched: one call scores a
whole detection window's typed-evidence entries (and the dense soft-clip INS
screen) with array gathers, and emits the sparse, (pos, kind)-ordered
"action" stream of ACCEPTED tests.  The exact sequential tail — candidate
list caps, the bisect end-matching, the INS state machine
(sv.SvDetector._consume) — then walks only those actions, in the same order
the reference's scalar loop would have reached them, so the result is
byte-identical.

The scoring core is ``xp``-generic (numpy or jax.numpy): the host engine
calls it with numpy; the device engines run the same gathers under jit in
float64 inside JAX's x64 scope (ops/sv_device.py), bit-identical to numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from grom_tpu.call.deposits import E_CTX_F, E_CTX_R
from grom_tpu.config import DerivedConfig, GromConfig

# Action kinds, numbered in the reference's within-position evaluation order
# (src/GROM.c:11750 INS, :11966 CTX, :12128 DUP, :12474 DEL, :12848 INV_F,
# :13197 INV_R) — sorting by (pos, kind) reproduces the scalar loop's order.
K_INS_START, K_INS_END = 0, 1
K_CTX_F, K_CTX_R = 2, 3
K_DUP_START, K_DUP_END = 4, 5
K_DEL_START, K_DEL_END = 6, 7
K_INVF_START, K_INVF_END = 8, 9
K_INVR_START, K_INVR_END = 10, 11

# etype (deposits.E_*) -> action kind; index 0 unused
_ETYPE_KIND = np.array([-1,
                        K_DEL_START,    # E_DEL_F  = 1
                        K_DEL_END,      # E_DEL_R  = 2
                        K_DUP_END,      # E_DUP_F  = 3
                        K_DUP_START,    # E_DUP_R  = 4
                        K_INVF_START,   # E_INV_F1 = 5
                        K_INVR_START,   # E_INV_R1 = 6
                        K_INVF_END,     # E_INV_F2 = 7
                        K_INVR_END,     # E_INV_R2 = 8
                        K_CTX_F,        # E_CTX_F  = 9
                        K_CTX_R,        # E_CTX_R  = 10
                        ], np.int32)

# etype -> reverse geometry/weak-side flag: 1 when the test anchors on the
# reverse mate (gate rs + lseq - pos < mean, weak = sc_left + munmapped_r),
# 0 for the forward side (gate pos - re < mean, weak = sc_right +
# munmapped_f).  del_r, dup_r, inv_r1, inv_r2, ctx_r are reverse-side.
_ETYPE_REV = np.array([0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1], np.int32)


@dataclass
class Actions:
    """Accepted detection actions of one window, sorted by (pos, kind)."""
    pos: np.ndarray        # int64
    kind: np.ndarray       # int32
    binom: np.ndarray      # float64
    hez: np.ndarray        # float64 (2.0 where the evidence-ratio gate fails)
    ev: np.ndarray         # int64: primary count (entries) / ins (soft-clip)
    rd: np.ndarray         # int64
    conc: np.ndarray       # int64
    rs: np.ndarray         # int64 (0 for INS actions)
    re: np.ndarray         # int64
    mchr: np.ndarray       # int32
    dist: np.ndarray       # float64
    other_len: np.ndarray  # int32 (capped at 50)

    def __len__(self) -> int:
        return len(self.pos)


def _f32_ratio_gate(xp, weak, strong):
    """The reference's float32 evidence-ratio gate (src/GROM.c:11996 et al):
    (float)weak / (float)strong <= 0.25 — NaN (0/0) and inf compare False.

    Evaluated exactly in int64 so every backend agrees bit for bit (a GPU's
    float32 division need not round the IEEE way): with W, S the counts
    rounded to float32, round-to-nearest-even gives W / S <= 0.25 exactly
    when W * 2^26 <= S * (2^24 + 1) — the midpoint between 0.25 and the
    next float32 ties to 0.25 — and S > 0. Needs 64-bit integers: jnp
    callers run inside ``jax.enable_x64``."""
    w = weak.astype(xp.float32).astype(xp.int64)
    s = strong.astype(xp.float32).astype(xp.int64)
    if w.dtype.itemsize < 8:
        raise TypeError("_f32_ratio_gate needs int64 (jax.enable_x64)")
    return (s > 0) & (w * (1 << 26) <= s * ((1 << 24) + 1))


def binom_pair_vec(xp, rd, strong, weak, mq_tab, hez_tab, af: int, mt: int,
                   gate_weak=None, gate_strong=None):
    """Vectorized sv._binom_pair: (binom, hez) per entry.

    ``rd > mt`` takes the reference's scaled-trials branch (which always
    gates on (weak, strong) — the gate_weak/gate_strong overrides only apply
    in the rd <= mt branch, reproducing src/GROM.c:12068's copy-paste bug
    exactly as the scalar helper does)."""
    big = rd > mt
    k_big = strong * mt // (af * xp.maximum(rd, 1))
    row = xp.where(big, mt, rd)
    col = xp.where(big, xp.minimum(k_big, mt), xp.minimum(strong // af, mt))
    binom = mq_tab[row, col]

    gw = weak if gate_weak is None else xp.where(big, weak, gate_weak)
    gs = strong if gate_strong is None else xp.where(big, strong, gate_strong)
    gate = _f32_ratio_gate(xp, gw, gs)

    k2 = (strong + weak) // af
    k2_lt = k2 < rd
    k2i = xp.minimum((strong + weak) * mt // (af * xp.maximum(rd, 1)), mt)
    hez_col = xp.where(big,
                       xp.where(k2_lt, k2i, mt),
                       xp.where(k2_lt, k2, rd))
    hez = xp.where(gate, hez_tab[row, hez_col], xp.float64(2.0))
    return binom, hez


def score_sv_entries(xp, pos, etype, count, rs, re, rd, weak_f, weak_r,
                     ctx_f_here, mq_tab, hez_tab, af: int, mt: int,
                     md: int, thr1: float, mean: int, lseq: int):
    """Score one window's SV-family evidence entries (already gathered:
    per-entry dense values rd/weak_f/weak_r at the entry position).

    Returns (kind, accept, binom, hez) arrays.  ``ctx_f_here`` is the CTX_F
    primary count at the same position (0 when absent) — the ctx_r
    evidence-ratio gate reads the ctx_f side's values
    (src/GROM.c:12068)."""
    kind = _ETYPE_KIND[etype] if xp is np else xp.asarray(_ETYPE_KIND)[etype]
    rev = _ETYPE_REV[etype] if xp is np else xp.asarray(_ETYPE_REV)[etype]
    rev = rev.astype(bool)

    md_ok = (count // af) >= md
    geom_ok = xp.where(rev, rs + lseq - pos < mean, pos - re < mean)
    weak = xp.where(rev, weak_r, weak_f)

    binom, hez = binom_pair_vec(xp, rd, count, weak, mq_tab, hez_tab, af, mt)
    # ctx_r's overridden-gate variant, selected where etype == E_CTX_R
    _, hez_ctx_r = binom_pair_vec(xp, rd, count, weak, mq_tab, hez_tab,
                                  af, mt, gate_weak=weak_f,
                                  gate_strong=ctx_f_here)
    is_ctx_r = etype == E_CTX_R
    hez = xp.where(is_ctx_r, hez_ctx_r, hez)

    accept = md_ok & geom_ok & (rd > 0) & (binom <= thr1)
    return kind, accept, binom, hez


def score_ins(xp, rd, sc_rd, sc_left, sc_right, sc_left_rd, sc_right_rd,
              ins, mun_f, mun_r, mq_tab, af: int, mt: int, md: int,
              p_ins1: float):
    """Dense soft-clip INS screen over a window (src/GROM.c:11750-11960):
    (ok_left, binom_left, ok_right, binom_right) per position."""
    alive = rd + sc_rd > 0

    n_l = rd + sc_left_rd
    k_l = (mun_r + sc_left + ins) // af
    row_l = xp.minimum(n_l, mt)
    binom_l = mq_tab[row_l, xp.minimum(k_l, row_l)]
    ok_l = (alive & ((sc_left + ins) // af >= md) & (n_l <= mt)
            & (binom_l <= p_ins1))

    n_r = rd + sc_right_rd
    k_r = (mun_f + sc_right + ins) // af
    row_r = xp.minimum(n_r, mt)
    binom_r = mq_tab[row_r, xp.minimum(k_r, row_r)]
    ok_r = (alive & ((sc_right + ins) // af >= md) & (n_r <= mt)
            & (binom_r <= p_ins1))
    return ok_l, binom_l, ok_r, binom_r


def _other_len(ev, pos: np.ndarray, cap: int = 50) -> np.ndarray:
    a = np.searchsorted(ev.oth_pos, pos, side="left")
    b = np.searchsorted(ev.oth_pos, pos, side="right")
    return np.minimum(b - a, cap).astype(np.int32)


def screen_window(ev, dense, lo: int, hi: int, cfg: GromConfig,
                  drv: DerivedConfig, mq_tab, hez_tab, lo_gate: int,
                  scan_start: int, scan_end: int, L: int,
                  scorer=None) -> Actions:
    """Build the accepted-action stream for window [lo, hi).

    ``ev`` is the window's EvidenceChunk (pos-sorted, (pos, etype)-unique);
    ``dense`` the drained DenseArrays (arrays start at dense.base).
    ``scorer`` (ops/sv_device.DeviceSvScorer) runs the entry score math on
    the attached accelerator instead of host numpy; the sparse assembly and
    the soft-clip INS screen (already sparse after the int32 prefilter)
    stay host-side."""
    af, md, mt = cfg.add_factor, cfg.min_disc, cfg.max_trials
    thr1 = cfg.pval_threshold1
    mean, lseq = drv.insert_mean, drv.read_len
    base = dense.base
    i64 = lambda a: a.astype(np.int64)

    # position eligibility shared by every test (src/GROM.c's scan bounds)
    def elig(p):
        return ((p > lo_gate) & (p >= scan_start) & (p <= scan_end)
                & (p < L))

    # ---- typed-evidence entries -------------------------------------------
    sel = np.flatnonzero((ev.pos >= lo) & (ev.pos < hi)
                         & (ev.etype <= E_CTX_R) & elig(ev.pos))
    e_pos = ev.pos[sel]
    e_et = ev.etype[sel]
    pb = (e_pos - base).astype(np.intp)
    e_rd = i64(dense.rd[pb])
    weak_f = i64(dense.sc_right[pb]) + i64(dense.munmapped_f[pb])
    weak_r = i64(dense.sc_left[pb]) + i64(dense.munmapped_r[pb])
    e_count = i64(ev.count[sel])
    e_rs = ev.rs[sel]
    e_re = ev.re[sel]

    # ctx_f primary count at the same position (entries are (pos, etype)
    # sorted and unique, so a fused key is searchable)
    key = ev.pos * np.int64(16) + ev.etype
    want = e_pos * np.int64(16) + np.int64(E_CTX_F)
    j = np.searchsorted(key, want)
    j_ok = (j < len(key)) & (key[np.minimum(j, len(key) - 1)] == want)
    ctx_f_here = np.where(j_ok, ev.count[np.minimum(j, len(key) - 1)],
                          0).astype(np.int64)

    if scorer is not None:
        kind, acc, binom, hez = scorer(e_pos, e_et, e_count, e_rs, e_re,
                                       e_rd, weak_f, weak_r, ctx_f_here)
    else:
        kind, acc, binom, hez = score_sv_entries(
            np, e_pos, e_et, e_count, e_rs, e_re, e_rd, weak_f, weak_r,
            ctx_f_here, mq_tab, hez_tab, af, mt, md, thr1, mean, lseq)

    # ---- soft-clip INS screen ---------------------------------------------
    # cheap int32 prefilter over the dense window (the reference's
    # interesting-position mask) so the table gathers below touch only the
    # sparse candidate set — the dense form would fault ~14 window-length
    # temporaries on every chunk
    s0, s1 = lo - base, hi - base
    scl = dense.sc_left[s0:s1]
    scr = dense.sc_right[s0:s1]
    insv = dense.ins[s0:s1]
    cand = np.flatnonzero((((scl + insv) // af) >= md)
                          | (((scr + insv) // af) >= md))
    ins_pos = cand.astype(np.int64) + lo
    keep = elig(ins_pos)
    ins_pos = ins_pos[keep]
    ipb = (ins_pos - base).astype(np.intp)
    ok_l, binom_l, ok_r, binom_r = score_ins(
        np, i64(dense.rd[ipb]), i64(dense.sc_rd[ipb]),
        i64(dense.sc_left[ipb]), i64(dense.sc_right[ipb]),
        i64(dense.sc_left_rd[ipb]), i64(dense.sc_right_rd[ipb]),
        i64(dense.ins[ipb]), i64(dense.munmapped_f[ipb]),
        i64(dense.munmapped_r[ipb]), mq_tab, af, mt, md,
        cfg.pval_insertion1)

    ai = np.flatnonzero(acc)
    parts_pos = [e_pos[ai]]
    parts_kind = [kind[ai].astype(np.int32)]
    parts_binom = [binom[ai]]
    parts_hez = [hez[ai]]
    parts_ev = [e_count[ai]]
    parts_rd = [e_rd[ai]]
    parts_conc = [i64(dense.conc[pb[ai]])]
    parts_rs = [e_rs[ai]]
    parts_re = [e_re[ai]]
    parts_mchr = [ev.mchr[sel][ai].astype(np.int32)]
    parts_dist = [ev.dist[sel][ai]]

    for okv, bv, kk in ((ok_l, binom_l, K_INS_START),
                        (ok_r, binom_r, K_INS_END)):
        ii = np.flatnonzero(np.asarray(okv))
        p = ins_pos[ii]
        parts_pos.append(p)
        parts_kind.append(np.full(len(ii), kk, np.int32))
        parts_binom.append(np.asarray(bv)[ii])
        parts_hez.append(np.full(len(ii), 2.0))
        spb = ipb[ii]
        parts_ev.append(i64(dense.ins[spb]))
        parts_rd.append(i64(dense.rd[spb]))
        parts_conc.append(i64(dense.conc[spb]))
        z = np.zeros(len(ii), np.int64)
        parts_rs.append(z)
        parts_re.append(z)
        parts_mchr.append(np.zeros(len(ii), np.int32))
        parts_dist.append(np.zeros(len(ii)))

    pos = np.concatenate(parts_pos)
    kind = np.concatenate(parts_kind)
    order = np.lexsort((kind, pos))
    pos = pos[order]
    return Actions(
        pos=pos, kind=kind[order],
        binom=np.concatenate(parts_binom)[order],
        hez=np.concatenate(parts_hez)[order],
        ev=np.concatenate(parts_ev)[order],
        rd=np.concatenate(parts_rd)[order],
        conc=np.concatenate(parts_conc)[order],
        rs=np.concatenate(parts_rs)[order],
        re=np.concatenate(parts_re)[order],
        mchr=np.concatenate(parts_mchr)[order],
        dist=np.concatenate(parts_dist)[order],
        other_len=_other_len(ev, pos))

"""Device (jax/XLA) CNV kernels: per-base midrank z-scores and the
del/dup window-scan seed evaluation as multi-scale prefix-sum queries —
the SURVEY §7.4 formulation of the reference's sequential loops
(src/GROM.c:18754-18962 z-scores; :19358-19700 window growth).

Design
------
* ``zscores_device`` is embarrassingly parallel: per-position bin lookup →
  batched binary searches into the rows of the padded bin-distribution
  matrix → midrank probability → pval2sd table gather. The reference's sticky
  depth-class (``last_low``) is a forward-fill, expressed as an
  ``associative_scan`` max over last-definite indices.
* ``_seed_kernel`` evaluates EVERY candidate seed's first-window +
  grow phases simultaneously: the per-window running totals the C code
  accumulates base-by-base become gathers into global prefix sums of the
  gated z values / gate counts, evaluated for all window lengths at once
  (the "pyramid": every window length's mean from one cumulative sum).
  The within-window sticky class is handled exactly: for a seed s the
  window prefix before the first gated-definite position >= s uses the
  seed's outer class, the suffix uses the global gated-class state —
  both precomputable, so each seed is two prefix-sum families + one
  boundary index. Both outer-class variants are evaluated (a zero-depth
  low-mapq seed inherits its class from the host walk's jump history,
  which only the host knows).
* The outer walk (seed acceptance order, post-call jumps), the rare
  max-window slide extension and the trailing trim remain host-side
  sequential — they consume the device's per-seed outcomes. This split
  mirrors the engine split everywhere else in the framework: dense
  per-base math on device, sparse stateful decisions on host.
* Each kernel is one module-level jitted function that takes every array
  as an argument, so a chromosome compiles each kernel once per bucket
  shape (seed counts are padded to powers of two).

Exactness: every entry point runs inside JAX's x64 scope
(``grom_tpu.ops.exact_f64``), so the kernels compute in float64/int64 on
any backend without x64 being on for the whole process. The z-score and
window-scan float accumulation order matches the host implementation's
cumsum order, so those stages are bit-identical on the CPU backend
(tests/test_cnv_device.py); the null-window model's prefix sums are XLA
log-depth scans and its per-length sums are scatter-adds (atomics on a
GPU, whose order varies from run to run), so its win_std agrees to
~1e-12 relative and final calls within the emission SD tolerance. The
host remains the emitter. Device CNV is the DEFAULT when the resolved
engine is device/mesh; GROM_TPU_DEVICE_CNV=1/0 forces it on/off.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grom_tpu.ops import exact_f64


def build_bin_matrix(hi_arr: List[np.ndarray], lo_arr: List[np.ndarray],
                     nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the per-(class, gc) sorted depth distributions into a dense
    [2*nb, maxn] int64 matrix (sentinel int64-max) + lengths [2*nb]."""
    arrs = list(hi_arr) + list(lo_arr)
    lens = np.array([len(a) for a in arrs], np.int64)
    maxn = max(1, int(lens.max()) if len(lens) else 1)
    mat = np.full((2 * nb, maxn), np.iinfo(np.int64).max, np.int64)
    for i, a in enumerate(arrs):
        if len(a):
            mat[i, :len(a)] = a
    return mat, lens


def _row_count(mat, k, key, right: bool):
    """Per position i, how many entries of the sorted row ``mat[k[i]]`` are
    <= key[i] (``right``) or < key[i] — np.searchsorted on each row, as a
    batched binary search (log2 of the row width gathers, no [n, width]
    intermediate). The rows' int64-max padding never counts."""
    width = mat.shape[1]
    flat = mat.reshape(-1)
    base = k * width
    lo = jnp.zeros(key.shape, k.dtype)
    hi = jnp.full(key.shape, width, k.dtype)

    def step(_, c):
        lo, hi = c
        active = lo < hi
        mid = (lo + hi) // 2
        v = flat[base + jnp.minimum(mid, width - 1)]
        go = active & ((v <= key) if right else (v < key))
        return (jnp.where(go, mid + 1, lo),
                jnp.where(active & ~go, mid, hi))

    lo, _ = jax.lax.fori_loop(0, int(width).bit_length(), step, (lo, hi))
    return lo


@functools.partial(jax.jit, static_argnames=("nb", "min_mapq",
                                             "dup_thr_factor", "ranks"))
def _zscore_kernel(d, m, g, la, w, mat, lens, avef, stdf, pvp, pvs, *,
                   nb, min_mapq, dup_thr_factor, ranks):
    n = d.shape[0]
    hi_mq = m >= min_mapq
    defz = jnp.where(hi_mq, 0, jnp.where(d > 0, 1, -1))
    k_elig = jnp.where(hi_mq, 0, nb) + g
    n_elig = lens[k_elig]
    eligible = (la == 0) & (n_elig > 1)
    # sticky class: forward-fill of defz at eligible definite positions
    idx = jnp.arange(n)
    upd = eligible & (defz >= 0)
    fi = jax.lax.associative_scan(jnp.maximum, jnp.where(upd, idx, -1))
    last_cls = jnp.where(fi >= 0, defz[jnp.maximum(fi, 0)], 0)
    cls = jnp.where(defz >= 0, defz, last_cls)
    k = cls * nb + g
    nk = lens[k]
    valid = eligible & (nk > 0)
    av = avef[k]

    def fx(s):
        return jnp.where((nk == 2) & (s == 0), 1, s)

    below = d.astype(jnp.float64) < av
    clamp = dup_thr_factor * av
    key_l = jnp.where(d.astype(jnp.float64) > clamp,
                      clamp.astype(jnp.int64), d)
    le_d = _row_count(mat, k, d, True)
    bi = jnp.where(below, fx(le_d), nk - fx(_row_count(mat, k, key_l, False)))
    bi2 = jnp.where(below, fx(_row_count(mat, k, d, False)), nk - fx(le_d))
    di = jnp.where(bi <= 0, 0.5, bi.astype(jnp.float64))
    di2 = jnp.where(bi2 <= 0, 0.5, bi2.astype(jnp.float64))
    prob = (di + di2) / (2.0 * nk.astype(jnp.float64))
    pi = jnp.clip(jnp.searchsorted(pvp, prob, side="right"),
                  0, pvp.shape[0] - 1)
    sign = jnp.where(below, 1.0, -1.0)
    base_rank = sign * pvs[pi]
    sb = stdf[k]
    direct = jnp.where(
        below, jnp.where(sb != 0.0, (av - d) / sb, 0.0),
        jnp.where(d.astype(jnp.float64) > clamp,
                  jnp.where(sb != 0.0,
                            (dup_thr_factor - 1.0) * (-av) / sb, 0.0),
                  jnp.where(sb != 0.0, (av - d) / sb, 0.0)))
    base = base_rank if ranks else direct
    return jnp.where(valid, w * base, 0.0)


@exact_f64
def zscores_device(depth: np.ndarray, mq: np.ndarray, gc: np.ndarray,
                   low_acgt: np.ndarray, bin_mat: np.ndarray,
                   bin_len: np.ndarray, ave: np.ndarray, std: np.ndarray,
                   pv_p: np.ndarray, pv_sd: np.ndarray, nb: int,
                   lo: int, hi: int, min_mapq: int, mapq_factor: float,
                   dup_thr_factor: float, ranks: bool) -> np.ndarray:
    """Per-base z-scores over [lo, hi) (zeros elsewhere), bit-identical to
    cnv.detect_del_dup's z stage on the CPU backend. Returns float64 [L]."""
    L = len(depth)
    if hi <= lo:
        return np.zeros(L)
    # the mapq weight is computed HOST-side: XLA contracts the mul/div
    # chain (fma / reciprocal) and drifts the last ulp vs numpy
    mq_np = mq[lo:hi]
    w_np = np.where(mq_np >= min_mapq,
                    mapq_factor + (1.0 - mapq_factor)
                    * (mq_np - min_mapq) / 40.0,
                    mapq_factor)
    z = _zscore_kernel(
        jnp.asarray(depth[lo:hi].astype(np.int64)),
        jnp.asarray(mq[lo:hi].astype(np.int64)),
        jnp.asarray(gc[lo:hi].astype(np.int64)),
        jnp.asarray(low_acgt[lo:hi].astype(np.int8)), jnp.asarray(w_np),
        jnp.asarray(bin_mat), jnp.asarray(bin_len),
        jnp.asarray(ave.reshape(-1)), jnp.asarray(std.reshape(-1)),
        jnp.asarray(pv_p), jnp.asarray(pv_sd), nb=int(nb),
        min_mapq=int(min_mapq), dup_thr_factor=float(dup_thr_factor),
        ranks=bool(ranks))
    out = np.zeros(L)
    out[lo:hi] = np.asarray(z)
    return out


@functools.partial(jax.jit, static_argnames=("minw", "maxw", "max_low",
                                             "width"))
def _seed_kernel(sv, lw, s0, s1, gi, gv, ws, sd, sc, n_per, *, minw, maxw,
                 max_low, width):
    def one(seed, cls_m, n):
        j = jnp.arange(width)
        p = seed + j
        in_n = j < n
        # class at window offset j: global gated state if its last update
        # is inside the window, else the seed's outer class
        use_global = gi[p] >= seed
        cls_w = jnp.where(use_global, gv[p], cls_m).astype(jnp.int32)
        sokw = jnp.where(cls_w == 0, s0[p], s1[p])
        lwp = lw[p] & in_n
        inc = lwp & sokw
        wl = j + 1
        lc2x = jnp.cumsum(inc) - inc              # count BEFORE j
        fail = (~inc) & (2 * lc2x < wl) & in_n
        f1 = jnp.min(jnp.where(fail, j, jnp.minimum(n, width)))
        alive = j < f1                            # processed window prefix
        svp = jnp.where(in_n, sv[p], 0.0)
        # ONE sequential cumsum drives both phases so the fp association
        # matches the host exactly: the first minw elements are ALL svals
        # (their prefix at minw-1 IS low_total0 in host order), the grow
        # tail adds only gated svals — ((t0+g1)+g2)+...
        first = j < minw
        grow = (j >= minw) & alive
        contrib = jnp.where(first, svp, jnp.where(lwp, svp, 0.0))
        # sequential prefix sum (lax.scan): XLA's cumsum reassociates the
        # adds (log-depth scan), which drifts the scores by ulps vs the
        # host's strictly sequential accumulation — scan keeps bit parity
        _, lt_all = jax.lax.scan(lambda c, x: (c + x, c + x), 0.0, contrib)
        low_total0 = lt_all[minw - 1]
        low_count0 = jnp.sum(first & lwp)
        ok_first = (f1 >= minw)
        ts0 = jnp.where((low_count0 > 0) & (ws[minw] > 0.0),
                        low_total0 / (low_count0 * ws[minw]), 0.0)
        begin0 = (ok_first & (low_count0 > 0) & (ws[minw] > 0.0)
                  & (ts0 >= 3.0)
                  & ((minw - low_count0) / minw <= max_low))
        lt = lt_all
        lc = low_count0 + jnp.cumsum(grow & lwp)
        wsg = ws[jnp.minimum(wl, maxw)]
        tsg = jnp.where((lc > 0) & (wsg > 0.0), lt / (lc * wsg), 0.0)
        good = (grow & inc & (wsg > 0.0) & (tsg >= 3.0)
                & ((wl - lc).astype(jnp.float64) / wl <= max_low))
        any_good = jnp.any(good)
        lastg = jnp.max(jnp.where(good, j, -1))
        c_sd_grow = jnp.max(jnp.where(good, tsg, -jnp.inf))
        begin = begin0 | any_good
        c_end = jnp.where(any_good, seed + lastg,
                          jnp.where(begin0, seed + minw, 0))
        c_sd = jnp.where(begin0, ts0, 0.0)
        c_sd = jnp.where(any_good, jnp.maximum(c_sd, c_sd_grow), c_sd)
        return f1, begin, c_end, c_sd

    return jax.vmap(one)(sd, sc, n_per)


def _seed_inputs(svals, lowa, sok0, sok1, gcls_idx, gcls_val, win_std,
                 maxw):
    """The per-position seed-scan arrays on the device, padded so seed
    windows can gather past the end safely (uploaded once per scan)."""
    pad = maxw + 2
    return (jnp.asarray(np.concatenate([svals, np.zeros(pad)])),
            jnp.asarray(np.concatenate([lowa, np.zeros(pad, bool)])),
            jnp.asarray(np.concatenate([sok0, np.zeros(pad, bool)])),
            jnp.asarray(np.concatenate([sok1, np.zeros(pad, bool)])),
            jnp.asarray(np.concatenate([gcls_idx,
                                        np.full(pad, -1, np.int64)])),
            jnp.asarray(np.concatenate([gcls_val.astype(np.int8),
                                        np.zeros(pad, np.int8)])),
            jnp.asarray(win_std))


def _seed_eval(inputs, seeds, cls, minw, maxw, max_low, be, width):
    """Evaluate the first-window + grow phases for every seed position at
    once (the host walk then applies acceptance order / jumps / slide /
    trim). All float accumulation is a cumulative sum seeded with the
    first-window total — same association as the host code.

    ``inputs`` are the device arrays from _seed_inputs (full-length L):
      svals     f64  side-signed weighted z per position
      lowa      bool low_acgt == 0
      sok0/sok1 bool per-class seed-threshold pass
      gcls_idx  i64  last gated-definite position index at or before p (-1)
      gcls_val  i8   class at that position (undefined where idx < 0)
      win_std   f64  [maxw+1] null window stdevs
    and per call:
      seeds     i64  [NS] candidate seed positions
      cls       int  the outer class to evaluate the seeds with
      be        int  scan end (seed windows clip at be)

    ``width`` (static, maxw or less) truncates the evaluated window — the
    two-tier scheme: a cheap 512-wide pass for every seed, the full maxw
    pass only for seeds whose first fail did not land inside the cap
    (valid because the fail index depends only on data before it).

    Returns per seed: f1 (first fail offset; ``width`` if none found
    within the evaluated window), begin (bool), c_end (int64), c_sd
    (f64), n (true window length)."""
    NS = len(seeds)
    # pad the seed axis to a pow2 bucket: every distinct NS would otherwise
    # compile its own executable (sentinel seeds evaluate harmlessly at
    # position `be` and are sliced off below)
    NS_pad = 1 << max(4, (NS - 1).bit_length())
    seeds_p = np.full(NS_pad, be, np.int64)
    seeds_p[:NS] = seeds
    cls_p = np.full(NS_pad, cls, np.int32)
    n_per = np.minimum(np.maximum(be - seeds_p, minw), maxw)
    f1, begin, c_end, c_sd = _seed_kernel(
        *inputs, jnp.asarray(seeds_p), jnp.asarray(cls_p),
        jnp.asarray(n_per), minw=int(minw), maxw=int(maxw),
        max_low=float(max_low), width=int(width))
    return (np.asarray(f1)[:NS], np.asarray(begin)[:NS],
            np.asarray(c_end)[:NS], np.asarray(c_sd)[:NS], n_per[:NS])


# seeds per kernel call x window width: bounds each [seeds, width] float64
# intermediate to 1 GiB
SEED_ELEMS = 1 << 27


def _seed_eval_chunked(inputs, seeds, cls, minw, maxw, max_low, be, width):
    """_seed_eval over the (non-empty) ``seeds``, for one outer class, in
    chunks of at most SEED_ELEMS // width seeds; returns writable numpy
    arrays."""
    step = 1 << max(4, (SEED_ELEMS // width).bit_length() - 1)
    parts = [_seed_eval(inputs, seeds[c0:c0 + step], cls, minw, maxw,
                        max_low, be, width)
             for c0 in range(0, len(seeds), step)]
    return [np.concatenate([p[i] for p in parts]) for i in range(5)]


@exact_f64
def window_scan_device(blocks, depth, mq, gc, nwin, low_acgt, stdev_list,
                       thr, win_std, cfg, L, side: int):
    """Drop-in for call/cnv._window_scan with the per-seed window math on
    device: candidate seeds are batch-evaluated by _seed_kernel (both
    outer classes), then the host outer walk consumes the outcomes in the
    reference's order (jump/suppression after each emitted call), keeping
    only the rare slide/trim phases sequential. Differential-tested
    bit-identical in tests/test_cnv_device.py."""
    from grom_tpu.call.cnv import CnvCall, _slide_phase, _trim_phase

    minw = cfg.min_rd_window_len
    maxw = cfg.max_rd_window_len
    max_low = cfg.max_rd_low_acgt_or_windows
    out = []

    defc = np.where(mq >= cfg.min_mapq, np.int8(0),
                    np.where(depth > 0, np.int8(1), np.int8(-1)))
    idx = np.arange(L, dtype=np.int64)
    lowa = low_acgt == 0
    gcls_idx = np.where(lowa & (defc >= 0), idx, np.int64(-1))
    np.maximum.accumulate(gcls_idx, out=gcls_idx)
    gcls_val = defc[np.maximum(gcls_idx, 0)]
    if side > 0:
        sok0 = depth <= thr[0, gc]
        sok1 = depth <= thr[1, gc]
    else:
        sok0 = depth >= thr[0, gc]
        sok1 = depth >= thr[1, gc]
    svals = side * stdev_list
    inputs = _seed_inputs(svals, lowa, sok0, sok1, gcls_idx, gcls_val,
                          win_std, maxw)

    for (bs, be0) in blocks:
        be = be0 - minw
        if be <= bs:
            continue
        cand = np.flatnonzero((sok0 | sok1)[bs:be]) + bs
        if not len(cand):
            continue
        # device pass: evaluate every candidate for both outer classes —
        # two-tier (capped width first, full maxw only for seeds whose
        # first fail did not land inside the cap)
        W1 = min(max(2 * minw, 512), maxw)
        res = {}
        for cls in (0, 1):
            r = _seed_eval_chunked(inputs, cand, cls, minw, maxw, max_low,
                                   be, W1)
            incomplete = np.flatnonzero((r[0] == W1) & (r[4] > W1))
            if len(incomplete):
                full = _seed_eval_chunked(inputs, cand[incomplete], cls,
                                          minw, maxw, max_low, be, maxw)
                for a, fa in zip(r, full):
                    a[incomplete] = fa
            res[cls] = r
        pos_to_i = {int(p): i for i, p in enumerate(cand)}

        # host outer walk (reference order; src/GROM.c:19358-19380)
        mq_index = 0
        pos = bs
        while pos < be:
            dc = defc[pos]
            if dc >= 0:
                mq_index = int(dc)
            sok_cls = sok0 if mq_index == 0 else sok1
            if not sok_cls[pos]:
                pos += 1
                continue
            i = pos_to_i[pos]
            f1, begin, c_end, c_sd, n = (int(res[mq_index][0][i]),
                                         bool(res[mq_index][1][i]),
                                         int(res[mq_index][2][i]),
                                         float(res[mq_index][3][i]),
                                         int(res[mq_index][4][i]))
            if f1 < minw:
                pos = pos + f1 + 1
                continue
            stop_base = f1 < n or n < maxw
            lp = pos + f1 if f1 < n else pos + n - 1
            q = gcls_idx[lp]
            mqi = int(defc[q]) if q >= pos else mq_index
            last_good = c_end if begin else 0
            if not stop_base and begin:
                c_end, c_sd, last_good, mqi = _slide_phase(
                    pos, maxw, L, maxw + 500, last_good, c_end, c_sd, mqi,
                    mq, depth, lowa, nwin, gc, svals, win_std, cfg,
                    3.0, max_low)
            if begin:
                c_end, _ = _trim_phase(pos, c_end, minw, mqi, mq, depth,
                                       lowa, sok0, sok1, cfg, max_low)
                out.append(CnvCall(pos, c_end, c_sd))
                pos = c_end + 2
            else:
                pos += 1
    return out


@functools.partial(jax.jit, static_argnames=("minw", "maxw"))
def _null_batch(Zc, Cc, sums, counts, s, nseg, wl0, t0, c0, *, minw, maxw):
    """One batch of null-window segments: every window prefix mean from two
    gathers into the global prefix sums, accumulated per window length."""
    j = jnp.arange(maxw)
    x = s[:, None] + 1 + j[None, :]
    act = j[None, :] < nseg[:, None]
    xi = jnp.where(act, x, 0)
    z = t0[:, None] + Zc[xi] - Zc[s][:, None]
    c = c0[:, None] + Cc[xi] - Cc[s][:, None]
    lens = wl0[:, None] + 1 + j[None, :]
    ok = act & (lens >= minw) & (c > 0)
    v = jnp.where(ok, z / jnp.where(c > 0, c, 1), 0.0)
    li = jnp.where(ok, lens, 0).ravel()
    sums = sums.at[li].add(jnp.where(ok, v * v, 0.0).ravel())
    counts = counts.at[li].add(ok.astype(jnp.int64).ravel())
    return sums, counts


@exact_f64
def null_model_device(lowvar_blocks, stdev_list: np.ndarray,
                      gate: np.ndarray, minw: int, maxw: int,
                      sampling_rate: int,
                      batch: int = 1024) -> np.ndarray:
    """Per-length null window stdev on device (the host
    cnv._null_window_model re-expressed): window boundaries are pure
    modular arithmetic per (block, phase), so every window prefix mean
    becomes two gathers into GLOBAL prefix sums — one device cumsum pass
    plus batched [segments, maxw] grids replace the reference's sequential
    window walk (src/GROM.c:18975-19015, :19180-19215).

    Float caveat: XLA's cumsum is a log-depth scan, so the prefix values
    (and the cross-phase carries) differ from the host's sequential
    accumulation in the last ulps; scores agree to ~1e-9 relative
    (tests/test_cnv_device.py) and the host emitter still makes the
    calls. Returns float64 [maxw + 1]."""
    zg = np.where(gate, stdev_list, 0.0)
    cg = gate.astype(np.int64)
    Zc = jnp.concatenate([jnp.zeros(1, jnp.float64),
                          jnp.cumsum(jnp.asarray(zg))])
    Cc = jnp.concatenate([jnp.zeros(1, jnp.int64),
                          jnp.cumsum(jnp.asarray(cg))])

    # ---- segment table (host; mirrors the host loop's carry rules) ----
    seg_s: list = []
    seg_n: list = []
    seg_w: list = []
    seg_reset: list = []
    for (bs, be) in lowvar_blocks:
        wl0 = 0
        for phase in range(sampling_rate):
            adj = phase * maxw // sampling_rate
            s = bs + adj
            while s < be:
                room = maxw - wl0
                e = min(s + room, be)
                seg_s.append(s)
                seg_n.append(e - s)
                seg_w.append(wl0)
                seg_reset.append(wl0 == 0)
                if wl0 + (e - s) < maxw:
                    wl0 += e - s
                    break
                wl0 = 0
                s = e
    S = len(seg_s)
    win_std = np.zeros(maxw + 1)
    if S == 0:
        return win_std
    s_a = np.asarray(seg_s, np.int64)
    n_a = np.asarray(seg_n, np.int64)
    w_a = np.asarray(seg_w, np.int64)
    # carries (tot0/cnt0): chain of boundary prefix differences since the
    # last reset — a handful of scalars gathered from the device arrays
    zb0 = np.asarray(Zc[jnp.asarray(s_a)])
    zb1 = np.asarray(Zc[jnp.asarray(s_a + n_a)])
    cb0 = np.asarray(Cc[jnp.asarray(s_a)])
    cb1 = np.asarray(Cc[jnp.asarray(s_a + n_a)])
    tot0 = np.zeros(S)
    cnt0 = np.zeros(S, np.int64)
    run_z, run_c = 0.0, 0
    for i in range(S):
        if seg_reset[i]:
            run_z, run_c = 0.0, 0
        tot0[i] = run_z
        cnt0[i] = run_c
        run_z += float(zb1[i] - zb0[i])
        run_c += int(cb1[i] - cb0[i])

    sums = jnp.zeros(maxw + 1, jnp.float64)
    counts = jnp.zeros(maxw + 1, jnp.int64)
    for b0 in range(0, S, batch):
        b1 = min(b0 + batch, S)
        pad = batch - (b1 - b0)
        pz = lambda a, d: jnp.asarray(np.concatenate(
            [a[b0:b1], np.zeros(pad, d)]) if pad else a[b0:b1])
        sums, counts = _null_batch(Zc, Cc, sums, counts,
                                   pz(s_a, np.int64), pz(n_a, np.int64),
                                   pz(w_a, np.int64), pz(tot0, np.float64),
                                   pz(cnt0, np.int64), minw=int(minw),
                                   maxw=int(maxw))
    sums_h = np.asarray(sums)
    counts_h = np.asarray(counts)
    sel = counts_h > 1
    win_std[sel] = np.sqrt(sums_h[sel] / (counts_h[sel] - 1))
    win_std[:minw] = 0.0
    return win_std

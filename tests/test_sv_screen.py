"""Differential tests for the vectorized SV screen (call/sv_screen.py).

The scalar ``sv._binom_pair`` is the labeled reference port
(src/GROM.c:11966-12010 et al); ``binom_pair_vec`` must match it bit-exactly
on every branch — rd > max_trials scaling, the float32 evidence-ratio gate
(incl. its 0/0-NaN and x/0-inf behavior), the ctx_r gate overrides — since
the VCF text prints these values with %e.  The jnp variant (the device
engines' path) must match numpy bit-exactly under jax x64.
"""

import numpy as np
import pytest

from grom_tpu.call.sv import _binom_pair
from grom_tpu.call.sv_screen import binom_pair_vec, score_ins

MT = 60
AF = 10


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(7)
    mq = np.sort(rng.random((MT + 1, MT + 1)))[:, ::-1].copy()
    hez = np.sort(rng.random((MT + 1, MT + 1)))[:, ::-1].copy()
    return mq, hez


def _cases(rng, n):
    rd = rng.integers(0, 3 * MT, n)
    small = rng.random(n) < 0.3
    rd[small] = rng.integers(1, MT + 1, int(small.sum()))
    strong = rng.integers(0, AF * 2 * MT, n)
    weak = rng.integers(0, AF * MT, n)
    weak[rng.random(n) < 0.2] = 0
    strong[rng.random(n) < 0.2] = 0
    return rd.astype(np.int64), strong.astype(np.int64), weak.astype(np.int64)


def test_binom_pair_vec_matches_scalar(tables):
    mq, hez = tables
    rng = np.random.default_rng(11)
    rd, strong, weak = _cases(rng, 4000)
    b, h = binom_pair_vec(np, rd, strong, weak, mq, hez, AF, MT)
    for i in range(len(rd)):
        bs, hs = _binom_pair(int(rd[i]), int(strong[i]), int(weak[i]),
                             mq, hez, AF, MT)
        assert b[i] == bs and h[i] == hs, (i, rd[i], strong[i], weak[i])


def test_binom_pair_vec_gate_overrides(tables):
    """ctx_r's copy-paste-bug gates (gate_weak/gate_strong only apply in the
    rd <= max_trials branch)."""
    mq, hez = tables
    rng = np.random.default_rng(13)
    rd, strong, weak = _cases(rng, 2000)
    gw = rng.integers(0, AF * MT, len(rd)).astype(np.int64)
    gs = rng.integers(0, AF * MT, len(rd)).astype(np.int64)
    gs[rng.random(len(rd)) < 0.3] = 0
    b, h = binom_pair_vec(np, rd, strong, weak, mq, hez, AF, MT,
                          gate_weak=gw, gate_strong=gs)
    for i in range(len(rd)):
        bs, hs = _binom_pair(int(rd[i]), int(strong[i]), int(weak[i]),
                             mq, hez, AF, MT, gate_weak=int(gw[i]),
                             gate_strong=int(gs[i]))
        assert b[i] == bs and h[i] == hs


def test_score_ins_matches_scalar(tables):
    """score_ins vs the reference's soft-clip INS formulas
    (src/GROM.c:11750-11960) evaluated per position."""
    mq, _ = tables
    rng = np.random.default_rng(17)
    n = 3000
    rd = rng.integers(0, MT, n).astype(np.int64)
    sc_rd = rng.integers(0, 5, n).astype(np.int64)
    scl = rng.integers(0, AF * 6, n).astype(np.int64)
    scr = rng.integers(0, AF * 6, n).astype(np.int64)
    scl_rd = rng.integers(0, MT, n).astype(np.int64)
    scr_rd = rng.integers(0, MT, n).astype(np.int64)
    ins = rng.integers(0, AF * 4, n).astype(np.int64)
    mf = rng.integers(0, AF * 3, n).astype(np.int64)
    mr = rng.integers(0, AF * 3, n).astype(np.int64)
    md, p1 = 2, 0.6
    ok_l, b_l, ok_r, b_r = score_ins(np, rd, sc_rd, scl, scr, scl_rd,
                                     scr_rd, ins, mf, mr, mq, AF, MT, md, p1)
    for i in range(n):
        if rd[i] + sc_rd[i] > 0:
            nl = int(rd[i] + scl_rd[i])
            exp_l = False
            if (scl[i] + ins[i]) // AF >= md and nl <= MT:
                k = int(mr[i] + scl[i] + ins[i]) // AF
                bb = mq[nl][k] if k < nl else mq[nl][nl]
                exp_l = bb <= p1
                if exp_l:
                    assert b_l[i] == bb
            assert bool(ok_l[i]) == exp_l, i
            nr = int(rd[i] + scr_rd[i])
            exp_r = False
            if (scr[i] + ins[i]) // AF >= md and nr <= MT:
                k = int(mf[i] + scr[i] + ins[i]) // AF
                bb = mq[nr][k] if k < nr else mq[nr][nr]
                exp_r = bb <= p1
                if exp_r:
                    assert b_r[i] == bb
            assert bool(ok_r[i]) == exp_r, i
        else:
            assert not ok_l[i] and not ok_r[i]


def test_score_entries_jnp_matches_numpy(tables):
    """The xp-generic core under jax.numpy (inside the x64 scope the device
    engines use) is bit-identical to the numpy host path."""
    import jax

    from grom_tpu.call.sv_screen import score_sv_entries
    mq, hez = tables
    rng = np.random.default_rng(19)
    n = 2000
    pos = np.sort(rng.integers(1000, 100000, n)).astype(np.int64)
    etype = rng.integers(1, 11, n).astype(np.int32)
    count = rng.integers(0, AF * 2 * MT, n).astype(np.int64)
    rs = pos - rng.integers(0, 400, n)
    re = pos - rng.integers(-100, 300, n)
    rd = rng.integers(0, 3 * MT, n).astype(np.int64)
    wf = rng.integers(0, AF * MT, n).astype(np.int64)
    wr = rng.integers(0, AF * MT, n).astype(np.int64)
    cfh = rng.integers(0, AF * MT, n).astype(np.int64)
    cfh[rng.random(n) < 0.5] = 0
    args = (pos, etype, count, rs, re, rd, wf, wr, cfh)
    kw = dict(af=AF, mt=MT, md=2, thr1=0.4, mean=300, lseq=100)
    k_np, a_np, b_np, h_np = score_sv_entries(np, *args, mq, hez, **kw)
    import jax.numpy as jnp
    with jax.enable_x64(True):
        out = score_sv_entries(jnp, *[jnp.asarray(a) for a in args],
                               jnp.asarray(mq), jnp.asarray(hez), **kw)
        k_j, a_j, b_j, h_j = (np.asarray(o) for o in out)
    assert (k_np == k_j).all()
    assert (a_np == a_j).all()
    assert (b_np == b_j).all() and (h_np == h_j).all()


def _f32_division_gate(w, s):
    """The reference's gate as IEEE float32 division, computed by numpy."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return (w.astype(np.float32) / s.astype(np.float32)) <= np.float32(0.25)


def test_f32_ratio_gate_matches_float32_division():
    """The exact int64 form of the evidence-ratio gate equals float32
    division on a full small grid (0/0 and w/0 included) and on seeded
    pairs at the 0.25 boundary up to 2^30."""
    from grom_tpu.call.sv_screen import _f32_ratio_gate
    g = np.arange(400, dtype=np.int64)
    w, s = (a.ravel() for a in np.meshgrid(g, g))
    assert np.array_equal(_f32_ratio_gate(np, w, s), _f32_division_gate(w, s))

    rng = np.random.default_rng(23)
    s = rng.integers(1, 1 << 30, 200_000, dtype=np.int64)
    # the exact quarter, and the float32 rounding threshold just above it
    w0 = np.concatenate([s // 4, s * ((1 << 24) + 1) >> 26])
    s = np.concatenate([s, s])
    for d in range(-3, 4):
        w = np.maximum(w0 + d, 0)
        got = _f32_ratio_gate(np, w, s)
        want = _f32_division_gate(w, s)
        assert np.array_equal(got, want), d
        assert got.any() and not got.all()


def test_f32_ratio_gate_jnp_needs_x64():
    """Under jax.numpy the gate agrees with numpy inside the x64 scope, and
    refuses 32-bit integers outside it rather than overflowing."""
    import jax
    import jax.numpy as jnp

    from grom_tpu.call.sv_screen import _f32_ratio_gate
    rng = np.random.default_rng(29)
    s = rng.integers(0, 1 << 30, 4096, dtype=np.int64)
    w = np.maximum(s // 4 + rng.integers(-2, 3, 4096), 0)
    with jax.enable_x64(True):
        got = np.asarray(_f32_ratio_gate(jnp, jnp.asarray(w), jnp.asarray(s)))
    assert np.array_equal(got, _f32_division_gate(w, s))
    with pytest.raises(TypeError, match="int64"):
        _f32_ratio_gate(jnp, jnp.asarray(w.astype(np.int32)),
                        jnp.asarray(s.astype(np.int32)))

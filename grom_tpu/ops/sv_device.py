"""Device (jax/XLA) SV screen scorer: runs sv_screen.score_sv_entries —
the batched binomial-table gathers + gates of the per-position SV detectors
(src/GROM.c:11750-13553) — under jit on the attached accelerator, padded to
pow2 buckets so recompiles stay bounded.

Exactness: the screen's probabilities are printed with %e in the VCF (PR
fields), so the scorer runs in float64 inside JAX's x64 scope
(``grom_tpu.ops.exact_f64``) and is bit-identical to the host numpy screen
(tests/test_sv_device.py). It is the default on the device engines;
``GROM_TPU_DEVICE_SV=1`` forces it on the host engine too, ``=0`` disables
it everywhere.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from grom_tpu.ops import exact_f64


def _pow2(n: int, floor: int = 1 << 10) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class DeviceSvScorer:
    """Callable drop-in for sv_screen.screen_window's ``scorer``: same
    signature and dtypes as the numpy default (a partial of
    score_sv_entries), but jitted on the default jax device."""

    @exact_f64
    def __init__(self, mq_tab: np.ndarray, hez_tab: np.ndarray, af: int,
                 mt: int, md: int, thr1: float, mean: int, lseq: int):
        import functools

        import jax
        import jax.numpy as jnp

        from grom_tpu.call.sv_screen import score_sv_entries
        self._jnp = jnp
        mq_d = jnp.asarray(mq_tab)
        hez_d = jnp.asarray(hez_tab)
        self._fn = jax.jit(functools.partial(
            score_sv_entries, jnp, mq_tab=mq_d, hez_tab=hez_d, af=af,
            mt=mt, md=md, thr1=thr1, mean=mean, lseq=lseq))

    @exact_f64
    def __call__(self, pos, etype, count, rs, re, rd, weak_f, weak_r,
                 ctx_f_here):
        n = len(pos)
        if n == 0:
            return (np.empty(0, np.int32), np.empty(0, bool),
                    np.empty(0), np.empty(0))
        p = _pow2(n)

        def pad(a):
            out = np.zeros(p, a.dtype)
            out[:n] = a
            return self._jnp.asarray(out)

        # zero pads are inert: etype 0 maps to kind -1 and rd 0 fails the
        # rd > 0 acceptance gate
        kind, acc, binom, hez = self._fn(
            pad(pos), pad(etype), pad(count), pad(rs), pad(re), pad(rd),
            pad(weak_f), pad(weak_r), pad(ctx_f_here))
        return (np.asarray(kind)[:n], np.asarray(acc)[:n],
                np.asarray(binom)[:n], np.asarray(hez)[:n])


_CACHE: dict = {}


def maybe_scorer(engine: Optional[str], mq_tab: np.ndarray,
                 hez_tab: np.ndarray, cfg, drv) -> Optional[DeviceSvScorer]:
    """The engine policy described in the module docstring. Scorers are
    memoized per parameter set (the tables are process-wide constants) so
    per-chromosome calls reuse one jit cache."""
    dc = os.environ.get("GROM_TPU_DEVICE_SV", "")
    if dc == "0":
        return None
    if dc != "1" and engine not in ("device", "mesh"):
        return None
    key = (cfg.add_factor, cfg.max_trials, cfg.min_disc,
           cfg.pval_threshold1, drv.insert_mean, drv.read_len)
    hit = _CACHE.get(key)
    # held table references make the identity check safe against id reuse
    if hit is not None and hit[0] is mq_tab and hit[1] is hez_tab:
        return hit[2]
    sc = DeviceSvScorer(mq_tab, hez_tab, cfg.add_factor, cfg.max_trials,
                        cfg.min_disc, cfg.pval_threshold1, drv.insert_mean,
                        drv.read_len)
    _CACHE.clear()
    _CACHE[key] = (mq_tab, hez_tab, sc)
    return sc

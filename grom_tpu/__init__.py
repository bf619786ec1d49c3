"""grom_tpu — an integrated germline variant caller on JAX/XLA.

Reimplements the capabilities of GROM (radygenomics/GROM: SNVs, small indels,
structural variants, CNVs and translocations from coordinate-sorted paired-end
BAMs) as an idiomatic JAX/XLA engine: host-side BAM→tensor ingest, vectorized
pileup/evidence kernels over device-resident genome tiles, and mesh-sharded
multi-device execution.
"""

def _tune_malloc() -> None:
    """Keep glibc from mmap()ing every large numpy buffer. The pileup path
    allocates/frees tens of ~50MB arrays per chromosome; with the default
    mmap threshold each one is a fresh anonymous mapping whose pages fault
    on first touch (and on some hosts that costs seconds per call). Raising
    M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the heap retain and reuse those
    pages. No-op off glibc."""
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        one_gib = 1 << 30
        libc.mallopt(M_MMAP_THRESHOLD, one_gib)
        libc.mallopt(M_TRIM_THRESHOLD, one_gib)
    except (OSError, AttributeError):
        pass


_tune_malloc()


class _Preheat:
    """Pre-import memory acquisition for expensive-fault kernels.

    On gVisor-class hosts both of these are painfully slow: importing
    numpy (~2.5-3s of stat storms) and first-touch memory acquisition
    (~1-10 s/GiB demand-faulted, vs ~0.3 s/GiB via MAP_POPULATE). This
    thread starts before ANY heavy import using only ctypes + libc and
    populates anonymous memory concurrently with the import chain:

      * the first ``adopt_target`` bytes are handed to the numpy slab
        pool (_hugealloc.adopt) once it installs — the pipeline's dense
        arrays then carve resident zeroed slabs instead of faulting;
      * the next ``prime_target`` bytes are populated and immediately
        munmapped — the host keeps just-freed pages in a fast recycle
        pool (measured ~0.45 s/GiB vs ~5 s/GiB cold), which accelerates
        every allocation the slab pool does NOT serve (glibc heap,
        python objects, inflate scratch).

    Skipped on normal kernels (fault probe < ~0.7 s/GiB) and via
    GROM_TPU_PREHEAT=0. GROM_TPU_PREHEAT=<bytes> overrides the adopt
    target."""

    PROT_RW = 0x3
    FLAGS_POP = 0x22 | 0x8000          # PRIVATE|ANON|POPULATE (x86-64)
    SLICE = 256 << 20

    def __init__(self):
        self.ranges = []               # populated, awaiting adoption
        self.installed = None          # threading.Event set by hugealloc
        self.thread = None

    def _fault_cost(self, libc, ctypes) -> float:
        """Demand-fault cost probe (s/GiB). 192MB sample: the host's fast
        page pool serves the first ~160MB cheaply even when the steady-state
        rate is ~5 s/GiB, so a small probe underestimates badly."""
        import time
        sz = 192 << 20
        p = libc.mmap(None, sz, self.PROT_RW, 0x22, -1, 0)
        if not p or p == ctypes.c_void_p(-1).value:
            return 0.0
        t0 = time.perf_counter()
        ctypes.memset(p, 0, sz)
        dt = time.perf_counter() - t0
        libc.munmap(ctypes.c_void_p(p), sz)
        return dt * 1024.0 / 192.0

    def start(self, spawn: bool = True):
        """Arm the preheat. With ``spawn`` the populate runs on its own
        daemon thread; otherwise the populate callable is returned for the
        caller to chain onto an existing worker (the early-ingest thread —
        inflate first, then populate, so they don't fight for the spare
        core). Returns None when preheat is disabled/not applicable."""
        import ctypes
        import os
        import sys
        import threading
        if not sys.platform.startswith("linux"):
            return None
        env = os.environ.get("GROM_TPU_PREHEAT", "")
        if env in ("", "0"):
            # OFF by default: the preheat thread's probe + populate
            # COMPETE with the pipeline's own allocations for the host's
            # page-supply rate. Opt in with =1/=<bytes> for cold
            # single-shot runs on idle wide hosts.
            return None
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            libc.mmap.restype = ctypes.c_void_p
            libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_long]
            libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        except (OSError, AttributeError):
            return None
        # acquire only what the pipeline actually carves (bench live_max
        # ~1.5GB): every EXTRA preheated byte competes with the pipeline's
        # own populate calls for the host's page-supply rate — on a
        # supply-constrained host an oversized preheat ADDS seconds
        # (measured: 2.75GB preheat vs 1.5GB demand cost ~10s of ingest
        # stall). The former 1GB populate+munmap "prime" tranche is gone
        # for the same reason.
        adopt_target = int(env) if env.isdigit() and int(env) > 1 \
            else (5 << 28)             # 1.25 GB
        prime_target = 0
        self.installed = threading.Event()

        def work():
            try:
                if self._fault_cost(libc, ctypes) < 0.4:
                    return             # normal kernel: populate ~= touch
                bad = ctypes.c_void_p(-1).value
                got = 0
                while got < adopt_target:
                    n = min(self.SLICE, adopt_target - got)
                    p = libc.mmap(None, n, self.PROT_RW, self.FLAGS_POP,
                                  -1, 0)
                    if not p or p == bad:
                        return
                    self.ranges.append((p, n))
                    got += n
                    self._drain()
                got = 0
                while got < prime_target:
                    n = min(self.SLICE, prime_target - got)
                    p = libc.mmap(None, n, self.PROT_RW, self.FLAGS_POP,
                                  -1, 0)
                    if not p or p == bad:
                        return
                    libc.munmap(ctypes.c_void_p(p), n)
                    got += n
            finally:
                self._drain(final=True)

        if not spawn:
            return work
        self.thread = threading.Thread(target=work, name="grom-preheat",
                                       daemon=True)
        self.thread.start()
        return None

    def _drain(self, final: bool = False) -> None:
        """Hand populated ranges to the slab pool (or release them when the
        pool never installed and this is the final drain)."""
        if self.installed is not None and self.installed.is_set():
            try:
                from grom_tpu import _hugealloc
                while self.ranges:
                    addr, size = self.ranges.pop()
                    _hugealloc.adopt(addr, size)
                return
            except Exception:
                pass
        if final and not (self.installed and self.installed.is_set()):
            import ctypes
            try:
                libc = ctypes.CDLL(None)
                libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
                while self.ranges:
                    addr, size = self.ranges.pop()
                    libc.munmap(ctypes.c_void_p(addr), size)
            except Exception:
                pass


def _start_background_warmup() -> None:
    """Start the pre-import background work: early BAM inflation (when this
    is a CLI run on a modest-size input) chained with the memory preheat.
    Both use only stdlib + ctypes, so they run while numpy/the compute
    stack are still importing."""
    import os
    import sys
    bam = None
    try:
        argv = sys.argv
        if "-i" in argv:
            cand = argv[argv.index("-i") + 1]
            if cand.endswith(".bam") and os.path.exists(cand):
                bam = cand
    except (ValueError, IndexError):
        bam = None
    # early ingest is opt-in: on 2-vCPU hosts the extra thread contends
    # with the import chain and the later 2-thread inflate is faster
    # (measured 13-17s vs 9-12s); on wider hosts it hides the whole
    # inflate behind the numpy import
    if bam is not None and os.environ.get("GROM_TPU_EARLY", "0") == "1":
        # the early-ingest buffers replace the pool's inflate buffer
        # (~0.7GB acquired during the import window) — shrink the preheat
        # accordingly; populate (sys-bound) runs concurrently with the
        # inflate (user-bound)
        os.environ.setdefault("GROM_TPU_PREHEAT", str(1 << 30))
        from grom_tpu import _earlyingest
        _earlyingest.start(bam)
    _PREHEAT.start()


_PREHEAT = _Preheat()
_start_background_warmup()


def _install_hugealloc() -> None:
    """Route large numpy allocations through the huge-page slab allocator
    (native/grom_hugealloc.c). On kernels where a first-touch page fault is
    expensive, 2 MiB-aligned MADV_HUGEPAGE mmaps and the allocator's
    warm-slab reuse keep memory allocation from dominating the pipeline.
    Disable with GROM_TPU_HUGEALLOC=0. The extension is built on demand
    (make -C native hugealloc)."""
    import os
    import sys
    if not sys.platform.startswith("linux"):
        return
    if os.environ.get("GROM_TPU_HUGEALLOC", "1") == "0":
        return
    try:
        from grom_tpu import _hugealloc
    except ImportError:
        import subprocess
        src_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "native")
        if not os.path.exists(os.path.join(src_dir, "grom_hugealloc.c")):
            return
        try:
            r = subprocess.run(["make", "-C", src_dir, "-s", "hugealloc"],
                               capture_output=True, timeout=120)
            if r.returncode != 0:
                return
            from grom_tpu import _hugealloc
        except Exception:
            return
    try:
        # pool cap: enough to keep a WGS-scale working set's slabs warm —
        # a cap far below live_max causes eviction churn (measured: a 250Mb
        # run with the old 6GB cap re-acquired 202GB of slabs). Half of
        # physical RAM, floor 6GB.
        cap = 6 << 30
        try:
            import os as _os
            pages = _os.sysconf("SC_PHYS_PAGES")
            psize = _os.sysconf("SC_PAGE_SIZE")
            cap = max(cap, pages * psize // 2)
        except (ValueError, OSError, AttributeError):
            pass
        # GROM_TPU_POOL_CAP overrides (bytes) — used by the WGS memory
        # tests to emulate a small-RAM host (peak RSS then reflects the
        # live working set, not warm-pool retention)
        cap_env = os.environ.get("GROM_TPU_POOL_CAP", "")
        if cap_env.isdigit():
            cap = int(cap_env)
        _hugealloc.install(pool_cap=cap)
        if _PREHEAT.installed is not None:
            _PREHEAT.installed.set()
            _PREHEAT._drain()
    except Exception:
        pass


_install_hugealloc()

from grom_tpu.config import DerivedConfig, GromConfig  # noqa: E402

__version__ = "0.1.0"

__all__ = ["GromConfig", "DerivedConfig", "__version__"]

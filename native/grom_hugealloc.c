/* grom_tpu._hugealloc — huge-page-backed numpy data allocator.
 *
 * Why this exists: on sandboxed kernels (gVisor-class) a first-touch
 * anonymous page fault costs tens of microseconds of sys time, which
 * makes fresh numpy buffer
 * allocation, not compute, the dominant cost of a vectorized genomics
 * pipeline (the per-chromosome arrays + decoded read tensors are GBs).
 * MADV_HUGEPAGE on a fresh anonymous mmap drops the cost ~20-35x (one fault
 * per 2 MiB instead of per 4 KiB), but glibc's brk heap cannot get THP under
 * these kernels, so routing numpy through malloc cannot be fixed with
 * mallopt alone.
 *
 * This module installs a PyDataMem_Handler (numpy >= 1.22) that serves
 * allocations >= threshold (default 1 MiB) from 2 MiB-rounded anonymous
 * mmaps madvised MADV_HUGEPAGE, and recycles freed slabs in a size-binned
 * free pool (capped, default 6 GiB) so repeated pipeline phases reuse warm
 * pages instead of re-faulting. Small allocations pass through to malloc.
 *
 * The reference implementation has no analogue (its C design streams through
 * a fixed 10 MB ring, src/GROM.c:67-102, and never materializes large
 * buffers); this is the framework's equivalent piece of runtime: a host
 * allocator tuned for the kernel it runs on.
 *
 * Build: cc -O2 -shared -fPIC -I<python-inc> -I<numpy-inc> \
 *           grom_hugealloc.c -o grom_tpu/_hugealloc.so
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

#define SLAB_ALIGN (2UL << 20)          /* 2 MiB: THP granularity */
#define MAX_FREE 256                    /* free-list entries */

typedef struct {
    void *ptr;
    size_t size;                        /* 2 MiB multiple */
    int clean;                          /* never written since mmap */
} slab_t;

static struct {
    pthread_mutex_t lock;
    slab_t freelist[MAX_FREE];
    int nfree;
    size_t pooled;                      /* bytes parked in the pool */
    size_t pool_cap;
    size_t threshold;
    size_t mlock_cap;                   /* 0 = no mlock */
    size_t mlocked;
    /* counters (exposed via stats()) */
    size_t n_mmap, n_reuse, n_evict, live, live_max, mapped_max, acquired;
} G = {PTHREAD_MUTEX_INITIALIZER, {{0}}, 0, 0, 6UL << 30, 1UL << 20,
       0, 0, 0, 0, 0, 0, 0, 0, 0};

static size_t round_slab(size_t sz) {
    /* Coarse size classes for large slabs: repeated allocations that grow
     * slightly (e.g. per-chunk decode buffers as read density varies)
     * land in the same class and reuse the same pooled slab instead of
     * forcing a fresh acquisition each time. Waste is bounded at ~12%
     * and exists only for the largest live slab of each class. */
    size_t a = SLAB_ALIGN;
    if (sz >= (256UL << 20))
        a = 64UL << 20;
    else if (sz >= (64UL << 20))
        a = 32UL << 20;
    else if (sz >= (8UL << 20))
        a = 8UL << 20;
    return (sz + a - 1) & ~(a - 1);
}

static void slab_unmap(void *ptr, size_t size) {
    /* mlock accounting is approximate (slabs split; locked state is not
     * tracked per-slab): assume evicted slabs were locked. Errs toward
     * under-pinning, never over. */
    munmap(ptr, size);
    size_t old, want;
    do {
        old = G.mlocked;
        want = old > size ? old - size : 0;
    } while (!__sync_bool_compare_and_swap(&G.mlocked, old, want));
}

/* ---- slab pool ----------------------------------------------------
 *
 * A flat free list with best-fit + SPLIT: a request is served from the
 * smallest free slab >= its size, the remainder re-parked as its own free
 * slab. On the sandboxed kernels this allocator targets, memory the
 * process has touched ONCE is cheap to fault again even across
 * munmap/mmap — but fresh memory is ~50us/page — so keeping acquired
 * ranges mapped in the pool (instead of returning them to the OS) is the
 * entire performance model. Split remainders are never re-coalesced; for
 * a bounded pipeline run fragmentation is capped by MAX_FREE and the
 * pool_cap eviction below. */

static void *pool_get(size_t rounded, int *clean) {
    void *p = NULL;
    pthread_mutex_lock(&G.lock);
    int best = -1;
    for (int i = 0; i < G.nfree; i++) {
        if (G.freelist[i].size >= rounded
            && (best < 0 || G.freelist[i].size < G.freelist[best].size))
            best = i;
    }
    if (best >= 0) {
        slab_t s = G.freelist[best];
        p = s.ptr;
        *clean = s.clean;
        if (s.size > rounded) {         /* split: re-park the tail (the
                                         * coalescing pool_put below
                                         * re-merges it on free) */
            G.freelist[best].ptr = (char *)s.ptr + rounded;
            G.freelist[best].size = s.size - rounded;
            G.freelist[best].clean = s.clean;
        } else {
            G.freelist[best] = G.freelist[--G.nfree];
        }
        G.pooled -= rounded;
        G.n_reuse++;
    }
    pthread_mutex_unlock(&G.lock);
    return p;
}

static void pool_put(void *ptr, size_t rounded) {
    pthread_mutex_lock(&G.lock);
    if (G.nfree < MAX_FREE && G.pooled + rounded <= G.pool_cap) {
        /* Coalesce with address-adjacent free slabs (both sides): splits
         * fragment large slabs, and without re-merge the pool decays until
         * no entry can serve a chunk-sized request and every streamed
         * chunk re-acquires fresh pages (~5s/GiB of sys on sandboxed
         * kernels). Merged spans restore the big slabs each chunk needs. */
        for (int again = 1; again;) {
            again = 0;
            for (int i = 0; i < G.nfree; i++) {
                char *fp = (char *)G.freelist[i].ptr;
                if (fp + G.freelist[i].size == (char *)ptr) {
                    ptr = fp;
                    rounded += G.freelist[i].size;
                    G.pooled -= G.freelist[i].size;
                    G.freelist[i] = G.freelist[--G.nfree];
                    again = 1;
                    break;
                }
                if ((char *)ptr + rounded == fp) {
                    rounded += G.freelist[i].size;
                    G.pooled -= G.freelist[i].size;
                    G.freelist[i] = G.freelist[--G.nfree];
                    again = 1;
                    break;
                }
            }
        }
        G.freelist[G.nfree].ptr = ptr;
        G.freelist[G.nfree].size = rounded;
        G.freelist[G.nfree].clean = 0;
        G.nfree++;
        G.pooled += rounded;
        ptr = NULL;
    } else {
        G.n_evict++;
    }
    pthread_mutex_unlock(&G.lock);
    if (ptr)
        slab_unmap(ptr, rounded);
}

static void *slab_mmap(size_t rounded) {
    /* MAP_POPULATE: on the sandboxed kernels this allocator targets,
     * eager population costs ~0.27 s/GiB while demand faulting costs
     * ~4 s/GiB (memset) / ~1.2 s/GiB (per-page touch) — measured; the
     * sentry batches the whole range's acquisition in one syscall. On
     * normal kernels populate just prefaults pages the caller was about
     * to touch anyway (slabs are allocated at the array's size and fully
     * used). Fall back to lazy faulting if POPULATE is refused.
     *
     * Over-map by one slab and trim to a 2 MiB-aligned base: THP only
     * backs 2 MiB-aligned ranges with huge pages — an unaligned or
     * VMA-merged range quietly faults 4 KiB pages. (On kernels that
     * ignore MADV_HUGEPAGE the alignment is harmless.) The aligned
     * region is re-mapped with POPULATE rather than trimmed so the
     * eager acquisition covers exactly the kept range. */
    char *raw = mmap(NULL, rounded + SLAB_ALIGN, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (raw == MAP_FAILED)
        return NULL;
    char *base = (char *)(((uintptr_t)raw + SLAB_ALIGN - 1)
                          & ~(uintptr_t)(SLAB_ALIGN - 1));
    char *pop = mmap(base, rounded, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_FIXED | MAP_POPULATE,
                     -1, 0);
    if (pop != MAP_FAILED)
        base = pop;
    size_t head = (size_t)(base - raw);
    if (head)
        munmap(raw, head);
    if (SLAB_ALIGN - head)
        munmap(base + rounded, SLAB_ALIGN - head);
    (void)madvise(base, rounded, MADV_HUGEPAGE);
    /* Pin when permitted (CAP_IPC_LOCK): hosts running proactive reclaim
     * (e.g. DAMON pageout) evict this process's idle pages between
     * pipeline phases, and re-faulting them costs ~50us/page of sys time
     * — pinning keeps warm slabs warm. mlock also populates the range, so
     * the first-touch cost moves here (same total, paid once). Bounded by
     * mlock_cap (default half of physical RAM, set in install()). */
    size_t ml = __sync_add_and_fetch(&G.mlocked, rounded);
    if (G.mlock_cap && ml <= G.mlock_cap) {
        if (mlock(base, rounded) != 0)
            __sync_fetch_and_sub(&G.mlocked, rounded);
    } else {
        __sync_fetch_and_sub(&G.mlocked, rounded);
    }
    __sync_fetch_and_add(&G.n_mmap, 1);
    __sync_fetch_and_add(&G.acquired, rounded);
    return base;
}

static void *slab_alloc(size_t rounded, int want_zero) {
    int clean = 0;
    void *p = pool_get(rounded, &clean);
    if (p == NULL) {
        p = slab_mmap(rounded);
        if (p == NULL)
            return NULL;
        clean = 1;
    }
    if (want_zero && !clean)
        memset(p, 0, rounded);          /* warm pages: ~0.1 s/GiB */
    size_t lv = __sync_add_and_fetch(&G.live, rounded);
    if (lv > G.live_max)
        G.live_max = lv;                /* racy high-water: fine for stats */
    if (lv + G.pooled > G.mapped_max)
        G.mapped_max = lv + G.pooled;
    return p;
}

static void slab_free(void *ptr, size_t rounded) {
    __sync_fetch_and_sub(&G.live, rounded);
    pool_put(ptr, rounded);
}

/* ---- PyDataMem_Handler callbacks ---------------------------------- */

static void *ga_malloc(void *ctx, size_t sz) {
    (void)ctx;
    if (sz >= G.threshold)
        return slab_alloc(round_slab(sz), 0);
    return malloc(sz ? sz : 1);
}

static void *ga_calloc(void *ctx, size_t nelem, size_t elsize) {
    (void)ctx;
    size_t sz = nelem * elsize;
    if (elsize && sz / elsize != nelem)
        return NULL;
    if (sz >= G.threshold)
        return slab_alloc(round_slab(sz), 1);
    return calloc(nelem ? nelem : 1, elsize ? elsize : 1);
}

static void ga_free(void *ctx, void *ptr, size_t sz) {
    (void)ctx;
    if (ptr == NULL)
        return;
    if (sz >= G.threshold)
        slab_free(ptr, round_slab(sz));
    else
        free(ptr);
}

static void *ga_realloc(void *ctx, void *ptr, size_t new_sz) {
    (void)ctx;
    if (ptr == NULL)
        return ga_malloc(ctx, new_sz);
    /* numpy's realloc path (resize) is rare and does not pass the old
     * size, so large blocks carry it in a header-free side map — instead
     * of tracking, we conservatively treat every realloc'd block as
     * malloc-owned. To keep that invariant, ga_malloc must never be
     * followed by realloc on the same pointer for large blocks: numpy
     * only calls realloc from PyArray_Resize, which our pipeline never
     * uses on pooled arrays. Small blocks: plain realloc. Large: without
     * the old size we cannot copy safely, so refuse growth into the pool
     * and fall back to realloc (the block was malloc'd only if it was
     * small; a large pooled block reaching here is a usage error). */
    return realloc(ptr, new_sz ? new_sz : 1);
}

/* ---- module ------------------------------------------------------- */

static PyDataMem_Handler ga_handler = {
    "grom_hugealloc",
    1,
    {
        NULL,                           /* ctx */
        ga_malloc,
        ga_calloc,
        ga_realloc,
        ga_free,
    },
};

static PyObject *prev_handler = NULL;

static PyObject *py_install(PyObject *self, PyObject *args, PyObject *kw) {
    static char *kwlist[] = {"threshold", "pool_cap", "mlock_cap", NULL};
    Py_ssize_t threshold = -1, pool_cap = -1, mlock_cap = -1;
    (void)self;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "|nnn", kwlist, &threshold,
                                     &pool_cap, &mlock_cap))
        return NULL;
    if (threshold > 0)
        G.threshold = (size_t)threshold;
    if (pool_cap > 0)
        G.pool_cap = (size_t)pool_cap;
    if (mlock_cap >= 0) {
        G.mlock_cap = (size_t)mlock_cap;
    } else if (G.mlock_cap == 0) {
        /* default: half of physical RAM (mlock attempts silently stop
         * there; mlock failures are ignored — unprivileged processes just
         * run unpinned) */
        long pages = sysconf(_SC_PHYS_PAGES);
        long psize = sysconf(_SC_PAGE_SIZE);
        if (pages > 0 && psize > 0)
            G.mlock_cap = ((size_t)pages * (size_t)psize) / 2;
    }
    if (prev_handler == NULL) {
        PyObject *cap = PyCapsule_New(&ga_handler, "mem_handler", NULL);
        if (cap == NULL)
            return NULL;
        prev_handler = PyDataMem_SetHandler(cap);
        Py_DECREF(cap);
        if (prev_handler == NULL)
            return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *py_uninstall(PyObject *self, PyObject *args) {
    (void)self; (void)args;
    if (prev_handler != NULL) {
        PyObject *mine = PyDataMem_SetHandler(prev_handler);
        Py_XDECREF(mine);
        Py_CLEAR(prev_handler);
    }
    Py_RETURN_NONE;
}

static PyObject *py_stats(PyObject *self, PyObject *args) {
    (void)self; (void)args;
    return Py_BuildValue("{s:n,s:n,s:n,s:n,s:n,s:n,s:n,s:n,s:n}",
                         "acquired", (Py_ssize_t)G.acquired,
                         "n_mmap", (Py_ssize_t)G.n_mmap,
                         "n_reuse", (Py_ssize_t)G.n_reuse,
                         "n_evict", (Py_ssize_t)G.n_evict,
                         "pooled", (Py_ssize_t)G.pooled,
                         "live", (Py_ssize_t)G.live,
                         "live_max", (Py_ssize_t)G.live_max,
                         "mapped_max", (Py_ssize_t)G.mapped_max,
                         "pool_cap", (Py_ssize_t)G.pool_cap);
}

static PyObject *py_reserve(PyObject *self, PyObject *args) {
    /* reserve(nbytes, chunk=64MiB): acquire nbytes of touched memory into
     * the pool. Run from a background thread (the touch releases the GIL)
     * to pre-pay the kernel's first-touch cost ahead of the pipeline's
     * allocations, which then carve warm slabs from the pool. */
    Py_ssize_t nbytes, chunk = 64 << 20;
    (void)self;
    if (!PyArg_ParseTuple(args, "n|n", &nbytes, &chunk))
        return NULL;
    /* always FRESH memory (never pool_get — reserving recycled slabs
     * would acquire nothing), acquired eagerly by slab_mmap's
     * MAP_POPULATE (GIL released — the populate is the expensive part),
     * then parked in the pool. Pages arrive zeroed and resident; no
     * touch pass is needed. */
    size_t sz = round_slab((size_t)nbytes);
    (void)chunk;
    char *p = NULL;
    Py_BEGIN_ALLOW_THREADS
    while (sz >= SLAB_ALIGN && (p = slab_mmap(sz)) == NULL)
        sz /= 2;
    Py_END_ALLOW_THREADS
    if (p == NULL)
        return PyLong_FromSize_t(0);
    __sync_fetch_and_add(&G.live, sz);
    slab_free(p, sz);
    return PyLong_FromSize_t(sz);
}

static PyObject *py_adopt(PyObject *self, PyObject *args) {
    /* adopt(addr, size): take ownership of an externally mmap'd anonymous
     * range (e.g. the pre-import preheat thread's MAP_POPULATE slices —
     * populated before numpy/this module could even be imported) and park
     * it in the pool as a clean (zeroed, resident) slab. The range must be
     * page-aligned private anonymous memory; it is trimmed to 2 MiB
     * alignment. Returns the number of bytes adopted (0 if rejected). */
    Py_ssize_t addr, size;
    (void)self;
    if (!PyArg_ParseTuple(args, "nn", &addr, &size))
        return NULL;
    uintptr_t base = ((uintptr_t)addr + SLAB_ALIGN - 1)
                     & ~(uintptr_t)(SLAB_ALIGN - 1);
    size_t head = base - (uintptr_t)addr;
    if ((size_t)size <= head + SLAB_ALIGN)
        return PyLong_FromSize_t(0);
    size_t sz = ((size_t)size - head) & ~(SLAB_ALIGN - 1);
    if (head)
        munmap((void *)addr, head);
    if ((size_t)size - head - sz)
        munmap((char *)base + sz, (size_t)size - head - sz);
    pthread_mutex_lock(&G.lock);
    int ok = (G.nfree < MAX_FREE && G.pooled + sz <= G.pool_cap);
    if (ok) {
        G.freelist[G.nfree].ptr = (void *)base;
        G.freelist[G.nfree].size = sz;
        G.freelist[G.nfree].clean = 1;
        G.nfree++;
        G.pooled += sz;
        G.acquired += sz;
    }
    pthread_mutex_unlock(&G.lock);
    if (!ok) {
        munmap((void *)base, sz);
        return PyLong_FromSize_t(0);
    }
    return PyLong_FromSize_t(sz);
}

static PyObject *py_trim(PyObject *self, PyObject *args) {
    (void)self; (void)args;
    pthread_mutex_lock(&G.lock);
    for (int i = 0; i < G.nfree; i++) {
        slab_unmap(G.freelist[i].ptr, G.freelist[i].size);
        G.pooled -= G.freelist[i].size;
    }
    G.nfree = 0;
    pthread_mutex_unlock(&G.lock);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"install", (PyCFunction)py_install, METH_VARARGS | METH_KEYWORDS,
     "install(threshold=1MiB, pool_cap=6GiB): route numpy allocations >= "
     "threshold through the huge-page slab pool."},
    {"uninstall", py_uninstall, METH_NOARGS,
     "restore the previous numpy allocator (new arrays only)."},
    {"stats", py_stats, METH_NOARGS, "allocator counters."},
    {"reserve", py_reserve, METH_VARARGS,
     "reserve(nbytes, chunk=64MiB): pre-acquire touched memory into the "
     "pool (run from a background thread; the touch releases the GIL)."},
    {"adopt", py_adopt, METH_VARARGS,
     "adopt(addr, size): park an external anonymous mmap range in the pool "
     "as a clean resident slab."},
    {"trim", py_trim, METH_NOARGS, "munmap every pooled free slab."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hugealloc",
    "huge-page-backed numpy data allocator (see source header)",
    -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__hugealloc(void) {
    import_array();
    return PyModule_Create(&moduledef);
}

/* grom_tpu native ingest kernels.
 *
 * The reference links vendored htslib for BGZF/BAM IO (src/GROM.c:26-27 and
 * src/sam.c); this is our independent equivalent: a multithreaded
 * BGZF inflater and a two-pass BAM record decoder that fills caller-allocated
 * struct-of-arrays buffers (numpy arrays on the Python side, via ctypes).
 *
 * Build: make -C native   (cc -O3 -shared -fPIC ... -lz -lpthread)
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>
#ifdef GN_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

#define GN_API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* BGZF                                                               */
/* ------------------------------------------------------------------ */

/* Scan BGZF block headers. Fills coff[i] (compressed offset) and
 * usize[i] (uncompressed size) for up to cap blocks. Returns the block
 * count, or -1 on malformed input, or -2 if cap is too small. */
GN_API long gn_bgzf_scan(const uint8_t *src, long srclen,
                         long *coff, long *usize, long cap) {
    long off = 0, n = 0;
    while (off + 18 <= srclen) {
        if (src[off] != 0x1f || src[off + 1] != 0x8b)
            return -1;
        unsigned xlen = (unsigned)src[off + 10] | ((unsigned)src[off + 11] << 8);
        if (off + 12 + (long)xlen > srclen)
            return -1;
        long bsize = -1;
        const uint8_t *extra = src + off + 12;
        unsigned eo = 0;
        while (eo + 4 <= xlen) {
            unsigned si1 = extra[eo], si2 = extra[eo + 1];
            unsigned slen = (unsigned)extra[eo + 2] | ((unsigned)extra[eo + 3] << 8);
            if (si1 == 66 && si2 == 67 && slen == 2) {
                bsize = ((long)extra[eo + 4] | ((long)extra[eo + 5] << 8)) + 1;
                break;
            }
            eo += 4 + slen;
        }
        if (bsize < 0 || off + bsize > srclen)
            return -1;
        uint32_t isize;
        memcpy(&isize, src + off + bsize - 4, 4);
        if (n >= cap)
            return -2;
        coff[n] = off;
        usize[n] = (long)isize;
        n++;
        off += bsize;
    }
    return (off == srclen) ? n : -1;
}

typedef struct {
    const uint8_t *src;
    const long *coff;
    const long *uoff;   /* prefix sums of usize, length nblocks+1 */
    long nblocks;
    uint8_t *dst;
    long lo, hi;        /* block range for this worker */
    int rc;
#ifdef GN_HAVE_LIBDEFLATE
    struct libdeflate_decompressor *ld;  /* per-worker; no fallback sharing */
#endif
} inflate_job_t;

/* Raw-DEFLATE a single BGZF block payload into dst. When built with
 * libdeflate (GN_HAVE_LIBDEFLATE, detected by the Makefile) each worker
 * owns one reusable decompressor — ~2-3x the zlib inflate throughput on
 * BGZF-sized blocks, the same speedup htslib takes when libdeflate is
 * present. zlib remains the portable fallback. */
static int inflate_one(const uint8_t *src, long coff, uint8_t *dst, long dcap,
                       void *ctx) {
    unsigned xlen = (unsigned)src[coff + 10] | ((unsigned)src[coff + 11] << 8);
    const uint8_t *cdata = src + coff + 12 + xlen;
    /* compressed payload runs to bsize-12-xlen-8; recompute bsize from BC */
    const uint8_t *extra = src + coff + 12;
    long bsize = -1;
    unsigned eo = 0;
    while (eo + 4 <= xlen) {
        unsigned slen = (unsigned)extra[eo + 2] | ((unsigned)extra[eo + 3] << 8);
        if (extra[eo] == 66 && extra[eo + 1] == 67 && slen == 2) {
            bsize = ((long)extra[eo + 4] | ((long)extra[eo + 5] << 8)) + 1;
            break;
        }
        eo += 4 + slen;
    }
    if (bsize < 0)
        return -1;
    long clen = bsize - 12 - (long)xlen - 8;
    if (dcap == 0)
        return 0;
#ifdef GN_HAVE_LIBDEFLATE
    if (ctx) {
        size_t got = 0;
        enum libdeflate_result lr = libdeflate_deflate_decompress(
            (struct libdeflate_decompressor *)ctx, cdata, (size_t)clen,
            dst, (size_t)dcap, &got);
        if (lr != LIBDEFLATE_SUCCESS || (long)got != dcap)
            return -3;
        return 0;
    }
#else
    (void)ctx;
#endif
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK)
        return -2;
    zs.next_in = (uint8_t *)cdata;
    zs.avail_in = (uInt)clen;
    zs.next_out = dst;
    zs.avail_out = (uInt)dcap;
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END || (long)zs.total_out != dcap)
        return -3;
    return 0;
}

static void *inflate_worker(void *arg) {
    inflate_job_t *j = (inflate_job_t *)arg;
    void *ctx = NULL;
#ifdef GN_HAVE_LIBDEFLATE
    j->ld = libdeflate_alloc_decompressor();
    ctx = j->ld;
#endif
    for (long b = j->lo; b < j->hi; b++) {
        int rc = inflate_one(j->src, j->coff[b], j->dst + j->uoff[b],
                             j->uoff[b + 1] - j->uoff[b], ctx);
        if (rc != 0) {
            j->rc = rc;
            goto done;
        }
    }
    j->rc = 0;
done:
#ifdef GN_HAVE_LIBDEFLATE
    if (j->ld) {
        libdeflate_free_decompressor(j->ld);
        j->ld = NULL;
    }
#endif
    return NULL;
}

/* Inflate all blocks in parallel. uoff has nblocks+1 entries (prefix sums).
 * Returns 0 on success. */
GN_API int gn_bgzf_inflate(const uint8_t *src, long srclen,
                           const long *coff, const long *uoff, long nblocks,
                           uint8_t *dst, int nthreads) {
    (void)srclen;
    if (nthreads < 1)
        nthreads = 1;
    if (nthreads > 64)
        nthreads = 64;
    if (nthreads > nblocks)
        nthreads = nblocks > 0 ? (int)nblocks : 1;
    pthread_t tids[64];
    inflate_job_t jobs[64];
    long per = (nblocks + nthreads - 1) / nthreads;
    int started = 0;
    for (int t = 0; t < nthreads; t++) {
        jobs[t].src = src;
        jobs[t].coff = coff;
        jobs[t].uoff = uoff;
        jobs[t].nblocks = nblocks;
        jobs[t].dst = dst;
        jobs[t].lo = t * per;
        jobs[t].hi = (t + 1) * per < nblocks ? (t + 1) * per : nblocks;
        jobs[t].rc = 0;
        if (jobs[t].lo >= jobs[t].hi)
            break;
        if (pthread_create(&tids[t], NULL, inflate_worker, &jobs[t]) != 0) {
            /* fall back to inline execution of this shard */
            inflate_worker(&jobs[t]);
            tids[t] = 0;
        }
        started++;
    }
    int rc = 0;
    for (int t = 0; t < started; t++) {
        if (tids[t])
            pthread_join(tids[t], NULL);
        if (jobs[t].rc != 0)
            rc = jobs[t].rc;
    }
    return rc;
}

/* ------------------------------------------------------------------ */
/* BAM records                                                        */
/* ------------------------------------------------------------------ */

static const char NT16[16] = "=ACMGRSVTWYHKDBN";

static inline int32_t rd_i32(const uint8_t *p) {
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline uint32_t rd_u32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline uint16_t rd_u16(const uint8_t *p) {
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
}

/* Find the SA:Z / XP:Z payload inside one record's aux block.
 * XP is preferred over SA (src/GROM.c:5757-5824). Returns payload length
 * and sets *out, or -1 if absent. */
static long find_sa(const uint8_t *aux, long n, const uint8_t **out) {
    const uint8_t *sa = NULL, *xp = NULL;
    long sal = 0, xpl = 0;
    long i = 0;
    while (i + 3 <= n) {
        uint8_t t0 = aux[i], t1 = aux[i + 1], typ = aux[i + 2];
        i += 3;
        switch (typ) {
        case 'A': case 'c': case 'C':
            i += 1;
            break;
        case 's': case 'S':
            i += 2;
            break;
        case 'i': case 'I': case 'f':
            i += 4;
            break;
        case 'Z': case 'H': {
            long j = i;
            while (j < n && aux[j] != 0)
                j++;
            if (t0 == 'S' && t1 == 'A') {
                sa = aux + i;
                sal = j - i;
            } else if (t0 == 'X' && t1 == 'P') {
                xp = aux + i;
                xpl = j - i;
            }
            i = j + 1;
            break;
        }
        case 'B': {
            if (i + 5 > n)
                return xp ? (*out = xp, xpl) : (sa ? (*out = sa, sal) : -1);
            uint8_t sub = aux[i];
            uint32_t cnt = rd_u32(aux + i + 1);
            long size = (sub == 'c' || sub == 'C') ? 1
                      : (sub == 's' || sub == 'S') ? 2 : 4;
            i += 5 + (long)cnt * size;
            break;
        }
        default:
            goto done;
        }
    }
done:
    if (xp) {
        *out = xp;
        return xpl;
    }
    if (sa) {
        *out = sa;
        return sal;
    }
    return -1;
}

/* Pass 1: count records and payload totals in data[start:end).
 * totals[0]=cigar ops, [1]=seq bases, [2]=name bytes (incl NUL),
 * [3]=SA payload bytes. Returns record count or -1 on truncation. */
GN_API long gn_bam_count(const uint8_t *data, long start, long end,
                         long *totals, int want_sa) {
    long off = start, R = 0;
    long tc = 0, ts = 0, tn = 0, tsa = 0;
    while (off + 4 <= end) {
        uint32_t bs = rd_u32(data + off);
        if (off + 4 + (long)bs > end)
            break;
        const uint8_t *r = data + off + 4;
        uint8_t lrn = r[8];
        uint16_t nc = rd_u16(r + 12);
        int32_t ls = rd_i32(r + 16);
        tc += nc;
        ts += ls;
        tn += lrn;
        if (want_sa) {
            long p = 32 + lrn + 4L * nc + (ls + 1) / 2 + ls;
            if (p < (long)bs) {
                const uint8_t *payload;
                long pl = find_sa(r + p, (long)bs - p, &payload);
                if (pl >= 0)
                    tsa += pl;
            }
        }
        R++;
        off += 4 + bs;
    }
    totals[0] = tc;
    totals[1] = ts;
    totals[2] = tn;
    totals[3] = tsa;
    return R;
}

/* ------------------------------------------------------------------ */
/* Broken-comparator merge sort (CNV copy-number ratios)              */
/* ------------------------------------------------------------------ */

/* The reference qsorts double arrays with an INT comparator
 * (src/GROM.c:20164 + :1105): it reads the low 32 bits of each double and
 * subtracts with int32 wraparound — non-transitive, so the output
 * permutation is whatever glibc's top-down merge produces. This emulates
 * that exact merge (same split n1 = n/2, same tie rule) over index arrays.
 * key[i] = low 32 bits of the double; idx in/out = permutation. */
static void broken_msort(const int32_t *key, long *idx, long *tmp,
                         long lo, long n) {
    if (n <= 1)
        return;
    long n1 = n / 2, n2 = n - n1;
    broken_msort(key, idx, tmp, lo, n1);
    broken_msort(key, idx, tmp, lo + n1, n2);
    long i = 0, j = 0, k = 0;
    long *a = idx + lo, *b = idx + lo + n1;
    while (i < n1 && j < n2) {
        int32_t d = (int32_t)((uint32_t)key[b[j]] - (uint32_t)key[a[i]]);
        tmp[k++] = (d < 0) ? b[j++] : a[i++];
    }
    while (i < n1)
        tmp[k++] = a[i++];
    while (j < n2)
        tmp[k++] = b[j++];
    memcpy(idx + lo, tmp, (size_t)n * sizeof(long));
}

GN_API void gn_broken_sort(const int32_t *key, long n, long *idx_out) {
    for (long i = 0; i < n; i++)
        idx_out[i] = i;
    if (n <= 1)
        return;
    long *tmp = (long *)malloc((size_t)n * sizeof(long));
    if (!tmp) {
        return; /* identity permutation; caller's fallback re-sorts */
    }
    broken_msort(key, idx_out, tmp, 0, n);
    free(tmp);
}

/* Pass 1b (preferred over count+fill): per-record byte offsets and payload
 * sizes in one walk. rec_off needs R+1 entries (rec_off[R] = end offset);
 * nc/ls/lrn/sa_len need R. sa_len[i] = -1 when absent (or want_sa == 0).
 * Returns the record count, -1 on malformed input, -2 when cap is too
 * small (caller re-sizes and retries). */
GN_API long gn_bam_offsets(const uint8_t *data, long start, long end,
                           int64_t *rec_off, int32_t *nc_out, int32_t *ls_out,
                           uint8_t *lrn_out, int32_t *sa_len_out, int want_sa,
                           long cap) {
    long off = start, R = 0;
    while (off + 4 <= end) {
        uint32_t bs = rd_u32(data + off);
        if (off + 4 + (long)bs > end)
            break;
        if (R >= cap)
            return -2;
        const uint8_t *r = data + off + 4;
        uint8_t lrn = r[8];
        uint16_t nc = rd_u16(r + 12);
        int32_t ls = rd_i32(r + 16);
        rec_off[R] = off;
        nc_out[R] = nc;
        ls_out[R] = ls;
        lrn_out[R] = lrn;
        sa_len_out[R] = -1;
        if (want_sa) {
            long p = 32 + lrn + 4L * nc + (ls + 1) / 2 + ls;
            if (p < (long)bs) {
                const uint8_t *payload;
                long pl = find_sa(r + p, (long)bs - p, &payload);
                if (pl >= 0)
                    sa_len_out[R] = (int32_t)pl;
            }
        }
        R++;
        off += 4 + bs;
    }
    rec_off[R] = off;
    return R;
}

/* ------------------------------------------------------------------ */
/* Batch building (cigar walk)                                        */
/* ------------------------------------------------------------------ */

/* Count M-spans (M/=/X ops) of kept reads — exact sizing for
 * gn_batch_build's span outputs. */
GN_API long gn_batch_count_spans(const uint32_t *cigar,
                                 const int64_t *cigar_off,
                                 const uint8_t *keep, long R) {
    long n = 0;
    for (long i = 0; i < R; i++) {
        if (!keep[i])
            continue;
        for (int64_t j = cigar_off[i]; j < cigar_off[i + 1]; j++) {
            uint32_t op = cigar[j] & 0xF;
            if (op == 0 || op == 7 || op == 8)
                n++;
        }
    }
    return n;
}

/* One-pass cigar walk replacing the vectorized numpy version in
 * ingest/batches.py (behavioral spec: the reference's per-read CIGAR
 * handling, src/GROM.c:7067-7105 clips, :7210-7421 indels, :6605-6664
 * M spans). Fills per-read clip/indel adjustments and the flat M-span
 * table (spans of kept reads only, record/cigar order). Returns the
 * span count written. */
GN_API long gn_batch_build(const uint32_t *cigar, const int64_t *cigar_off,
                           const int32_t *pos, const uint8_t *keep, long R,
                           int64_t *start_adj, int64_t *end_adj,
                           int64_t *end_adj_indel,
                           int32_t *span_read, int64_t *span_ref,
                           int64_t *span_readoff, int64_t *span_len,
                           uint8_t *has_ins) {
    long s = 0;
    for (long i = 0; i < R; i++) {
        int64_t lo = cigar_off[i], hi = cigar_off[i + 1];
        int64_t ref_off = 0, read_off = 0, eai = 0;
        int64_t sadj = 0, eadj = 0;
        int kp = keep[i];
        has_ins[i] = 0;
        for (int64_t j = lo; j < hi; j++) {
            uint32_t c = cigar[j];
            uint32_t op = c & 0xF;
            int64_t len = c >> 4;
            switch (op) {
            case 0: case 7: case 8:              /* M, =, X */
                if (kp) {
                    span_read[s] = (int32_t)i;
                    span_ref[s] = (int64_t)pos[i] + ref_off;
                    span_readoff[s] = read_off;
                    span_len[s] = len;
                    s++;
                }
                ref_off += len;
                read_off += len;
                break;
            case 1:                              /* I */
                read_off += len;
                eai += len;
                has_ins[i] = 1;
                break;
            case 2:                              /* D */
                ref_off += len;
                eai -= len;
                break;
            case 3:                              /* N */
                ref_off += len;
                break;
            case 4:                              /* S */
                read_off += len;
                if (j == lo)
                    sadj = len;
                if (j == hi - 1)
                    eadj = len;
                break;
            case 5:                              /* H */
                if (j == lo)
                    sadj = len;
                if (j == hi - 1)
                    eadj = len;
                break;
            default:
                break;                           /* P: consumes nothing */
            }
        }
        start_adj[i] = sadj;
        end_adj[i] = eadj;
        end_adj_indel[i] = eai;
    }
    return s;
}

/* Streaming insert-size sample collector (src/GROM.c:1205-1318 semantics).
 * Consumes records in data[start:end) in order, appending to the caller's
 * sample buffers until sample_cap. Per record (FUNMAP/FDUP excluded):
 * unpaired reads contribute lseq, paired reads contribute tlen when (mate
 * mapped, same tid, pos<mpos, proper pair, tlen>0). mapped_bases counts
 * lseq of usable mapq>=min_mapq records up to the sample-filling record
 * (or all records when the sample never fills) — the reference's
 * g_mapped_reads. State carried across windows via the io[] array:
 *   io[0]=n_samples io[1]=mapped_bases io[2]=pending_bases io[3]=done flag.
 * Returns the flat offset after the last complete record consumed. */
GN_API long gn_insert_scan(const uint8_t *data, long start, long end,
                           int32_t *inserts, int32_t *lseqs, long sample_cap,
                           int min_mapq, int64_t *io) {
    long off = start;
    long n = io[0];
    int64_t mapped = io[1], pending = io[2];
    while (off + 4 <= end) {
        uint32_t bs = rd_u32(data + off);
        if (off + 4 + (long)bs > end)
            break;
        const uint8_t *r = data + off + 4;
        off += 4 + bs;
        uint16_t flag = rd_u16(r + 14);
        int32_t ls = rd_i32(r + 16);
        int usable = !(flag & 0x4) && !(flag & 0x400);
        if (usable && r[9] >= min_mapq)
            pending += ls;
        if (n >= sample_cap)
            continue;
        int contributes = 0;
        int32_t ins = 0;
        if (usable && !(flag & 0x1)) {          /* unpaired */
            contributes = 1;
            ins = ls;
        } else if (usable && (flag & 0x1) && !(flag & 0x8)) {
            int32_t refid = rd_i32(r), mrefid = rd_i32(r + 20);
            int32_t pos = rd_i32(r + 4), mpos = rd_i32(r + 24);
            int32_t tlen = rd_i32(r + 28);
            if (refid == mrefid && pos < mpos && (flag & 0x2) && tlen > 0) {
                contributes = 1;
                ins = tlen;
            }
        }
        if (contributes) {
            inserts[n] = ins;
            lseqs[n] = ls;
            n++;
            mapped += pending;
            pending = 0;
            if (n >= sample_cap) {
                io[3] = 1;                       /* sample full: stop early */
                break;
            }
        }
    }
    io[0] = n;
    io[1] = mapped;
    io[2] = pending;
    return off;
}

/* Fixed-fields-only decode in ONE pass: fills refid/pos/mapq/flag/mrefid/
 * mpos/tlen/lseq and skips every ragged payload (cigar/seq/qual/names/aux).
 * This is the insert-size estimator's decode (src/GROM.c:1205-1318 streams
 * the same eight fields) at ~5x less memory traffic than a full decode.
 * Returns the record count, -1 on malformed input, -2 when cap is too
 * small (caller re-sizes and retries). */
GN_API long gn_bam_fixed(const uint8_t *data, long start, long end,
                         int32_t *refid, int32_t *pos, uint8_t *mapq,
                         uint16_t *flag, int32_t *mrefid, int32_t *mpos,
                         int32_t *tlen, int32_t *lseq, long cap) {
    long off = start, R = 0;
    while (off + 4 <= end) {
        uint32_t bs = rd_u32(data + off);
        if (off + 4 + (long)bs > end)
            break;
        if (R >= cap)
            return -2;
        const uint8_t *r = data + off + 4;
        refid[R] = rd_i32(r);
        pos[R] = rd_i32(r + 4);
        mapq[R] = r[9];
        flag[R] = rd_u16(r + 14);
        lseq[R] = rd_i32(r + 16);
        mrefid[R] = rd_i32(r + 20);
        mpos[R] = rd_i32(r + 24);
        tlen[R] = rd_i32(r + 28);
        R++;
        off += 4 + bs;
    }
    return R;
}

typedef struct {
    const uint8_t *data;
    const int64_t *rec_off;
    const int64_t *cigar_off, *seq_off, *name_off, *sa_off;
    const int32_t *sa_len;
    int32_t *refid, *pos, *mrefid, *mpos, *tlen, *lseq;
    uint8_t *mapq;
    uint16_t *flag;
    uint32_t *cigar;
    uint8_t *seq, *qual, *names, *sa;
    int want_names, want_sa;
    long r0, r1;
} fill_job_t;

static void *fill_worker(void *arg) {
    fill_job_t *j = (fill_job_t *)arg;
    for (long i = j->r0; i < j->r1; i++) {
        const uint8_t *r = j->data + j->rec_off[i] + 4;
        long bs = j->rec_off[i + 1] - j->rec_off[i] - 4;
        j->refid[i] = rd_i32(r);
        j->pos[i] = rd_i32(r + 4);
        uint8_t lrn = r[8];
        j->mapq[i] = r[9];
        uint16_t nc = rd_u16(r + 12);
        j->flag[i] = rd_u16(r + 14);
        int32_t ls = rd_i32(r + 16);
        j->lseq[i] = ls;
        j->mrefid[i] = rd_i32(r + 20);
        j->mpos[i] = rd_i32(r + 24);
        j->tlen[i] = rd_i32(r + 28);
        long p = 32;
        if (j->want_names)
            memcpy(j->names + j->name_off[i], r + p, lrn);
        p += lrn;
        memcpy(j->cigar + j->cigar_off[i], r + p, 4L * nc);
        p += 4L * nc;
        const uint8_t *packed = r + p;
        uint8_t *sq = j->seq + j->seq_off[i];
        for (int32_t k = 0; k + 1 < ls; k += 2) {
            uint8_t b = packed[k >> 1];
            sq[k] = (uint8_t)NT16[b >> 4];
            sq[k + 1] = (uint8_t)NT16[b & 0xF];
        }
        if (ls & 1)
            sq[ls - 1] = (uint8_t)NT16[packed[(ls - 1) >> 1] >> 4];
        p += (ls + 1) / 2;
        memcpy(j->qual + j->seq_off[i], r + p, ls);
        p += ls;
        if (j->want_sa && j->sa_len[i] >= 0 && p < bs) {
            const uint8_t *payload;
            long pl = find_sa(r + p, bs - p, &payload);
            if (pl == (long)j->sa_len[i])
                memcpy(j->sa + j->sa_off[i], payload, pl);
        }
    }
    return NULL;
}

/* Pass 2 (threaded): fill caller-allocated arrays using offsets from
 * gn_bam_offsets (+ host-side prefix sums). All *_off arrays have R+1
 * entries, precomputed. Each worker owns a disjoint record range, so the
 * fill — and the first-touch page faults of the big seq/qual outputs,
 * which dominate on sandboxed kernels — parallelizes. Returns 0. */
GN_API int gn_bam_fill_mt(const uint8_t *data, const int64_t *rec_off, long R,
                          const int64_t *cigar_off, const int64_t *seq_off,
                          const int64_t *name_off, const int64_t *sa_off,
                          const int32_t *sa_len,
                          int32_t *refid, int32_t *pos, uint8_t *mapq,
                          uint16_t *flag, int32_t *mrefid, int32_t *mpos,
                          int32_t *tlen, int32_t *lseq,
                          uint32_t *cigar, uint8_t *seq, uint8_t *qual,
                          uint8_t *names, uint8_t *sa,
                          int want_names, int want_sa, int nthreads) {
    if (nthreads < 1)
        nthreads = 1;
    if (nthreads > 64)
        nthreads = 64;
    if (nthreads > R)
        nthreads = R > 0 ? (int)R : 1;
    pthread_t tids[64];
    fill_job_t jobs[64];
    long per = (R + nthreads - 1) / nthreads;
    int started = 0;
    for (int t = 0; t < nthreads; t++) {
        fill_job_t *j = &jobs[t];
        j->data = data;
        j->rec_off = rec_off;
        j->cigar_off = cigar_off;
        j->seq_off = seq_off;
        j->name_off = name_off;
        j->sa_off = sa_off;
        j->sa_len = sa_len;
        j->refid = refid; j->pos = pos; j->mapq = mapq; j->flag = flag;
        j->mrefid = mrefid; j->mpos = mpos; j->tlen = tlen; j->lseq = lseq;
        j->cigar = cigar; j->seq = seq; j->qual = qual; j->names = names;
        j->sa = sa;
        j->want_names = want_names;
        j->want_sa = want_sa;
        j->r0 = t * per;
        j->r1 = (t + 1) * per < R ? (t + 1) * per : R;
        if (j->r0 >= j->r1)
            break;
        if (pthread_create(&tids[t], NULL, fill_worker, j) != 0) {
            fill_worker(j);
            tids[t] = 0;
        }
        started++;
    }
    for (int t = 0; t < started; t++)
        if (tids[t])
            pthread_join(tids[t], NULL);
    return 0;
}

/* Pass 2: fill caller-allocated arrays. *_off arrays have R+1 entries and
 * are written here (starting at 0). sa_len[i] = -1 when absent.
 * Returns the record count again (must equal pass 1). */
GN_API long gn_bam_fill(const uint8_t *data, long start, long end,
                        int32_t *refid, int32_t *pos, uint8_t *mapq,
                        uint16_t *flag, int32_t *mrefid, int32_t *mpos,
                        int32_t *tlen, int32_t *lseq,
                        uint32_t *cigar, int64_t *cigar_off,
                        uint8_t *seq, uint8_t *qual, int64_t *seq_off,
                        uint8_t *names, int64_t *name_off,
                        uint8_t *sa, int64_t *sa_off, int32_t *sa_len,
                        int want_names, int want_sa) {
    long off = start, R = 0;
    int64_t co = 0, so = 0, no = 0, ao = 0;
    cigar_off[0] = 0;
    seq_off[0] = 0;
    name_off[0] = 0;
    sa_off[0] = 0;
    while (off + 4 <= end) {
        uint32_t bs = rd_u32(data + off);
        if (off + 4 + (long)bs > end)
            break;
        const uint8_t *r = data + off + 4;
        refid[R] = rd_i32(r);
        pos[R] = rd_i32(r + 4);
        uint8_t lrn = r[8];
        mapq[R] = r[9];
        uint16_t nc = rd_u16(r + 12);
        flag[R] = rd_u16(r + 14);
        int32_t ls = rd_i32(r + 16);
        lseq[R] = ls;
        mrefid[R] = rd_i32(r + 20);
        mpos[R] = rd_i32(r + 24);
        tlen[R] = rd_i32(r + 28);
        long p = 32;
        if (want_names) {
            memcpy(names + no, r + p, lrn);  /* includes trailing NUL */
            no += lrn;
        }
        name_off[R + 1] = no;
        p += lrn;
        memcpy(cigar + co, r + p, 4L * nc);
        co += nc;
        cigar_off[R + 1] = co;
        p += 4L * nc;
        const uint8_t *packed = r + p;
        for (int32_t k = 0; k < ls; k++) {
            uint8_t b = packed[k >> 1];
            seq[so + k] = (uint8_t)NT16[(k & 1) ? (b & 0xF) : (b >> 4)];
        }
        p += (ls + 1) / 2;
        memcpy(qual + so, r + p, ls);
        p += ls;
        so += ls;
        seq_off[R + 1] = so;
        sa_len[R] = -1;
        if (want_sa && p < (long)bs) {
            const uint8_t *payload;
            long pl = find_sa(r + p, (long)bs - p, &payload);
            if (pl >= 0) {
                memcpy(sa + ao, payload, pl);
                ao += pl;
                sa_len[R] = (int32_t)pl;
            }
        }
        sa_off[R + 1] = ao;
        R++;
        off += 4 + bs;
    }
    return R;
}

/* Fused host placement kernel: correct-clip-cast-place in one pass.
 *
 * Flatfield correction multiplies by a HOST-computed reciprocal field
 * (ff holds 1/flatfield): f32 multiplication is bit-exact across this
 * kernel, the NumPy twin, and the TPU op, whereas division is
 * reciprocal-approximated on TPUs.
 *
 * The host fusion backend's hot loop (ops/host_fuse.py:_place) does
 * tile/flatfield -> clip -> cast -> canvas[slice] = tile with NumPy,
 * materializing two float temporaries per tile. On the single-core
 * hosts this framework often runs on, a fused C loop roughly halves
 * the memory traffic of the fusion stage.
 *
 * Built as a plain C shared library (no Python.h dependency) and bound
 * with ctypes — the environment provides no pybind11.
 *
 * Layout contract (enforced by the Python wrapper):
 *   canvas: C-contiguous uint16 (H, W) plane slice base pointer
 *   tile:   C-contiguous uint16 (th, tw)
 *   ff:     C-contiguous float32 (th, tw) RECIPROCAL flatfield, or NULL
 */

#include <stdint.h>
#include <stddef.h>
#include <errno.h>
#include <sys/uio.h>
#include <unistd.h>

/* Place tile[y0:y1, x0:x1] into canvas at (cy, cx), correcting by ff. */
void place_u16(
    uint16_t *canvas, ptrdiff_t canvas_stride,      /* elements per row */
    const uint16_t *tile, ptrdiff_t tile_stride,
    const float *ff, ptrdiff_t ff_stride,
    int y0, int y1, int x0, int x1,                 /* tile sub-window  */
    ptrdiff_t cy, ptrdiff_t cx)                     /* canvas dest      */
{
    for (int y = y0; y < y1; ++y) {
        const uint16_t *trow = tile + (ptrdiff_t)y * tile_stride;
        uint16_t *crow = canvas + (cy + (y - y0)) * canvas_stride + cx;
        if (ff) {
            const float *frow = ff + (ptrdiff_t)y * ff_stride;
            for (int x = x0; x < x1; ++x) {
                float v = (float)trow[x] * frow[x];
                if (v < 0.0f) v = 0.0f;
                if (v > 65535.0f) v = 65535.0f;
                crow[x - x0] = (uint16_t)v;
            }
        } else {
            for (int x = x0; x < x1; ++x) {
                crow[x - x0] = trow[x];
            }
        }
    }
}

/* Same for uint8 tiles. */
void place_u8(
    uint8_t *canvas, ptrdiff_t canvas_stride,
    const uint8_t *tile, ptrdiff_t tile_stride,
    const float *ff, ptrdiff_t ff_stride,
    int y0, int y1, int x0, int x1,
    ptrdiff_t cy, ptrdiff_t cx)
{
    for (int y = y0; y < y1; ++y) {
        const uint8_t *trow = tile + (ptrdiff_t)y * tile_stride;
        uint8_t *crow = canvas + (cy + (y - y0)) * canvas_stride + cx;
        if (ff) {
            const float *frow = ff + (ptrdiff_t)y * ff_stride;
            for (int x = x0; x < x1; ++x) {
                float v = (float)trow[x] * frow[x];
                if (v < 0.0f) v = 0.0f;
                if (v > 255.0f) v = 255.0f;
                crow[x - x0] = (uint8_t)v;
            }
        } else {
            for (int x = x0; x < x1; ++x) {
                crow[x - x0] = trow[x];
            }
        }
    }
}

/* Nearest 2x downsample: dst[y, x] = src[2y, 2x]. The NumPy twin
 * (x[::2, ::2] copy) runs at ~0.5-1 GB/s because stride-2 gathers
 * defeat memcpy; this loop auto-vectorizes to pack/shuffle ops. */
void downsample2x_u16(const uint16_t *src, ptrdiff_t src_stride,
                      uint16_t *dst, ptrdiff_t dst_stride,
                      ptrdiff_t out_h, ptrdiff_t out_w)
{
    for (ptrdiff_t y = 0; y < out_h; ++y) {
        const uint16_t *s = src + 2 * y * src_stride;
        uint16_t *d = dst + y * dst_stride;
        for (ptrdiff_t x = 0; x < out_w; ++x)
            d[x] = s[2 * x];
    }
}

void downsample2x_u8(const uint8_t *src, ptrdiff_t src_stride,
                     uint8_t *dst, ptrdiff_t dst_stride,
                     ptrdiff_t out_h, ptrdiff_t out_w)
{
    for (ptrdiff_t y = 0; y < out_h; ++y) {
        const uint8_t *s = src + 2 * y * src_stride;
        uint8_t *d = dst + y * dst_stride;
        for (ptrdiff_t x = 0; x < out_w; ++x)
            d[x] = s[2 * x];
    }
}

/* Mean 2x2 downsample for unsigned ints: dst = floor(mean of the 2x2
 * window). The 4-term sum fits u32 and is < 2^24, so the float32 mean
 * the NumPy twin computes is exact and floor(mean) == sum >> 2 —
 * bit-identical results without the u16->f32->u16 round-trip that
 * dominates the NumPy path (measured 4.4 s of a 5.3 s merge). */
void downsample2x2_mean_u16(const uint16_t *src, ptrdiff_t src_stride,
                            uint16_t *dst, ptrdiff_t dst_stride,
                            ptrdiff_t out_h, ptrdiff_t out_w)
{
    for (ptrdiff_t y = 0; y < out_h; ++y) {
        const uint16_t *s0 = src + 2 * y * src_stride;
        const uint16_t *s1 = s0 + src_stride;
        uint16_t *d = dst + y * dst_stride;
        for (ptrdiff_t x = 0; x < out_w; ++x) {
            uint32_t sum = (uint32_t)s0[2 * x] + s0[2 * x + 1]
                         + s1[2 * x] + s1[2 * x + 1];
            d[x] = (uint16_t)(sum >> 2);
        }
    }
}

void downsample2x2_mean_u8(const uint8_t *src, ptrdiff_t src_stride,
                           uint8_t *dst, ptrdiff_t dst_stride,
                           ptrdiff_t out_h, ptrdiff_t out_w)
{
    for (ptrdiff_t y = 0; y < out_h; ++y) {
        const uint8_t *s0 = src + 2 * y * src_stride;
        const uint8_t *s1 = s0 + src_stride;
        uint8_t *d = dst + y * dst_stride;
        for (ptrdiff_t x = 0; x < out_w; ++x) {
            uint32_t sum = (uint32_t)s0[2 * x] + s0[2 * x + 1]
                         + s1[2 * x] + s1[2 * x + 1];
            d[x] = (uint8_t)(sum >> 2);
        }
    }
}

/* ---- raw zarr chunk writer -------------------------------------- */

/* Drain a fully-populated iovec array at a file offset, restarting on
 * partial writes and EINTR. Returns 0 or -errno. */
static int pwritev_full(int fd, struct iovec *iov, int n, long long off)
{
    while (n > 0) {
        ssize_t k = pwritev(fd, iov, n, (off_t)off);
        if (k < 0) {
            if (errno == EINTR)
                continue;
            return -errno;
        }
        off += k;
        while (n > 0 && (size_t)k >= iov[0].iov_len) {
            k -= (ssize_t)iov[0].iov_len;
            ++iov;
            --n;
        }
        if (n > 0 && k > 0) {
            iov[0].iov_base = (char *)iov[0].iov_base + k;
            iov[0].iov_len -= (size_t)k;
        }
    }
    return 0;
}

/* Stream nrows strided source rows into a CONTIGUOUS file region at
 * off0: each file record is row_bytes from src (advancing src_stride
 * per row) followed by pad_bytes of zero padding (pad may be NULL when
 * pad_bytes is 0). This writes zarr v2 raw chunk bodies straight from
 * a band buffer — no per-chunk assembly copy. Controlled interleaved
 * measurement on the production band pattern: ~3.1 GB/s vs
 * tensorstore's ~1.2-1.7 of single-core CPU (down to ~0.4 in starved
 * windows). Returns 0 or -errno. */
long long write_rows_contig(int fd, const char *src, long long src_stride,
                            long long nrows, long long row_bytes,
                            const char *pad, long long pad_bytes,
                            long long off0)
{
    enum { MAXIOV = 1024 };
    struct iovec iov[MAXIOV];
    int per = pad_bytes > 0 ? 2 : 1;
    long long rec = row_bytes + pad_bytes;
    long long r = 0;
    while (r < nrows) {
        long long batch = (MAXIOV / per);
        if (batch > nrows - r)
            batch = nrows - r;
        int n = 0;
        for (long long i = 0; i < batch; ++i) {
            iov[n].iov_base = (void *)(src + (r + i) * src_stride);
            iov[n].iov_len = (size_t)row_bytes;
            ++n;
            if (pad_bytes > 0) {
                iov[n].iov_base = (void *)pad;
                iov[n].iov_len = (size_t)pad_bytes;
                ++n;
            }
        }
        int rc = pwritev_full(fd, iov, n, off0 + r * rec);
        if (rc < 0)
            return rc;
        r += batch;
    }
    return 0;
}

/* Feathered accumulate: acc += w*corrected, wsum += w. Ramp distances
 * are measured from the FULL crop window [wy0,wy1)x[wx0,wx1) (matching
 * the device kernel), while only the visible [y0,y1)x[x0,x1) sub-window
 * is written (canvas clamping must not change weights). */
void feather_u8(
    float *acc, float *wsum, ptrdiff_t canvas_stride,
    const uint8_t *tile, ptrdiff_t tile_stride,
    const float *ff, ptrdiff_t ff_stride,
    int y0, int y1, int x0, int x1,
    int wy0, int wy1, int wx0, int wx1,
    ptrdiff_t cy, ptrdiff_t cx,
    float inv_blend_px)
{
    for (int y = y0; y < y1; ++y) {
        const uint8_t *trow = tile + (ptrdiff_t)y * tile_stride;
        float *arow = acc + (cy + (y - y0)) * canvas_stride + cx;
        float *wrow = wsum + (cy + (y - y0)) * canvas_stride + cx;
        int dy = (y - wy0 + 1) < (wy1 - y) ? (y - wy0 + 1) : (wy1 - y);
        float wy = dy * inv_blend_px;
        if (wy > 1.0f) wy = 1.0f;
        for (int x = x0; x < x1; ++x) {
            int dx = (x - wx0 + 1) < (wx1 - x) ? (x - wx0 + 1) : (wx1 - x);
            float w = dx * inv_blend_px;
            if (w > 1.0f) w = 1.0f;
            if (wy < w) w = wy;
            float v = (float)trow[x];
            if (ff) {
                v *= ff[(ptrdiff_t)y * ff_stride + x];
                if (v < 0.0f) v = 0.0f;
                if (v > 255.0f) v = 255.0f;
                v = (float)(uint8_t)v;
            }
            arow[x - x0] += w * v;
            wrow[x - x0] += w;
        }
    }
}

void feather_u16(
    float *acc, float *wsum, ptrdiff_t canvas_stride,
    const uint16_t *tile, ptrdiff_t tile_stride,
    const float *ff, ptrdiff_t ff_stride,
    int y0, int y1, int x0, int x1,
    int wy0, int wy1, int wx0, int wx1,
    ptrdiff_t cy, ptrdiff_t cx,
    float inv_blend_px)
{
    for (int y = y0; y < y1; ++y) {
        const uint16_t *trow = tile + (ptrdiff_t)y * tile_stride;
        float *arow = acc + (cy + (y - y0)) * canvas_stride + cx;
        float *wrow = wsum + (cy + (y - y0)) * canvas_stride + cx;
        int dy = (y - wy0 + 1) < (wy1 - y) ? (y - wy0 + 1) : (wy1 - y);
        float wy = dy * inv_blend_px;
        if (wy > 1.0f) wy = 1.0f;
        for (int x = x0; x < x1; ++x) {
            int dx = (x - wx0 + 1) < (wx1 - x) ? (x - wx0 + 1) : (wx1 - x);
            float w = dx * inv_blend_px;
            if (w > 1.0f) w = 1.0f;
            if (wy < w) w = wy;
            float v = (float)trow[x];
            if (ff) {
                /* match the NumPy/device paths: correction quantizes to
                 * the storage dtype before accumulation */
                v *= ff[(ptrdiff_t)y * ff_stride + x];
                if (v < 0.0f) v = 0.0f;
                if (v > 65535.0f) v = 65535.0f;
                v = (float)(uint16_t)v;
            }
            arow[x - x0] += w * v;
            wrow[x - x0] += w;
        }
    }
}

/* Feather finalize: (acc, wsum) f32 pair -> storage dtype, one pass.
 *
 * Replaces the NumPy chain acc/np.maximum(wsum,1e-6) -> zero-where-
 * unwritten -> round -> clip -> astype, which materializes ~5 float
 * temporaries per band (measured 50 s of on-core CPU for a g10 canvas,
 * BENCH_NOTES r5 variants table). Semantics are kept bit-identical:
 * rintf = round-half-to-even like np.round; the 1e-6 guard divide and
 * the exact wsum==0 zeroing match the NumPy twin, so the byte-parity
 * tests hold across backends.
 */
#include <math.h>

void finalize_feather_u16(
    const float *acc, const float *wsum, ptrdiff_t src_stride,
    uint16_t *out, ptrdiff_t out_stride, ptrdiff_t h, ptrdiff_t w)
{
    for (ptrdiff_t y = 0; y < h; ++y) {
        const float *a = acc + y * src_stride;
        const float *ws = wsum + y * src_stride;
        uint16_t *o = out + y * out_stride;
        for (ptrdiff_t x = 0; x < w; ++x) {
            float wv = ws[x];
            float v = a[x] / (wv > 1e-6f ? wv : 1e-6f);
            if (wv == 0.0f) v = 0.0f;
            v = rintf(v);
            if (v < 0.0f) v = 0.0f;
            if (v > 65535.0f) v = 65535.0f;
            o[x] = (uint16_t)v;
        }
    }
}

void finalize_feather_u8(
    const float *acc, const float *wsum, ptrdiff_t src_stride,
    uint8_t *out, ptrdiff_t out_stride, ptrdiff_t h, ptrdiff_t w)
{
    for (ptrdiff_t y = 0; y < h; ++y) {
        const float *a = acc + y * src_stride;
        const float *ws = wsum + y * src_stride;
        uint8_t *o = out + y * out_stride;
        for (ptrdiff_t x = 0; x < w; ++x) {
            float wv = ws[x];
            float v = a[x] / (wv > 1e-6f ? wv : 1e-6f);
            if (wv == 0.0f) v = 0.0f;
            v = rintf(v);
            if (v < 0.0f) v = 0.0f;
            if (v > 255.0f) v = 255.0f;
            o[x] = (uint8_t)v;
        }
    }
}

// Overwrite placement of a batch of tiles into a canvas, on Hopper.
//
// Replaces the Pallas TPU kernel image_stitcher_tpu/ops/pallas_fuse.py::
// fuse_overwrite_pallas (body _fuse_kernel), with and without its fused
// flatfield (ff_recip). Semantics are those of ops/fuse.py::apply_flatfield
// followed by fuse_overwrite: the tiles of a batch apply in order, each
// valid tile writes its crop window [top, th-bottom) x [left, tw-right)
// into canvas[c, z, y:, x:], a later tile wins, and pixels outside every
// window keep the canvas value. With ff_recip every written pixel is
// trunc(clip(tile * ff_recip[c], dtype min, dtype max)).
//
// What bounds it: memory. Each canvas pixel that the batch writes costs
// one tile pixel read and one canvas pixel written; the reciprocal field
// (th x tw f32 per channel) is read by every tile of its channel but fits
// in the 50 MB L2, so its device-memory cost is once per channel. At the
// band fuser's headline batch (10 u16 2048^2 tiles with the field, 25 M
// pixels written) that is ~117 MB, ~0.035 ms at 3.35 TB/s.
//
// What the design does about that:
// - Tile-owned, with a write rule for order. Blocks run in no order, so
//   pixel (r, s) of tile i is written only if no later valid tile j > i
//   of the same (c, z) covers that canvas pixel with its crop window.
//   Every canvas pixel has one writer, no atomics, and the result is
//   exactly later-tile-wins; covered pixels are neither read nor written.
//   (A canvas-owned design, as the feather kernel's, would have to walk
//   the batch per pixel; here a row's uncovered spans are found once.)
// - A block owns a strip of 8 rows of one tile, one warp per row. The
//   tile is the grid's fastest index, so the batch's tiles read the same
//   field rows at about the same time and the field stays in L2. A block
//   first gathers, by warp ballot into shared memory, the later windows
//   of its plane that meet the strip. For each row the warp then
//   computes once the spans of the crop window that no later window
//   covers: an interval subtraction where each candidate start (the
//   window's left edge, or the right edge of a covering window) is one
//   lane's, and survives if no covering window contains it.
// - Each span is copied with 16-byte stores on the canvas, aligned to the
//   canvas row, whatever its pitch; only its ragged ends (< 16 B each)
//   take scalar stores. The tile and field elements of a 16-byte store are
//   gathered with 16-byte loads aligned to the tile row: the tile's x
//   origin puts tile and canvas out of step by a fixed shift on a row,
//   and the copy loop is instantiated for every shift (a warp-uniform
//   branch), so the shift is a register move. Tile rows that are not
//   16-byte aligned (tw * itemsize not a multiple of 16) take scalar
//   loads into the same 16-byte stores.
// - The batch's metadata rides in the kernel parameters (no device copy).
// - The flatfield product is one IEEE f32 multiply (__fmul_rn, never
//   contracted), a clip and a truncating cast: byte-identical to the
//   plain version and to the JAX package. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatch = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripRows = kWarps;  // tile rows per block, one per warp
constexpr unsigned kAll = 0xffffffffu;

// Batch metadata, passed by value. Windows are pre-clamped to the tile.
struct Batch {
  int n;
  int c[kMaxBatch], z[kMaxBatch], y[kMaxBatch], x[kMaxBatch];
  int r0[kMaxBatch], r1[kMaxBatch];  // crop window rows [r0, r1)
  int s0[kMaxBatch], s1[kMaxBatch];  // crop window cols [s0, s1)
  int valid[kMaxBatch];
};

template <typename T>
__device__ __forceinline__ T correct(T v, float f, float hi) {
  float g = __fmul_rn(static_cast<float>(v), f);
  g = fminf(fmaxf(g, 0.0f), hi);
  return static_cast<T>(static_cast<int>(g));  // truncating, like XLA
}

// The 16-byte vectors [begin, begin + nvec * V) of a span (tile columns;
// `dst` is the canvas at the tile's column 0, and dst + begin is 16-byte
// aligned). SH = begin % V: tile column begin sits SH elements into its
// aligned 16-byte vector of the tile row.
template <typename T, bool kWithFF, int SH>
__device__ __forceinline__ void copy_vectors(T* __restrict__ dst,
                                             const T* __restrict__ src,
                                             const float* __restrict__ ff,
                                             int begin, int nvec, float hi,
                                             int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int F = SH % 4;  // the same start within the field's float4s
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    const int t0 = begin + v * V;
    union { uint4 q[2]; T e[2 * V]; } s;
    const uint4* sp = reinterpret_cast<const uint4*>(src + (t0 - SH));
    s.q[0] = sp[0];
    if (SH != 0) s.q[1] = sp[1];
    union { uint4 q; T e[V]; } o;
    if (kWithFF) {
      union { float4 q[V / 4 + 1]; float e[V + 4]; } g;
      const float4* fp = reinterpret_cast<const float4*>(ff + (t0 - F));
#pragma unroll
      for (int m = 0; m < V / 4; ++m) g.q[m] = fp[m];
      if (F != 0) g.q[V / 4] = fp[V / 4];
#pragma unroll
      for (int e = 0; e < V; ++e) o.e[e] = correct<T>(s.e[SH + e], g.e[F + e], hi);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o.e[e] = s.e[SH + e];
    }
    *reinterpret_cast<uint4*>(dst + t0) = o.q;
  }
}

// copy_vectors with its shift picked at run time (warp-uniform).
template <typename T, bool kWithFF, int SH = 0>
__device__ __forceinline__ void copy_vectors_at(int sh, T* dst, const T* src,
                                                const float* ff, int begin,
                                                int nvec, float hi, int lane) {
  if constexpr (SH < static_cast<int>(16 / sizeof(T))) {
    if (sh == SH)
      copy_vectors<T, kWithFF, SH>(dst, src, ff, begin, nvec, hi, lane);
    else
      copy_vectors_at<T, kWithFF, SH + 1>(sh, dst, src, ff, begin, nvec, hi,
                                          lane);
  }
}

// Tile columns [p, q) of one row, by one warp: 16-byte canvas stores in
// the middle, scalar stores at the two ragged ends.
template <typename T, bool kWithFF>
__device__ __forceinline__ void copy_span(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          const float* __restrict__ ff,
                                          int p, int q, bool vec_src, float hi,
                                          int lane) {
  constexpr int V = 16 / sizeof(T);
  const int misalign =
      static_cast<int>(reinterpret_cast<uintptr_t>(dst + p) & 15) /
      static_cast<int>(sizeof(T));
  const int begin = min(q, p + (V - misalign) % V);
  const int nvec = (q - begin) / V;
  const int end = begin + nvec * V;
  // head [p, begin) and tail [end, q): fewer than V elements each
  const int t = lane < V ? p + lane : end + lane - V;
  if ((lane < V && t < begin) || (lane >= V && t < q)) {
    T v = src[t];
    dst[t] = kWithFF ? correct<T>(v, ff[t], hi) : v;
  }
  if (nvec == 0) return;
  if (vec_src) {
    copy_vectors_at<T, kWithFF>(begin % V, dst, src, ff, begin, nvec, hi, lane);
    return;
  }
  for (int v = lane; v < nvec; v += 32) {  // tile rows not 16-byte aligned
    const int t0 = begin + v * V;
    union { uint4 q; T e[V]; } o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.e[e] = kWithFF ? correct<T>(src[t0 + e], ff[t0 + e], hi) : src[t0 + e];
    *reinterpret_cast<uint4*>(dst + t0) = o.q;
  }
}

// One row r of tile i, by one warp: its uncovered spans, copied.
// `dst`, `src` and `ff` are the row's canvas at the tile's column 0, its
// tile row and its field row; the later windows are in shared memory.
template <typename T, bool kWithFF>
__device__ __forceinline__ void copy_row(
    T* __restrict__ dst, const T* __restrict__ src,
    const float* __restrict__ ff_row, int r, int s0, int s1, int cnt,
    const int* s_wy0, const int* s_wy1, const int* s_wa, const int* s_we,
    bool vec_src, float hi, int lane) {
  // Uncovered spans of [s0, s1) on row r. Candidate L = 0 starts at s0,
  // candidate L > 0 at the right edge of window L - 1 if it covers the
  // row; a candidate inside a covering window, or equal to an earlier
  // candidate, is dropped; a span ends at the window's right edge or at
  // the nearest covering window's left edge past its start.
  for (int base = 0; base <= cnt; base += 32) {
    const int L = base + lane;
    int p = -1, q = s1;
    if (L <= cnt) {
      bool ok = true;
      p = s0;
      if (L > 0) {
        p = s_we[L - 1];
        ok = r >= s_wy0[L - 1] && r < s_wy1[L - 1] && p > s0 && p < s1;
      }
      for (int k = 0; ok && k < cnt; ++k) {
        if (r < s_wy0[k] || r >= s_wy1[k]) continue;
        const int a = s_wa[k], e = s_we[k];
        if ((a <= p && p < e) || (k < L - 1 && e == p)) ok = false;
        if (a > p) q = min(q, a);
      }
      if (!ok) p = -1;
    }
    unsigned spans = __ballot_sync(kAll, p >= 0);
    while (spans != 0) {
      const int from = __ffs(spans) - 1;
      spans &= spans - 1;
      const int sp = __shfl_sync(kAll, p, from);
      const int sq = __shfl_sync(kAll, q, from);
      copy_span<T, kWithFF>(dst, src, ff_row, sp, sq, vec_src, hi, lane);
    }
  }
}

template <typename T, bool kWithFF>
__global__ void __launch_bounds__(kThreads)
fuse_overwrite_kernel(T* __restrict__ canvas, long long plane_elems, int num_z,
                      int canvas_w, const T* __restrict__ tiles, int th, int tw,
                      const float* __restrict__ ff, bool vec_src, float hi,
                      Batch b) {
  const int i = blockIdx.x;  // the grid's fastest index
  const int ra = max(b.r0[i], static_cast<int>(blockIdx.y) * kStripRows);
  const int rb = min(b.r1[i], static_cast<int>(blockIdx.y + 1) * kStripRows);
  const int s0 = b.s0[i], s1 = b.s1[i];
  // block-uniform: no thread reaches a barrier
  if (!b.valid[i] || ra >= rb || s0 >= s1) return;

  // the later windows of this plane that meet the strip, in tile i's
  // coordinates: rows [wy0, wy1), columns [wa, we)
  __shared__ unsigned masks[kMaxBatch / 32];
  __shared__ int s_wy0[kMaxBatch], s_wy1[kMaxBatch];
  __shared__ int s_wa[kMaxBatch], s_we[kMaxBatch];
  const int j = threadIdx.x;
  bool hit = false;
  int wy0 = 0, wy1 = 0, wa = 0, we = 0;
  if (j < kMaxBatch) {  // whole warps
    if (j > i && j < b.n && b.valid[j] && b.c[j] == b.c[i] &&
        b.z[j] == b.z[i]) {
      wy0 = b.y[j] + b.r0[j] - b.y[i];
      wy1 = b.y[j] + b.r1[j] - b.y[i];
      wa = b.x[j] + b.s0[j] - b.x[i];
      we = b.x[j] + b.s1[j] - b.x[i];
      hit = wy0 < wy1 && wa < we && wy0 < rb && wy1 > ra && wa < s1 && we > s0;
    }
    const unsigned m = __ballot_sync(kAll, hit);
    if ((j & 31) == 0) masks[j >> 5] = m;
  }
  __syncthreads();
  if (hit) {
    int pos = __popc(masks[j >> 5] & ((1u << (j & 31)) - 1u));
    if (j >= 32) pos += __popc(masks[0]);
    s_wy0[pos] = wy0;
    s_wy1[pos] = wy1;
    s_wa[pos] = wa;
    s_we[pos] = we;
  }
  __syncthreads();
  const int cnt = __popc(masks[0]) + __popc(masks[1]);

  const int lane = threadIdx.x & 31;
  T* dst = canvas +
           (static_cast<size_t>(b.c[i]) * num_z + b.z[i]) * plane_elems +
           static_cast<size_t>(b.y[i]) * canvas_w + b.x[i];
  const T* src = tiles + static_cast<size_t>(i) * th * tw;
  const float* ff_tile =
      kWithFF ? ff + static_cast<size_t>(b.c[i]) * th * tw : nullptr;
  const int r = ra + (threadIdx.x >> 5);
  if (r < rb)
    copy_row<T, kWithFF>(dst + static_cast<size_t>(r) * canvas_w,
                         src + static_cast<size_t>(r) * tw,
                         kWithFF ? ff_tile + static_cast<size_t>(r) * tw
                                 : nullptr,
                         r, s0, s1, cnt, s_wy0, s_wy1, s_wa, s_we, vec_src,
                         hi, lane);
}

template <typename T>
cudaError_t launch(void* canvas, long long plane_elems, int num_z, int canvas_w,
                   const void* tiles, int th, int tw, const float* ff,
                   const Batch& b, cudaStream_t stream) {
  const float hi = sizeof(T) == 1 ? 255.0f : 65535.0f;
  // 16-byte loads need 16-byte aligned tile rows (and field rows)
  const bool vec_src =
      (reinterpret_cast<uintptr_t>(tiles) & 15) == 0 &&
      (static_cast<size_t>(tw) * sizeof(T)) % 16 == 0 &&
      (ff == nullptr || (reinterpret_cast<uintptr_t>(ff) & 15) == 0);
  dim3 grid(b.n, (th + kStripRows - 1) / kStripRows);
  if (ff != nullptr) {
    fuse_overwrite_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<T*>(canvas), plane_elems, num_z, canvas_w,
        static_cast<const T*>(tiles), th, tw, ff, vec_src, hi, b);
  } else {
    fuse_overwrite_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<T*>(canvas), plane_elems, num_z, canvas_w,
        static_cast<const T*>(tiles), th, tw, nullptr, vec_src, hi, b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fuse_overwrite_max_batch() { return kMaxBatch; }

const char* fuse_overwrite_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one batch on `stream`. `info`, `crops` (n x 4 int32) and `valid`
// (n bytes) are HOST arrays; `canvas`, `tiles` and `ff` (nullable) are
// device pointers. `itemsize` is 1 (uint8) or 2 (uint16). The caller has
// checked that every valid tile lies inside the canvas. Returns a
// cudaError_t, 0 on success.
int fuse_overwrite_launch(int device, int itemsize, void* canvas, int num_z,
                          int canvas_h, int canvas_w, const void* tiles, int n,
                          int th, int tw, const int* info, const int* crops,
                          const unsigned char* valid, const float* ff,
                          void* stream) {
  if (n < 0 || n > kMaxBatch || th <= 0 || tw <= 0 ||
      (th + kStripRows - 1) / kStripRows > 65535 ||
      (itemsize != 1 && itemsize != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  Batch b;
  b.n = n;
  for (int k = 0; k < n; ++k) {
    b.c[k] = info[4 * k + 0];
    b.z[k] = info[4 * k + 1];
    b.y[k] = info[4 * k + 2];
    b.x[k] = info[4 * k + 3];
    const int top = crops[4 * k + 0], bottom = crops[4 * k + 1];
    const int left = crops[4 * k + 2], right = crops[4 * k + 3];
    b.r0[k] = top > 0 ? top : 0;
    b.r1[k] = th - bottom < th ? th - bottom : th;
    b.s0[k] = left > 0 ? left : 0;
    b.s1[k] = tw - right < tw ? tw - right : tw;
    b.valid[k] = valid[k] != 0;
  }
  const long long plane_elems = static_cast<long long>(canvas_h) * canvas_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = itemsize == 1
            ? launch<uint8_t>(canvas, plane_elems, num_z, canvas_w, tiles, th,
                              tw, ff, b, s)
            : launch<uint16_t>(canvas, plane_elems, num_z, canvas_w, tiles, th,
                               tw, ff, b, s);
  return static_cast<int>(err);
}

}  // extern "C"

// Feathered accumulation of a batch of tiles, and its finalize epilogue,
// on Hopper.
//
// Replaces the Pallas TPU kernel image_stitcher_tpu/ops/pallas_fuse.py::
// fuse_feather_pallas (body _feather_kernel), with and without its fused
// flatfield (ff_recip). Semantics are those of ops/fuse.py::fuse_feather:
// for each valid tile i of the batch, in batch order,
//   acc[c, z, y + r, x + s]  += ramp_i(r, s) * v_i(r, s)
//   wsum[c, z, y + r, x + s] += ramp_i(r, s)
// where ramp = clip(d / blend_px, 0, 1) for d > 0 and 0 elsewhere, d the
// 1-based distance to the nearest crop-window edge, min(r - top + 1,
// th - bottom - r, s - left + 1, tw - right - s), and v the tile as f32,
// or with ff_recip trunc(clip(tile * ff_recip[c], dtype range)) as f32
// (quantized to the storage dtype BEFORE it is weighted).
// The second kernel is ops/fuse.py::finalize_feather on a window of the
// canvases: round_half_even(acc / max(wsum, 1e-6)), 0 where wsum <= 0,
// clipped to the dtype range and cast, written as a dense u8/u16 array.
//
// What bounds them: memory. Each canvas pixel that the batch weights has
// its acc and wsum read and written once (16 B); each tile pixel inside
// its window is read once (2 B of u16); the reciprocal field (th x tw f32
// per channel) is read by every tile of its channel but stays in the
// 50 MB L2. At the band fuser's headline batch (10 u16 2048^2 tiles with
// the field, 24.5 M pixels weighted) that is ~0.47 GB, ~0.14 ms at
// 3.35 TB/s. The finalize reads 8 B and writes 2 B per output pixel.
//
// What the accumulation's design does about that, and about float sums:
// - A float sum depends on its order. Every canvas pixel has one owning
//   thread, which adds the terms of the tiles that cover it in batch
//   order; no atomics, so the result is the plain version's, bit for bit.
//   Successive batches are ordered by the stream. Every product and sum
//   is __fmul_rn / __fadd_rn, so nvcc cannot contract a + b*c into an FMA
//   (the plain version rounds the product, then the sum). Build without
//   --use_fast_math.
// - The grid covers, per (c, z) plane of the batch, the bounding box of
//   that plane's valid crop windows, its left edge rounded down to a
//   multiple of 4 columns. A block owns a 128 x 16 canvas rectangle and
//   first collects, by warp ballot into shared memory and in batch order,
//   the tiles whose windows meet it.
// - A thread owns 4 consecutive columns on 2 rows (a warp: 128 columns of
//   one row). It loads the acc and wsum of all its covered rows first,
//   as float4s when the canvas pitch is a multiple of 4 floats (the band
//   fuser pads it so), else as scalars; pixels that no tile covers are
//   neither read nor written.
// - For each tile, in order, it loads the tile and field values of all
//   its rows before it adds: 4 tile elements and 4 field floats per row
//   as aligned 4-element vectors. The tile's x origin puts its columns out
//   of step with the canvas's by a fixed shift (0-3) per tile, and the
//   loader is instantiated for every shift (a uniform branch). Columns at
//   a window's ragged edge, and tiles whose rows are not 4-element
//   aligned, take masked scalar loads.
// - d is an integer >= 1 inside the window, so the ramp takes at most
//   blend_px values below 1.0: a shared table ramp[d] = clip(__fdiv_rn(d,
//   blend_px), 0, 1), filled once per block, gives the same bits as the
//   divide (which only ramps longer than the table still do per pixel).
// - The batch metadata rides in the kernel parameters (no device copy).
//   The TPU kernel's (8k, 128)-aligned windows, rolls and DMA semaphores
//   have no counterpart: the canvases carry a one-tile apron, as the
//   plain version's do.
// - The finalize is one fused pass over the band's real rows: it replaces
//   the plain version's six full-size temporaries with one read of acc
//   and wsum and one write of the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatch = 64;
constexpr int kCols = 4;                     // canvas columns per thread
constexpr int kRows = 2;                     // canvas rows per thread
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kBlockW = kThreadsX * kCols;   // canvas columns per block
constexpr int kBlockH = kThreadsY * kRows;   // canvas rows per block
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRampTable = 2048;             // ramp[d] for d <= this
constexpr int kFinalizeThreads = 256;

// The valid tiles of a batch with a non-empty crop window, in batch order,
// and the (c, z) planes they touch, passed by value.
struct Batch {
  int n;                          // tiles below
  int tile[kMaxBatch];            // index in the tiles array
  int plane[kMaxBatch];           // index in the planes below
  int y[kMaxBatch], x[kMaxBatch]; // pre-crop origin on the canvas
  int top[kMaxBatch], bottom[kMaxBatch], left[kMaxBatch], right[kMaxBatch];
  int num_planes;
  int pc[kMaxBatch], pz[kMaxBatch];  // the plane's (c, z)
  int py[kMaxBatch], px[kMaxBatch];  // origin of the plane's bounding box
};

// One tile as the block sees it: its rows, window and field.
struct TileView {
  const void* src;    // the tile's row 0
  const float* ff;    // its channel's field, row 0 (or null)
  int y, x;           // pre-crop origin on the canvas
  int wy0, wy1, wx0, wx1;  // crop window on the canvas
  int top, dy1, left, dx1; // distances: r - top + 1, dy1 - r, ...
};

template <typename T> struct Quad;  // four elements in one load
template <> struct Quad<uint8_t> { using type = unsigned; };
template <> struct Quad<uint16_t> { using type = uint2; };

template <typename T, bool kWithFF>
__device__ __forceinline__ float value(T v, float f, float hi) {
  if (!kWithFF) return static_cast<float>(v);
  const float g = __fmul_rn(static_cast<float>(v), f);
  return static_cast<float>(static_cast<int>(fminf(fmaxf(g, 0.0f), hi)));
}

__device__ __forceinline__ float ramp_of(int d, const float* tab, int bp,
                                         float bpf) {
  d = min(d, bp);
  return d <= kRampTable
             ? tab[d]
             : fminf(fmaxf(__fdiv_rn(static_cast<float>(d), bpf), 0.0f), 1.0f);
}

// The 4 values at tile columns [t0, t0 + 4) of each of the thread's rows
// inside the tile's window (rows[m]), with aligned 4-element loads;
// SH = t0 % 4.
template <typename T, bool kWithFF, int SH>
__device__ __forceinline__ void load_vec(const TileView& t, int tw,
                                         const int (&rows)[kRows], int t0,
                                         float hi, float (&v)[kRows][kCols]) {
  using Q = typename Quad<T>::type;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (rows[m] < 0) continue;
    const size_t row = static_cast<size_t>(rows[m]) * tw + (t0 - SH);
    union { Q q[2]; T e[8]; } s;
    const Q* sp = reinterpret_cast<const Q*>(static_cast<const T*>(t.src) + row);
    s.q[0] = sp[0];
    if (SH != 0) s.q[1] = sp[1];
    if (kWithFF) {
      union { float4 q[2]; float e[8]; } g;
      const float4* fp = reinterpret_cast<const float4*>(t.ff + row);
      g.q[0] = fp[0];
      if (SH != 0) g.q[1] = fp[1];
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        v[m][e] = value<T, true>(s.e[SH + e], g.e[SH + e], hi);
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        v[m][e] = value<T, false>(s.e[SH + e], 0.0f, hi);
    }
  }
}

template <typename T, bool kWithFF, int SH = 0>
__device__ __forceinline__ void load_vec_at(int sh, const TileView& t, int tw,
                                            const int (&rows)[kRows], int t0,
                                            float hi,
                                            float (&v)[kRows][kCols]) {
  if constexpr (SH < kCols) {
    if (sh == SH)
      load_vec<T, kWithFF, SH>(t, tw, rows, t0, hi, v);
    else
      load_vec_at<T, kWithFF, SH + 1>(sh, t, tw, rows, t0, hi, v);
  }
}

template <typename T, bool kWithFF>
__global__ void __launch_bounds__(kThreads)
fuse_feather_kernel(float* __restrict__ acc, float* __restrict__ wsum,
                    long long plane_elems, int num_z, int canvas_w,
                    const T* __restrict__ tiles, int th, int tw,
                    const float* __restrict__ ff, float hi, int blend_px,
                    bool vec_src, bool vec_canvas, Batch b) {
  const int p = blockIdx.z;
  // the block's canvas rectangle [ya, ya + kBlockH) x [xa, xa + kBlockW)
  const int ya = b.py[p] + static_cast<int>(blockIdx.y) * kBlockH;
  const int xa = b.px[p] + static_cast<int>(blockIdx.x) * kBlockW;

  // the tiles of this plane whose window meets the rectangle, in order
  __shared__ unsigned masks[kMaxBatch / 32];
  __shared__ TileView s_t[kMaxBatch];
  __shared__ float s_ramp[kRampTable + 1];
  const int j = threadIdx.y * kThreadsX + threadIdx.x;
  const float bpf = static_cast<float>(blend_px);
  for (int d = j; d <= min(blend_px, kRampTable); d += kThreads)
    s_ramp[d] = fminf(fmaxf(__fdiv_rn(static_cast<float>(d), bpf), 0.0f), 1.0f);
  bool hit = false;
  TileView t{};
  if (j < kMaxBatch) {  // whole warps
    if (j < b.n && b.plane[j] == p) {
      t.y = b.y[j];
      t.x = b.x[j];
      t.top = b.top[j];
      t.left = b.left[j];
      t.dy1 = th - b.bottom[j];
      t.dx1 = tw - b.right[j];
      t.wy0 = t.y + max(t.top, 0);
      t.wy1 = t.y + min(t.dy1, th);
      t.wx0 = t.x + max(t.left, 0);
      t.wx1 = t.x + min(t.dx1, tw);
      t.src = tiles + static_cast<size_t>(b.tile[j]) * th * tw;
      t.ff = kWithFF ? ff + static_cast<size_t>(b.pc[p]) * th * tw : nullptr;
      hit = t.wy0 < ya + kBlockH && t.wy1 > ya && t.wx0 < xa + kBlockW &&
            t.wx1 > xa;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if ((j & 31) == 0) masks[j >> 5] = m;
  }
  __syncthreads();
  if (hit) {
    int pos = __popc(masks[j >> 5] & ((1u << (j & 31)) - 1u));
    if (j >= 32) pos += __popc(masks[0]);
    s_t[pos] = t;
  }
  __syncthreads();
  const int cnt = __popc(masks[0]) + __popc(masks[1]);
  if (cnt == 0) return;

  const int gx = xa + kCols * static_cast<int>(threadIdx.x);
  int gy[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    gy[m] = ya + static_cast<int>(threadIdx.y) + kThreadsY * m;

  // which of the thread's pixels some tile covers (bit e: column gx + e)
  unsigned cover[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) cover[m] = 0u;
  for (int k = 0; k < cnt; ++k) {
    const int lo = max(s_t[k].wx0 - gx, 0), up = min(s_t[k].wx1 - gx, kCols);
    if (lo >= up) continue;
    const unsigned bits = (1u << up) - (1u << lo);
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      if (gy[m] >= s_t[k].wy0 && gy[m] < s_t[k].wy1) cover[m] |= bits;
  }

  // this batch's starting sums, all rows' loads before any add
  const long long plane_off =
      (static_cast<long long>(b.pc[p]) * num_z + b.pz[p]) * plane_elems;
  float a[kRows][kCols], w[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const long long at = plane_off + static_cast<long long>(gy[m]) * canvas_w + gx;
    if (vec_canvas) {
      if (cover[m] != 0u) {
        const float4 av = *reinterpret_cast<const float4*>(acc + at);
        const float4 wv = *reinterpret_cast<const float4*>(wsum + at);
        a[m][0] = av.x; a[m][1] = av.y; a[m][2] = av.z; a[m][3] = av.w;
        w[m][0] = wv.x; w[m][1] = wv.y; w[m][2] = wv.z; w[m][3] = wv.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        if (cover[m] & (1u << e)) {
          a[m][e] = acc[at + e];
          w[m][e] = wsum[at + e];
        }
      }
    }
  }

  // each tile's terms, in batch order
  for (int k = 0; k < cnt; ++k) {
    const TileView& t = s_t[k];
    int rows[kRows];  // tile row of each of the thread's rows, or -1
    bool any = false;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const bool in = gy[m] >= t.wy0 && gy[m] < t.wy1;
      rows[m] = in ? gy[m] - t.y : -1;
      any |= in;
    }
    const int lo = max(t.wx0 - gx, 0), up = min(t.wx1 - gx, kCols);
    if (!any || lo >= up) continue;
    const int t0 = gx - t.x;  // tile column of the thread's column 0
    float v[kRows][kCols];
    if (vec_src && lo == 0 && up == kCols) {
      load_vec_at<T, kWithFF>(t0 & 3, t, tw, rows, t0, hi, v);
    } else {  // a ragged window edge, or tile rows not 4-element aligned
      const T* src = static_cast<const T*>(t.src);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          if (rows[m] < 0 || e < lo || e >= up) continue;
          const size_t off = static_cast<size_t>(rows[m]) * tw + t0 + e;
          v[m][e] = value<T, kWithFF>(src[off], kWithFF ? t.ff[off] : 0.0f, hi);
        }
      }
    }
    int dc[kCols];  // column distances to the window's edges
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      dc[e] = min(t0 + e - t.left + 1, t.dx1 - (t0 + e));
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (rows[m] < 0) continue;
      const int dr = min(rows[m] - t.top + 1, t.dy1 - rows[m]);
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        if (e < lo || e >= up) continue;
        // inside the window every distance is >= 1, so the ramp is > 0
        const float ramp = ramp_of(min(dr, dc[e]), s_ramp, blend_px, bpf);
        a[m][e] = __fadd_rn(a[m][e], __fmul_rn(ramp, v[m][e]));
        w[m][e] = __fadd_rn(w[m][e], ramp);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const long long at = plane_off + static_cast<long long>(gy[m]) * canvas_w + gx;
    if (vec_canvas) {
      if (cover[m] != 0u) {
        *reinterpret_cast<float4*>(acc + at) =
            make_float4(a[m][0], a[m][1], a[m][2], a[m][3]);
        *reinterpret_cast<float4*>(wsum + at) =
            make_float4(w[m][0], w[m][1], w[m][2], w[m][3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        if (cover[m] & (1u << e)) {
          acc[at + e] = a[m][e];
          wsum[at + e] = w[m][e];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalizeThreads)
finalize_feather_kernel(const float* __restrict__ acc,
                        const float* __restrict__ wsum, T* __restrict__ out,
                        int canvas_h, int canvas_w, int r0, int rows, int s0,
                        int cols, float hi) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cols) return;
  const long long plane = blockIdx.z;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long src = (plane * canvas_h + r0 + r) * canvas_w + s0 + s;
    const float w = wsum[src];
    float o = __fdiv_rn(acc[src], fmaxf(w, 1e-6f));
    o = w > 0.0f ? o : 0.0f;
    o = fminf(fmaxf(rintf(o), 0.0f), hi);  // round half to even, clip
    out[(plane * rows + r) * cols + s] = static_cast<T>(static_cast<int>(o));
  }
}

template <typename T>
cudaError_t launch_fuse(float* acc, float* wsum, long long plane_elems,
                        int num_z, int canvas_w, const void* tiles, int th,
                        int tw, const float* ff, int blend_px, int box_h,
                        int box_w, const Batch& b, cudaStream_t stream) {
  const float hi = sizeof(T) == 1 ? 255.0f : 65535.0f;
  auto aligned16 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  // 4-element loads need tile (and field) rows of a multiple of 4
  // elements; float4s on the canvases a pitch of a multiple of 4 floats
  const bool vec_src = tw % 4 == 0 && aligned16(tiles) &&
                       (ff == nullptr || aligned16(ff));
  const bool vec_canvas = canvas_w % 4 == 0 && aligned16(acc) && aligned16(wsum);
  dim3 grid((box_w + kBlockW - 1) / kBlockW, (box_h + kBlockH - 1) / kBlockH,
            b.num_planes);
  dim3 block(kThreadsX, kThreadsY);
  if (ff != nullptr) {
    fuse_feather_kernel<T, true><<<grid, block, 0, stream>>>(
        acc, wsum, plane_elems, num_z, canvas_w, static_cast<const T*>(tiles),
        th, tw, ff, hi, blend_px, vec_src, vec_canvas, b);
  } else {
    fuse_feather_kernel<T, false><<<grid, block, 0, stream>>>(
        acc, wsum, plane_elems, num_z, canvas_w, static_cast<const T*>(tiles),
        th, tw, nullptr, hi, blend_px, vec_src, vec_canvas, b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fuse_feather_max_batch() { return kMaxBatch; }

const char* fuse_feather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Accumulate one batch on `stream`. `info`, `crops` (n x 4 int32) and
// `valid` (n bytes) are HOST arrays; `acc`, `wsum`, `tiles` and `ff`
// (nullable) are device pointers. `itemsize` is 1 (uint8) or 2 (uint16).
// The caller has checked that every valid tile lies inside the canvases
// and that at least one valid tile has a non-empty crop window. Returns a
// cudaError_t, 0 on success.
int fuse_feather_launch(int device, int itemsize, float* acc, float* wsum,
                        int num_z, int canvas_h, int canvas_w,
                        const void* tiles, int n, int th, int tw,
                        const int* info, const int* crops,
                        const unsigned char* valid, const float* ff,
                        int blend_px, void* stream) {
  if (n < 0 || n > kMaxBatch || th <= 0 || tw <= 0 || blend_px < 1 ||
      (itemsize != 1 && itemsize != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Batch b;
  b.n = 0;
  b.num_planes = 0;
  int y1[kMaxBatch], x1[kMaxBatch];  // bounding-box ends, per plane
  for (int k = 0; k < n; ++k) {
    if (!valid[k]) continue;
    const int top = crops[4 * k + 0], bottom = crops[4 * k + 1];
    const int left = crops[4 * k + 2], right = crops[4 * k + 3];
    const int r0 = top > 0 ? top : 0, r1 = th - bottom < th ? th - bottom : th;
    const int s0 = left > 0 ? left : 0, s1 = tw - right < tw ? tw - right : tw;
    if (r1 <= r0 || s1 <= s0) continue;
    const int c = info[4 * k + 0], z = info[4 * k + 1];
    const int y = info[4 * k + 2], x = info[4 * k + 3];
    int p = 0;
    while (p < b.num_planes && (b.pc[p] != c || b.pz[p] != z)) ++p;
    if (p == b.num_planes) {
      b.pc[p] = c;
      b.pz[p] = z;
      b.py[p] = y + r0;
      b.px[p] = x + s0;
      y1[p] = y + r1;
      x1[p] = x + s1;
      ++b.num_planes;
    } else {
      b.py[p] = b.py[p] < y + r0 ? b.py[p] : y + r0;
      b.px[p] = b.px[p] < x + s0 ? b.px[p] : x + s0;
      y1[p] = y1[p] > y + r1 ? y1[p] : y + r1;
      x1[p] = x1[p] > x + s1 ? x1[p] : x + s1;
    }
    const int i = b.n++;
    b.tile[i] = k;
    b.plane[i] = p;
    b.y[i] = y;
    b.x[i] = x;
    b.top[i] = top;
    b.bottom[i] = bottom;
    b.left[i] = left;
    b.right[i] = right;
  }
  if (b.n == 0) return static_cast<int>(cudaErrorInvalidValue);
  int box_h = 0, box_w = 0;
  for (int p = 0; p < b.num_planes; ++p) {
    b.px[p] &= ~(kCols - 1);  // a thread's columns share one float4
    box_h = box_h > y1[p] - b.py[p] ? box_h : y1[p] - b.py[p];
    box_w = box_w > x1[p] - b.px[p] ? box_w : x1[p] - b.px[p];
  }
  const long long plane_elems = static_cast<long long>(canvas_h) * canvas_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = itemsize == 1
            ? launch_fuse<uint8_t>(acc, wsum, plane_elems, num_z, canvas_w,
                                   tiles, th, tw, ff, blend_px, box_h, box_w,
                                   b, s)
            : launch_fuse<uint16_t>(acc, wsum, plane_elems, num_z, canvas_w,
                                    tiles, th, tw, ff, blend_px, box_h, box_w,
                                    b, s);
  return static_cast<int>(err);
}

// Finalize the window [r0, r0 + rows) x [s0, s0 + cols) of every plane of
// the (planes, canvas_h, canvas_w) f32 pair into `out`, a dense
// (planes, rows, cols) u8/u16 array, on `stream`. Returns a cudaError_t.
int finalize_feather_launch(int device, int itemsize, const float* acc,
                            const float* wsum, void* out, int planes,
                            int canvas_h, int canvas_w, int r0, int rows,
                            int s0, int cols, void* stream) {
  if (planes < 0 || planes > 65535 || rows < 0 || cols < 0 || r0 < 0 ||
      s0 < 0 || r0 + rows > canvas_h || s0 + cols > canvas_w ||
      (itemsize != 1 && itemsize != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes == 0 || rows == 0 || cols == 0) return 0;
  dim3 grid((cols + kFinalizeThreads - 1) / kFinalizeThreads,
            rows < 65535 ? rows : 65535, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 1) {
    finalize_feather_kernel<uint8_t><<<grid, kFinalizeThreads, 0, s>>>(
        acc, wsum, static_cast<uint8_t*>(out), canvas_h, canvas_w, r0, rows,
        s0, cols, 255.0f);
  } else {
    finalize_feather_kernel<uint16_t><<<grid, kFinalizeThreads, 0, s>>>(
        acc, wsum, static_cast<uint16_t*>(out), canvas_h, canvas_w, r0, rows,
        s0, cols, 65535.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

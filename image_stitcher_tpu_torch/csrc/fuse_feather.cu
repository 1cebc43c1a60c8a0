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
// What bounds them: memory. Per covered canvas pixel the accumulation
// reads and writes acc and wsum (16 B); per tile pixel it reads 2 B of
// u16 tile and 4 B of f32 reciprocal. Ten 2048^2 tiles into one band
// plane move about 0.85 GB, ~0.25 ms at 3.35 TB/s. The finalize reads
// 8 B and writes 2 B per output pixel.
//
// What the design does about that, and about the float sums:
// - A float sum depends on its order. The TPU kernel gets its order from
//   an in-order grid; here every canvas pixel has exactly one thread,
//   which walks the tiles that cover it in batch order and adds their
//   terms. No atomics: the result is the plain version's, bit for bit.
//   Successive batches are ordered by the stream.
// - Every product and sum is __fmul_rn / __fadd_rn and the ramp's divide
//   is __fdiv_rn, so nvcc cannot contract a + b*c into an FMA (the plain
//   version rounds the product, then the sum). Build without
//   --use_fast_math.
// - The grid covers, per (c, z) plane of the batch, only the bounding box
//   of that plane's valid crop windows, not the whole band canvas. A
//   block owns a kBlockW x kBlockH canvas rectangle and first collects,
//   in shared memory and in batch order, the tiles whose windows meet
//   it; a pixel that no tile covers is neither read nor written.
// - Neighbouring threads own neighbouring columns, so canvas, tile and
//   field loads are coalesced. The batch metadata rides in the kernel
//   parameters (no device copy). The TPU kernel's (8k, 128)-aligned
//   windows, rolls and DMA semaphores have no counterpart: the canvases
//   carry a one-tile apron, as the plain version's do.
// - The finalize is one fused pass over the band's real rows: it replaces
//   the plain version's six full-size temporaries with one read of acc
//   and wsum and one write of the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatch = 64;
constexpr int kBlockW = 128;   // canvas columns per block (one per thread)
constexpr int kRowThreads = 2; // thread rows per block
constexpr int kBlockH = 16;    // canvas rows per block
constexpr int kThreads = kBlockW * kRowThreads;
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

template <typename T, bool kWithFF>
__global__ void __launch_bounds__(kThreads)
fuse_feather_kernel(float* __restrict__ acc, float* __restrict__ wsum,
                    long long plane_elems, int num_z, int canvas_w,
                    const T* __restrict__ tiles, int th, int tw,
                    const float* __restrict__ ff, float lo, float hi,
                    float blend_px, Batch b) {
  const int p = blockIdx.z;
  // the block's canvas rectangle [ya, ya + kBlockH) x [xa, xa + kBlockW)
  const int ya = b.py[p] + static_cast<int>(blockIdx.y) * kBlockH;
  const int xa = b.px[p] + static_cast<int>(blockIdx.x) * kBlockW;

  // the tiles of this plane whose window meets the rectangle, in order,
  // with their window [wy0, wy1) x [wx0, wx1) in canvas coordinates
  __shared__ unsigned masks[kMaxBatch / 32];
  __shared__ int count;
  __shared__ int s_tile[kMaxBatch], s_y[kMaxBatch], s_x[kMaxBatch];
  __shared__ int s_wy0[kMaxBatch], s_wy1[kMaxBatch];
  __shared__ int s_wx0[kMaxBatch], s_wx1[kMaxBatch];
  __shared__ int s_dy1[kMaxBatch], s_dx1[kMaxBatch];  // th - bottom, tw - right
  __shared__ int s_top[kMaxBatch], s_left[kMaxBatch];
  __shared__ int s_c[kMaxBatch];
  const int j = threadIdx.y * kBlockW + threadIdx.x;
  bool hit = false;
  int wy0 = 0, wy1 = 0, wx0 = 0, wx1 = 0;
  if (j < kMaxBatch) {
    if (j < b.n && b.plane[j] == p) {
      wy0 = b.y[j] + max(b.top[j], 0);
      wy1 = b.y[j] + min(th - b.bottom[j], th);
      wx0 = b.x[j] + max(b.left[j], 0);
      wx1 = b.x[j] + min(tw - b.right[j], tw);
      hit = wy0 < ya + kBlockH && wy1 > ya && wx0 < xa + kBlockW && wx1 > xa;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if ((j & 31) == 0) masks[j >> 5] = m;
  }
  __syncthreads();
  if (hit) {
    const int lane = j & 31;
    int pos = __popc(masks[j >> 5] & ((1u << lane) - 1u));
    for (int w = 0; w < (j >> 5); ++w) pos += __popc(masks[w]);
    s_tile[pos] = b.tile[j];
    s_y[pos] = b.y[j];
    s_x[pos] = b.x[j];
    s_wy0[pos] = wy0;
    s_wy1[pos] = wy1;
    s_wx0[pos] = wx0;
    s_wx1[pos] = wx1;
    s_dy1[pos] = th - b.bottom[j];
    s_dx1[pos] = tw - b.right[j];
    s_top[pos] = b.top[j];
    s_left[pos] = b.left[j];
    s_c[pos] = b.pc[p];
  }
  if (j == 0) {
    int total = 0;
    for (int w = 0; w < kMaxBatch / 32; ++w) total += __popc(masks[w]);
    count = total;
  }
  __syncthreads();
  const int cnt = count;
  if (cnt == 0) return;

  const int gx = xa + threadIdx.x;
  float* acc_plane = acc + (static_cast<long long>(b.pc[p]) * num_z + b.pz[p]) * plane_elems;
  float* wsum_plane = wsum + (static_cast<long long>(b.pc[p]) * num_z + b.pz[p]) * plane_elems;
  for (int gy = ya + threadIdx.y; gy < ya + kBlockH; gy += kRowThreads) {
    float a = 0.0f, w = 0.0f;
    bool touched = false;
    const long long at = static_cast<long long>(gy) * canvas_w + gx;
    for (int k = 0; k < cnt; ++k) {
      if (gy < s_wy0[k] || gy >= s_wy1[k] || gx < s_wx0[k] || gx >= s_wx1[k])
        continue;
      const int r = gy - s_y[k];
      const int s = gx - s_x[k];
      // inside the window every distance is >= 1, so the ramp is > 0
      const int d = min(min(r - s_top[k] + 1, s_dy1[k] - r),
                        min(s - s_left[k] + 1, s_dx1[k] - s));
      const float ramp =
          fminf(fmaxf(__fdiv_rn(static_cast<float>(d), blend_px), 0.0f), 1.0f);
      const size_t off = (static_cast<size_t>(s_tile[k]) * th + r) * tw + s;
      float v = static_cast<float>(tiles[off]);
      if (kWithFF) {
        const float f = __fmul_rn(
            v, ff[(static_cast<size_t>(s_c[k]) * th + r) * tw + s]);
        v = static_cast<float>(
            static_cast<int>(fminf(fmaxf(f, lo), hi)));  // truncating
      }
      if (!touched) {
        a = acc_plane[at];
        w = wsum_plane[at];
        touched = true;
      }
      a = __fadd_rn(a, __fmul_rn(ramp, v));
      w = __fadd_rn(w, ramp);
    }
    if (touched) {
      acc_plane[at] = a;
      wsum_plane[at] = w;
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
  const float lo = 0.0f;
  const float hi = sizeof(T) == 1 ? 255.0f : 65535.0f;
  dim3 grid((box_w + kBlockW - 1) / kBlockW, (box_h + kBlockH - 1) / kBlockH,
            b.num_planes);
  dim3 block(kBlockW, kRowThreads);
  const float bp = static_cast<float>(blend_px);
  if (ff != nullptr) {
    fuse_feather_kernel<T, true><<<grid, block, 0, stream>>>(
        acc, wsum, plane_elems, num_z, canvas_w, static_cast<const T*>(tiles),
        th, tw, ff, lo, hi, bp, b);
  } else {
    fuse_feather_kernel<T, false><<<grid, block, 0, stream>>>(
        acc, wsum, plane_elems, num_z, canvas_w, static_cast<const T*>(tiles),
        th, tw, nullptr, lo, hi, bp, b);
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

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
// What bounds it: memory. A pixel costs 2 B of u16 tile read, 4 B of f32
// reciprocal read (with the flatfield) and 2 B written, about 8 B per
// pixel, 34 MB per 2048^2 tile, and no arithmetic worth counting.
//
// What the design does about that:
// - The TPU kernel walks the batch in order, one tile after another,
//   because its grid runs in order on one core. Here blocks run in no
//   order, so ordering comes from a write rule instead: pixel (r, s) of
//   tile i is written only if no later valid tile j > i of the same
//   (c, z) covers that canvas pixel with its crop window. Every canvas
//   pixel then has exactly one writer, with no atomics, and the result
//   is exactly later-tile-wins. Covered pixels are not even read, so
//   overlaps cost no bandwidth. Successive batches are ordered by the
//   stream.
// - One block owns one tile row segment of kColsPerBlock columns. A row
//   outside the tile's crop window (or an invalid padding entry) exits
//   before it touches memory. The block computes once, in shared memory,
//   the canvas x-intervals that later tiles cover on its canvas row.
// - Neighbouring threads read and write neighbouring columns, so every
//   load and store is coalesced. The batch's metadata rides in the
//   kernel parameters (no device copy, no extra transfer).
// - The flatfield product is one IEEE f32 multiply (__fmul_rn, never
//   contracted), a clip and a truncating cast: byte-identical to the
//   CPU XLA path and to the host reciprocal scheme of the JAX package.
//   Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatch = 64;
constexpr int kThreads = 256;
constexpr int kColsPerBlock = 1024;

// Batch metadata, passed by value. Windows are pre-clamped to the tile.
struct Batch {
  int n;
  int c[kMaxBatch], z[kMaxBatch], y[kMaxBatch], x[kMaxBatch];
  int r0[kMaxBatch], r1[kMaxBatch];  // crop window rows [r0, r1)
  int s0[kMaxBatch], s1[kMaxBatch];  // crop window cols [s0, s1)
  int valid[kMaxBatch];
};

template <typename T, bool kWithFF>
__global__ void __launch_bounds__(kThreads)
fuse_overwrite_kernel(T* __restrict__ canvas, long long plane_elems, int num_z,
                      int canvas_w, const T* __restrict__ tiles, int th, int tw,
                      const float* __restrict__ ff, float lo, float hi, Batch b) {
  const int i = blockIdx.z;
  const int r = blockIdx.y;
  if (!b.valid[i] || r < b.r0[i] || r >= b.r1[i]) return;
  const int col0 = max(b.s0[i], static_cast<int>(blockIdx.x) * kColsPerBlock);
  const int col1 = min(b.s1[i], static_cast<int>(blockIdx.x + 1) * kColsPerBlock);
  if (col0 >= col1) return;  // block-uniform: no thread reaches the barrier

  // Canvas x-intervals [xa, xb) that later tiles of the same plane cover
  // on this canvas row; empty (0, 0) where a tile does not.
  __shared__ int xa[kMaxBatch];
  __shared__ int xb[kMaxBatch];
  const int row = b.y[i] + r;
  for (int j = threadIdx.x; j < b.n; j += blockDim.x) {
    int a = 0, e = 0;
    if (j > i && b.valid[j] && b.c[j] == b.c[i] && b.z[j] == b.z[i] &&
        row >= b.y[j] + b.r0[j] && row < b.y[j] + b.r1[j]) {
      a = b.x[j] + b.s0[j];
      e = b.x[j] + b.s1[j];
    }
    xa[j] = a;
    xb[j] = e;
  }
  __syncthreads();

  const T* src = tiles + (static_cast<size_t>(i) * th + r) * tw;
  const float* ff_row =
      kWithFF ? ff + (static_cast<size_t>(b.c[i]) * th + r) * tw : nullptr;
  T* dst = canvas +
           (static_cast<size_t>(b.c[i]) * num_z + b.z[i]) * plane_elems +
           static_cast<size_t>(row) * canvas_w + b.x[i];
  for (int s = col0 + threadIdx.x; s < col1; s += blockDim.x) {
    const int gx = b.x[i] + s;
    bool covered = false;
    for (int j = i + 1; j < b.n; ++j) covered |= (gx >= xa[j]) & (gx < xb[j]);
    if (covered) continue;
    T v = src[s];
    if (kWithFF) {
      float f = __fmul_rn(static_cast<float>(v), ff_row[s]);
      f = fminf(fmaxf(f, lo), hi);
      v = static_cast<T>(static_cast<int>(f));  // truncating, like XLA
    }
    dst[s] = v;
  }
}

template <typename T>
cudaError_t launch(void* canvas, long long plane_elems, int num_z, int canvas_w,
                   const void* tiles, int th, int tw, const float* ff,
                   const Batch& b, cudaStream_t stream) {
  const float lo = 0.0f;
  const float hi = sizeof(T) == 1 ? 255.0f : 65535.0f;
  dim3 grid((tw + kColsPerBlock - 1) / kColsPerBlock, th, b.n);
  if (ff != nullptr) {
    fuse_overwrite_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<T*>(canvas), plane_elems, num_z, canvas_w,
        static_cast<const T*>(tiles), th, tw, ff, lo, hi, b);
  } else {
    fuse_overwrite_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<T*>(canvas), plane_elems, num_z, canvas_w,
        static_cast<const T*>(tiles), th, tw, nullptr, lo, hi, b);
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
  if (n < 0 || n > kMaxBatch || th <= 0 || th > 65535 || tw <= 0 ||
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

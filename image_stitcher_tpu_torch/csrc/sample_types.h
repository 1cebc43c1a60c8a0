// The tile sample types the fusion kernels take, and the float
// arithmetic of each, as ops/fuse.py::to_storage and XLA's convert define
// it (the JAX package's ops/fuse.py on the CPU, its bar).
//
// - The wrappers pass a dtype code (ops/cuda_fuse.py::DTYPE_CODES).
// - An integer type's flatfield product and feathered mean are clipped to
//   its range, the bounds taken as floats, then truncated toward zero
//   with a saturating conversion: int32's upper bound 2147483647 is
//   2147483648.0f as a float, and __float2int_rz gives 2147483647 there,
//   as XLA's convert does. No fast-math: every conversion is exact or
//   rounded to nearest, and the truncations are the _rz intrinsics.
// - float32 takes its values as they are. float16 is widened exactly
//   (__half2float) and a float value is stored as float16 rounded to
//   nearest even (__float2half_rn), unclipped: past 65504 it is +-inf and
//   NaN stays NaN, as XLA's convert gives them. No kernel takes float64: the
//   device paths hold float64 tiles as float32, as the JAX package's
//   device arrays are float32 with 64-bit types off
//   (io/readers.py::device_dtype).
// - uint32 is only copied: the JAX package refuses its clip bounds
//   (OverflowError), so no kernel with a field or feathering takes it.

#ifndef IMAGE_STITCHER_SAMPLE_TYPES_H_
#define IMAGE_STITCHER_SAMPLE_TYPES_H_

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType {
  kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kI32 = 4, kU32 = 5, kF32 = 6,
  kF16 = 7
};

inline bool dtype_valid(int code) { return code >= kU8 && code <= kF16; }

inline int dtype_size(int code) {
  switch (code) {
    case kU8: case kI8: return 1;
    case kU16: case kI16: case kF16: return 2;
    default: return 4;
  }
}

// Sample<T>: whether T is clipped (an integer) and its bounds as floats.
template <typename T> struct Sample;
template <> struct Sample<uint8_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = 0.0f, kHi = 255.0f;
};
template <> struct Sample<int8_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = -128.0f, kHi = 127.0f;
};
template <> struct Sample<uint16_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = 0.0f, kHi = 65535.0f;
};
template <> struct Sample<int16_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = -32768.0f, kHi = 32767.0f;
};
template <> struct Sample<int32_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = -2147483648.0f, kHi = 2147483648.0f;
};
template <> struct Sample<uint32_t> {
  static constexpr bool kInt = true;
  static constexpr float kLo = 0.0f, kHi = 4294967296.0f;
};
template <> struct Sample<float> {
  static constexpr bool kInt = false;
  static constexpr float kLo = 0.0f, kHi = 0.0f;
};
template <> struct Sample<__half> {
  static constexpr bool kInt = false;
  static constexpr float kLo = 0.0f, kHi = 0.0f;
};

// A sample as float: rounded to nearest (exact for 8- and 16-bit types).
template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
}

// A float value stored as T: clipped to T's range and truncated for an
// integer T (saturating), as it is for a float T.
template <typename T>
__device__ __forceinline__ T from_float(float g) {
  if constexpr (Sample<T>::kInt) {
    g = fminf(fmaxf(g, Sample<T>::kLo), Sample<T>::kHi);
    if constexpr (sizeof(T) == 4 && static_cast<T>(-1) > 0)
      return static_cast<T>(__float2uint_rz(g));
    else if constexpr (sizeof(T) == 4)
      return static_cast<T>(__float2int_rz(g));
    else
      return static_cast<T>(static_cast<int>(g));  // in range: exact trunc
  } else {
    return static_cast<T>(g);
  }
}

// float16: widened exactly; stored rounded to nearest even, unclipped
template <>
__device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float g) {
  return __float2half_rn(g);
}

#endif  // IMAGE_STITCHER_SAMPLE_TYPES_H_

/* DeviceGuard, included by fuse_overwrite.cu and fuse_feather.cu.
 *
 * Makes `device` current for the guard's life and gives the calling thread
 * its own device back at the end, so a launch on one card never leaves the
 * caller on another (the bands of a sharded canvas live on several cards).
 */
#ifndef IMAGE_STITCHER_DEVICE_GUARD_H
#define IMAGE_STITCHER_DEVICE_GUARD_H

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : prev_(-1) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess || prev_ == device) {
      prev_ = -1;
      return;
    }
    err_ = cudaSetDevice(device);
    if (err_ != cudaSuccess) prev_ = -1;
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_;
  cudaError_t err_;
};

#endif  // IMAGE_STITCHER_DEVICE_GUARD_H

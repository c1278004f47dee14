// Block-wide helpers for kernels that give one CTA to one image row.
//
// Both kernels split a row two ways: strided (column x = threadIdx.x +
// k * blockDim.x, so neighbouring threads touch neighbouring addresses) for
// loads, stores and shared-memory sweeps, and contiguous chunks (thread t owns
// columns [t * per, (t + 1) * per)) for scans along the row, where each thread
// runs its chunk sequentially and one block scan joins the chunks.
#pragma once

#include <cuda_runtime.h>

namespace cs {

constexpr int kThreads = 256;  // every kernel here launches 256 threads

// Exclusive scan of one int per thread over the block, in thread order.
// kForwardMax: running max from the left; otherwise running min from the
// right. Threads with nothing before them get `identity`. `total`, when not
// null, receives the max (or min) over all threads. `buf` holds 2 * kThreads
// ints. Hillis-Steele with double buffering: log2(kThreads) steps.
template <bool kForwardMax>
__device__ int block_exclusive_scan(int v, int identity, int* buf, int* total) {
  const int t = threadIdx.x;
  int* a = buf;
  int* b = buf + kThreads;
  a[t] = v;
  __syncthreads();
  for (int s = 1; s < kThreads; s <<= 1) {
    int x = a[t];
    if (kForwardMax) {
      if (t >= s) x = max(x, a[t - s]);
    } else {
      if (t + s < kThreads) x = min(x, a[t + s]);
    }
    b[t] = x;
    __syncthreads();
    int* tmp = a;
    a = b;
    b = tmp;
  }
  int r;
  if (kForwardMax) {
    r = t > 0 ? a[t - 1] : identity;
  } else {
    r = t + 1 < kThreads ? a[t + 1] : identity;
  }
  if (total != nullptr) *total = kForwardMax ? a[kThreads - 1] : a[0];
  __syncthreads();  // buf may be reused by the caller
  return r;
}

// Min and max of one float per thread over the block; every thread gets both.
// `red` holds 64 floats.
__device__ inline void block_min_max(float& lo, float& hi, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = lo;
    red[32 + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[32];
  for (int k = 1; k < kThreads / 32; ++k) {
    lo = fminf(lo, red[k]);
    hi = fmaxf(hi, red[32 + k]);
  }
  __syncthreads();
}

// Raise the kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cs

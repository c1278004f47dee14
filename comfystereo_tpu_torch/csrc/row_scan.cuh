// Block-wide helpers for kernels that give one CTA to one image row.
//
// The row kernels split a row two ways: strided (column x = threadIdx.x +
// k * blockDim.x, so neighbouring threads touch neighbouring addresses) for
// loads, stores and shared-memory sweeps, and contiguous chunks (thread t owns
// columns [t * per, (t + 1) * per)) for scans along the row, where each thread
// runs its chunk sequentially and one block scan joins the chunks. The warp
// and distance kernels keep one bit per column instead (a `__ballot_sync`
// word per 32 columns in shared memory) and find a column's nearest set bit
// in its own word (`lanes_upto`, `lanes_from`) or, for the warp, with the
// warp-wide search `last_set_before`.
#pragma once

#include <cuda_runtime.h>

namespace cs {

constexpr int kThreads = 256;  // every kernel here launches 256 threads

template <typename T>
struct NoDeduce {  // keeps a parameter out of template argument deduction
  using type = T;
};

// Exclusive scan of one value (int or float) per thread over the block, in
// thread order. kForwardMax: running max from the left; otherwise running
// min from the right. Threads with nothing before them get `identity`.
// `total`, when not null, receives the max (or min) over all threads. `buf`
// holds 2 * kThreads values. Hillis-Steele with double buffering:
// log2(kThreads) steps. Max and min are exact, so the order of the steps
// does not change the result.
template <bool kForwardMax, typename T>
__device__ T block_exclusive_scan(T v, T identity, T* buf, typename NoDeduce<T>::type* total) {
  const int t = threadIdx.x;
  T* a = buf;
  T* b = buf + kThreads;
  a[t] = v;
  __syncthreads();
  for (int s = 1; s < kThreads; s <<= 1) {
    T x = a[t];
    if (kForwardMax) {
      if (t >= s && a[t - s] > x) x = a[t - s];
    } else {
      if (t + s < kThreads && a[t + s] < x) x = a[t + s];
    }
    b[t] = x;
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }
  T r;
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
// `red` holds 2 * kThreads / 32 floats.
__device__ inline void block_min_max(float& lo, float& hi, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kThreads / 32;
  if (lane == 0) {
    red[warp] = lo;
    red[kWarps + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[kWarps];
  for (int k = 1; k < kWarps; ++k) {
    lo = fminf(lo, red[k]);
    hi = fmaxf(hi, red[kWarps + k]);
  }
  __syncthreads();
}

// Lanes at or below, and at or above, this lane.
__device__ __forceinline__ unsigned lanes_upto(int lane) { return 0xffffffffu >> (31 - lane); }
__device__ __forceinline__ unsigned lanes_from(int lane) { return 0xffffffffu << lane; }

// Column of the last set bit of words[0, g), or -1: the whole warp searches
// back from word g - 1, 32 words a step (one ballot each), and every lane
// gets the result. Bit b of word k is column 32 k + b.
__device__ inline int last_set_before(const unsigned* words, int g) {
  const int lane = threadIdx.x & 31;
  for (int top = g - 1; top >= 0; top -= 32) {
    const unsigned v = top - lane >= 0 ? words[top - lane] : 0u;
    const unsigned hit = __ballot_sync(0xffffffffu, v != 0u);
    if (hit != 0u) {
      const int near = __ffs(hit) - 1;  // the nearest word with a set bit
      const unsigned word = __shfl_sync(0xffffffffu, v, near);
      return (top - near) * 32 + 31 - __clz(word);
    }
  }
  return -1;
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

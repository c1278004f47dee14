// Bounded-displacement gather along the last axis: out[r, j] = values[r, idx[r', j]].
//
// Replaces the Pallas kernel `bounded_take_along_w` / `_bounded_gather_2d` /
// `_kernel` (comfystereo_tpu/pallas/gather.py). values are [R, M] rows of a
// 4-byte type (float32 or int32: the kernel copies bits, so it is bit-equal
// to torch.gather for both); idx are [R_i, N] int32 rows; index row r' serves
// `rep` consecutive groups of `inner` value rows, so one [B, 1, H, N] index
// plane gathers every channel of a [B, C, H, M] image (rep = C, inner = H),
// and rep = inner = 1 is the plain row-for-row case.
//
// Bound on Hopper: bytes. Each value, index and output element is read or
// written once: 4 B per value, 4 B per index, 4 B per output; there is no
// arithmetic to speak of. The TPU kernel built each output vreg from (2K+1)
// in-vreg gathers of the neighbouring source vregs, because the TPU has no
// fast scalar gather. Here one CTA serves one index row and the `rep` value
// rows that share it: it stages the index row and each value row in shared
// memory with 16-byte cp.async copies, so each byte is read from device
// memory once whatever the indices are (the fills' binary searches gather at
// midpoints anywhere in the row window), gathers from shared memory, and
// writes 4 outputs per 16-byte store. The row map is computed once per CTA.
// A row that starts 4-byte but not 16-byte aligned (M or N not a multiple of
// 4, or a view at an offset) is staged at the same phase in shared memory,
// with a scalar head and tail. The kernel reads any column of the row, so it
// needs no displacement bound. Where the staged rows do not fit in shared
// memory (a row of more than 29,053 columns, or 14,525 for a three-channel
// plane), the direct instance serves the same rows without staging: each
// thread reads its index and gathers from device memory through the
// read-only path, which L2 holds for the row. An index outside [0, M-1] stops the kernel with a
// device-side assert, as torch.gather's own CUDA kernel does; the CPU path
// raises at once.
#include <cassert>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // shared memory one CTA may opt in to on sm_90

// Words of shared memory for a staged row of n words: up to 3 words of
// phase in front, rounded up to 16 bytes.
__host__ __device__ constexpr int slot(int n) { return (n + 3 + 3) & ~3; }

__device__ __forceinline__ int phase_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Word i of src goes to dst[phase + i], phase = phase_of(src), so each
// 16-byte aligned chunk of src lands 16-byte aligned in shared memory; the
// unaligned head and tail words are copied one by one. dst is 16-byte aligned.
__device__ __forceinline__ void stage_row(unsigned* dst, const unsigned* src, int n) {
  const int phase = phase_of(src);
  const int head = min((4 - phase) & 3, n);
  const int body = (n - head) >> 2;
  const int tail = n - head - 4 * body;
  const uint32_t sdst = static_cast<uint32_t>(__cvta_generic_to_shared(dst + phase));
  for (int i = threadIdx.x; i < body; i += kThreads) {
    const int w = head + 4 * i;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sdst + 4 * w),
                 "l"(src + w)
                 : "memory");
  }
  for (int i = threadIdx.x; i < head + tail; i += kThreads) {
    const int w = i < head ? i : head + 4 * body + (i - head);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sdst + 4 * w), "l"(src + w)
                 : "memory");
  }
}

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const unsigned* __restrict__ values, const int* __restrict__ idx,
    unsigned* __restrict__ out, int m, int n, int rep, int inner) {
  extern __shared__ __align__(16) unsigned smem[];
  const int ir = blockIdx.x;  // index row
  // The value (and output) rows of index row ir: first + c * inner, c < rep.
  const long long first = static_cast<long long>(ir / inner) * rep * inner + ir % inner;
  const int* irow = idx + static_cast<long long>(ir) * n;
  unsigned* sidx = smem;
  unsigned* svals = smem + slot(n);

  stage_row(sidx, reinterpret_cast<const unsigned*>(irow), n);
  for (int c = 0; c < rep; ++c)
    stage_row(svals + c * slot(m), values + (first + static_cast<long long>(c) * inner) * m, m);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int* si = reinterpret_cast<const int*>(sidx) + phase_of(irow);
  for (int c = 0; c < rep; ++c) {
    const long long r = first + static_cast<long long>(c) * inner;
    const unsigned* sv = svals + c * slot(m) + phase_of(values + r * m);
    unsigned* orow = out + r * n;
    const int ophase = phase_of(orow);
    const int head = min((4 - ophase) & 3, n);
    const int body = (n - head) >> 2;
    const int tail = n - head - 4 * body;
    // Output word j and index word j share a 16-byte phase when the two rows
    // start at the same phase: one 16-byte shared load of 4 indices.
    const bool same = ophase == phase_of(irow);
    for (int i = threadIdx.x; i < body; i += kThreads) {
      const int j = head + 4 * i;
      int4 k;
      if (same) {
        k = *reinterpret_cast<const int4*>(si + j);
      } else {
        k = make_int4(si[j], si[j + 1], si[j + 2], si[j + 3]);
      }
      assert(k.x >= 0 && k.x < m && k.y >= 0 && k.y < m && k.z >= 0 && k.z < m && k.w >= 0 &&
             k.w < m);
      *reinterpret_cast<uint4*>(orow + j) = make_uint4(sv[k.x], sv[k.y], sv[k.z], sv[k.w]);
    }
    for (int i = threadIdx.x; i < head + tail; i += kThreads) {
      const int j = i < head ? i : head + 4 * body + (i - head);
      const int k = si[j];
      assert(k >= 0 && k < m);
      orow[j] = sv[k];
    }
  }
}

// The rows too wide to stage: the same row map, each output word gathered
// from device memory.
__global__ void __launch_bounds__(kThreads) gather_rows_direct_kernel(
    const unsigned* __restrict__ values, const int* __restrict__ idx,
    unsigned* __restrict__ out, int m, int n, int rep, int inner) {
  const int ir = blockIdx.x;  // index row
  const long long first = static_cast<long long>(ir / inner) * rep * inner + ir % inner;
  const int* irow = idx + static_cast<long long>(ir) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int k = __ldg(irow + j);
    assert(k >= 0 && k < m);
    for (int c = 0; c < rep; ++c) {
      const long long r = first + static_cast<long long>(c) * inner;
      out[r * n + j] = __ldg(values + r * m + k);
    }
  }
}

}  // namespace

// values: [rows, m] 4-byte elements; idx: [rows / rep, n] int32 (see above);
// out: [rows, n]; every pointer 4-byte aligned. Staged rows take
// 4 * (rep * slot(m) + slot(n)) bytes of shared memory (the rule of
// kernels/gather.py); where that is over what a CTA holds, the direct
// instance runs. Returns the cudaError_t of the launch.
extern "C" int cs_gather_rows_b32(const void* values, const void* idx, void* out, int rows,
                                  int m, int n, int rep, int inner, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (m <= 0 || n < 0 || rep <= 0 || inner <= 0 || rows % (rep * inner) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4ll * (static_cast<long long>(rep) * slot(m) + slot(n));
  if (smem > kMaxSmem) {
    gather_rows_direct_kernel<<<rows / rep, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(values), static_cast<const int*>(idx),
        static_cast<unsigned*>(out), m, n, rep, inner);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_rows_kernel<<<rows / rep, kThreads, static_cast<int>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(values), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), m, n, rep, inner);
  return static_cast<int>(cudaGetLastError());
}

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
// Bound on Hopper: bytes. Per output element it reads one index (4 B) and one
// value (4 B) and writes one value (4 B); there is no arithmetic to speak of.
// The TPU kernel built each output vreg from (2K+1) in-vreg gathers of the
// neighbouring source vregs, because the TPU has no fast scalar gather. Here
// one thread serves one output element: index loads and output stores are
// coalesced, and the value loads, which fall within max_disp of the output
// column (the callers' contract), are near-diagonal, so L1 and L2 serve them.
// The kernel reads any column of the row, so it needs no displacement bound.
// An index outside [0, M-1] stops the kernel with a device-side assert, as
// torch.gather's own CUDA kernel does; the CPU path raises at once.
#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const unsigned int* __restrict__ values, const int* __restrict__ idx,
    unsigned int* __restrict__ out, int rows, int m, int n, int rep, int inner) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long irow = static_cast<long long>(r / (rep * inner)) * inner + r % inner;
    const int i = idx[irow * n + j];
    assert(i >= 0 && i < m);
    out[static_cast<long long>(r) * n + j] = values[static_cast<long long>(r) * m + i];
  }
}

}  // namespace

// values: [rows, m] 4-byte elements; idx: [rows / rep, n] int32 (see above);
// out: [rows, n]. Returns the cudaError_t of the launch.
extern "C" int cs_gather_rows_b32(const void* values, const void* idx, void* out, int rows,
                                  int m, int n, int rep, int inner, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (m <= 0 || rep <= 0 || inner <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(values), static_cast<const int*>(idx),
      static_cast<unsigned int*>(out), rows, m, n, rep, inner);
  return static_cast<int>(cudaGetLastError());
}

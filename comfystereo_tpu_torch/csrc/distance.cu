// Row-wise distance to the nearest edge pixel, for two edge masks at once.
//
// Replaces the Pallas kernel `edge_distances` / `_dist_kernel`
// (comfystereo_tpu/pallas/distance.py). For every pixel of an [N, W] pair of
// boolean masks it writes, per mask, min(col - l_col, r_col - col) as float32,
// where l_col is the nearest True at or left of col (-1e9 when none) and r_col
// the nearest True at or right of it (1e9 when none). Outputs are integers, or
// the 1e9-based sentinel, so they compare bit for bit with the plain version.
//
// Bound on Hopper: bytes. Each pixel reads 2 mask bytes and writes 8 output
// bytes, and the scan does a few integer operations per pixel. The TPU kernel
// ran log-step lane shifts over the whole row; here one CTA owns one row:
// masks are staged once in shared memory with coalesced loads, each thread
// scans a contiguous chunk sequentially, one block scan joins the chunks, and
// the outputs are written with coalesced strided stores.
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;

__global__ void __launch_bounds__(kThreads) edge_distances_kernel(
    const unsigned char* __restrict__ mask_a, const unsigned char* __restrict__ mask_b,
    float* __restrict__ dist_a, float* __restrict__ dist_b, int w) {
  extern __shared__ int smem[];
  int* s_la = smem;             // nearest True at or left, mask a (-1: none)
  int* s_ra = s_la + w;         // nearest True at or right, mask a (w: none)
  int* s_lb = s_ra + w;
  int* s_rb = s_lb + w;
  unsigned char* s_ma = reinterpret_cast<unsigned char*>(s_rb + w);
  unsigned char* s_mb = s_ma + w;
  __shared__ int s_scan[2 * kThreads];

  const long long base = static_cast<long long>(blockIdx.x) * w;
  const int tid = threadIdx.x;
  for (int x = tid; x < w; x += kThreads) {
    s_ma[x] = mask_a[base + x];
    s_mb[x] = mask_b[base + x];
  }
  __syncthreads();

  const int per = (w + kThreads - 1) / kThreads;
  const int x0 = min(tid * per, w), x1 = min(x0 + per, w);
  int last_a = -1, last_b = -1, first_a = w, first_b = w;
  for (int x = x0; x < x1; ++x) {
    if (s_ma[x]) { last_a = x; if (first_a == w) first_a = x; }
    if (s_mb[x]) { last_b = x; if (first_b == w) first_b = x; }
  }
  int la = cs::block_exclusive_scan<true>(last_a, -1, s_scan, nullptr);
  int lb = cs::block_exclusive_scan<true>(last_b, -1, s_scan, nullptr);
  int ra = cs::block_exclusive_scan<false>(first_a, w, s_scan, nullptr);
  int rb = cs::block_exclusive_scan<false>(first_b, w, s_scan, nullptr);
  for (int x = x0; x < x1; ++x) {
    if (s_ma[x]) la = x;
    if (s_mb[x]) lb = x;
    s_la[x] = la;
    s_lb[x] = lb;
  }
  for (int x = x1 - 1; x >= x0; --x) {
    if (s_ma[x]) ra = x;
    if (s_mb[x]) rb = x;
    s_ra[x] = ra;
    s_rb[x] = rb;
  }
  __syncthreads();

  for (int x = tid; x < w; x += kThreads) {
    const float col = static_cast<float>(x);
    const float la_f = s_la[x] >= 0 ? static_cast<float>(s_la[x]) : -1e9f;
    const float ra_f = s_ra[x] < w ? static_cast<float>(s_ra[x]) : 1e9f;
    const float lb_f = s_lb[x] >= 0 ? static_cast<float>(s_lb[x]) : -1e9f;
    const float rb_f = s_rb[x] < w ? static_cast<float>(s_rb[x]) : 1e9f;
    dist_a[base + x] = fminf(col - la_f, ra_f - col);
    dist_b[base + x] = fminf(col - lb_f, rb_f - col);
  }
}

}  // namespace

// masks: [n, w] bool (one byte each); dists: [n, w] float32. Returns the
// cudaError_t of the launch.
extern "C" int cs_edge_distances(const void* mask_a, const void* mask_b, void* dist_a,
                                 void* dist_b, int n, int w, void* stream) {
  if (n == 0 || w == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(w) * sizeof(int) + 2 * static_cast<size_t>(w);
  cudaError_t err = cs::allow_dynamic_smem(edge_distances_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_distances_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask_a), static_cast<const unsigned char*>(mask_b),
      static_cast<float*>(dist_a), static_cast<float*>(dist_b), w);
  return static_cast<int>(cudaGetLastError());
}

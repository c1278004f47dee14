// Row-wise distance to the nearest edge pixel, for two edge masks at once,
// and the depth blur's edge weights formed from it.
//
// Replaces the Pallas kernel `edge_distances` / `_dist_kernel`
// (comfystereo_tpu/pallas/distance.py). For every pixel of an [N, W] pair of
// boolean masks it finds, per mask, min(col - l_col, r_col - col) as
// float32, where l_col is the nearest True at or left of col (-1e9 when
// none) and r_col the nearest True at or right of it (1e9 when none).
// Outputs are integers, or the 1e9-based sentinel, so they compare bit for
// bit with the plain version. Two entries share the device code:
//   - `cs_edge_distances` takes the two masks and writes the distances (the
//     Pallas contract);
//   - `cs_edge_weights` takes the blur's 0-255 depth and forms, per pixel,
//     the Sobel-x gradient (ops/blur.py:sobel_x: [1,2,1] down the image with
//     its top and bottom rows repeated, `(a + 2b) + c`, then the central
//     difference along the row with its ends repeated), the edge strength
//     clamp(|g| / (10 * threshold), 0, 1) and both masks (g > 0 or g < 0,
//     strength > 0.5), and writes the weights clamp(1 - dist / radius, 0,
//     1) ^ falloff with PyTorch's pow (ops/blur.py:_edge_weights_plain).
//     The neighbour rows come from L2; the masks never leave the CTA.
//
// One CTA of 256 threads per row; each warp takes 32 neighbouring columns at
// a time and turns their mask bits into one `__ballot_sync` word per mask.
// After a barrier, one warp per mask scans the row's words (60 at W = 1920)
// by shuffles for the last set column up to each word and the first from
// each word on; after a second barrier each column finds its nearest edge
// on either side in its own word (`__clz`, `__ffs`) or by one lookup in
// those arrays. Shared memory: 24 B per 32 columns, so rows up to 309,920
// columns; a wider row (up to 2^24 columns, where float32 still counts
// every column) keeps the words and scans in a device-memory workspace of
// one row per CTA, and each CTA walks rows at a stride of the grid (the
// kGlobal instances). The fused entry reads
// the columns on either side itself (L1 holds them) rather than waiting on
// a shuffle. Bound on Hopper: bytes, 12 per pixel
// through the fused entry (depth in, two weights out), 10 through the mask
// entry. Built with -fmad=false;
// the divisions are IEEE, as the plain version's (ops/blur.py divides truly
// on every device).
#include <cuda_runtime.h>
#include <limits.h>

#include "row_scan.cuh"
#include "torch_math.cuh"

namespace {

using cs::kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLarge = 1e9f;

struct Args {
  const unsigned char* mask_a;  // mask entry: [n, w] bool each
  const unsigned char* mask_b;
  const float* depth;  // fused entry: [n, w], rows of n / height images
  int height;
  float threshold10;  // float32(10 * edge_threshold), as ops/blur.py rounds it
  float radius, falloff;
  int pow_mode;
  float* out_a;  // distances (mask entry) or weights (fused), [n, w] each
  float* out_b;
  int* workspace;  // kGlobal: row_words(w) words per CTA
  int n, w;
};

constexpr int kMaxWidth = 1 << 24;  // float32 counts every column below it

// 4-byte words of one row's words and scans: 6 per 32 columns.
__host__ __device__ inline size_t row_words(int w) {
  return 6 * static_cast<size_t>((w + 31) / 32);
}

// (a + 2b) + c of the rows above, at and below (repeated at the image's top
// and bottom), at column x.
__device__ __forceinline__ float smooth(const float* up, const float* mid, const float* down,
                                        int x) {
  return (__ldg(up + x) + 2.0f * __ldg(mid + x)) + __ldg(down + x);
}

__device__ __forceinline__ float weight(float dist, const Args& a) {
  const float v = fminf(fmaxf(1.0f - dist / a.radius, 0.0f), 1.0f);
  return cs::torch_pow(v, a.falloff, a.pow_mode);
}

// For each word g of one mask: the last set column in words [0, g] (-1 if
// none) and the first in words [g, n) (INT_MAX if none). One warp, 32 words
// a step: an inclusive max scan forward and a min scan backward by shuffles.
__device__ void scan_words(const unsigned* words, int n, int* last, int* first) {
  const int lane = threadIdx.x & 31;
  int carry = -1;
  for (int g0 = 0; g0 < n; g0 += 32) {
    const int g = g0 + lane;
    const unsigned v = g < n ? words[g] : 0u;
    int m = v != 0u ? g * 32 + 31 - __clz(v) : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, m, o);
      if (lane >= o) m = max(m, t);
    }
    m = max(m, carry);
    if (g < n) last[g] = m;
    carry = __shfl_sync(kFull, m, 31);
  }
  carry = INT_MAX;
  for (int g0 = (n - 1) / 32 * 32; g0 >= 0; g0 -= 32) {
    const int g = g0 + lane;
    const unsigned v = g < n ? words[g] : 0u;
    int m = v != 0u ? g * 32 + __ffs(v) - 1 : INT_MAX;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_down_sync(kFull, m, o);
      if (lane + o < 32) m = min(m, t);
    }
    m = min(m, carry);
    if (g < n) first[g] = m;
    carry = __shfl_sync(kFull, m, 0);
  }
}

// One row. Per mask at `s_mem` (shared memory or the CTA's workspace): its
// words, then the last set column up to each word and the first from each
// word on.
template <bool kFused>
__device__ __forceinline__ void distance_row(const Args& a, int row, int* s_mem) {
  const int w = a.w;
  const int n = (w + 31) / 32;
  unsigned* s_words = reinterpret_cast<unsigned*>(s_mem);  // mask a's, then b's
  int* s_last = s_mem + 2 * n;
  int* s_first = s_mem + 4 * n;
  const long long at0 = static_cast<long long>(row) * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const unsigned char* mask_a = kFused ? nullptr : a.mask_a + at0;
  const unsigned char* mask_b = kFused ? nullptr : a.mask_b + at0;
  float* out_a = a.out_a + at0;
  float* out_b = a.out_b + at0;
  const float *up = nullptr, *mid = nullptr, *down = nullptr;
  if (kFused) {
    const int y = row % a.height;
    mid = a.depth + at0;
    up = y > 0 ? mid - w : mid;
    down = y + 1 < a.height ? mid + w : mid;
  }
  // 1. Mask bits to words. The fused entry forms the gradient from the
  // smoothed columns on either side (clamped to the row: its ends repeat).
  for (int base = warp * 32; base < w; base += kThreads) {
    const int x = base + lane;
    bool ea = false, eb = false;
    if (kFused) {
      const int xc = min(x, w - 1);
      const float g = smooth(up, mid, down, min(xc + 1, w - 1)) -
                      smooth(up, mid, down, max(xc - 1, 0));
      const bool strong = fminf(fmaxf(fabsf(g) / a.threshold10, 0.0f), 1.0f) > 0.5f;
      ea = x < w && g > 0.0f && strong;
      eb = x < w && g < 0.0f && strong;
    } else if (x < w) {
      ea = mask_a[x] != 0;
      eb = mask_b[x] != 0;
    }
    const unsigned wa = __ballot_sync(kFull, ea);
    const unsigned wb = __ballot_sync(kFull, eb);
    if (lane == 0) {
      s_words[base >> 5] = wa;
      s_words[n + (base >> 5)] = wb;
    }
  }
  __syncthreads();
  // 2. Warps 0 and 1 scan mask a's and mask b's words.
  if (warp < 2) scan_words(s_words + warp * n, n, s_last + warp * n, s_first + warp * n);
  __syncthreads();

  // 3. Each column: its own word, else one lookup on either side.
  for (int base = warp * 32; base < w; base += kThreads) {
    const int x = base + lane, g = base >> 5;
    if (x >= w) break;
    const float col = static_cast<float>(x);
    float dist[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned own = s_words[m * n + g];
      const unsigned at_left = own & cs::lanes_upto(lane);
      const unsigned at_right = own & cs::lanes_from(lane);
      const int l_col = at_left != 0u ? base + 31 - __clz(at_left)
                                      : (g > 0 ? s_last[m * n + g - 1] : -1);
      const int r_col = at_right != 0u ? base + __ffs(at_right) - 1
                                       : (g + 1 < n ? s_first[m * n + g + 1] : INT_MAX);
      const float lf = l_col >= 0 ? static_cast<float>(l_col) : -kLarge;
      const float rf = r_col != INT_MAX ? static_cast<float>(r_col) : kLarge;
      dist[m] = fminf(col - lf, rf - col);
    }
    if (kFused) {
      out_a[x] = weight(dist[0], a);
      out_b[x] = weight(dist[1], a);
    } else {
      out_a[x] = dist[0];
      out_b[x] = dist[1];
    }
  }
}

// kGlobal: the words and scans live in the workspace, and each CTA takes
// rows blockIdx.x, blockIdx.x + gridDim.x, ...; otherwise one row per CTA
// with them in shared memory.
template <bool kFused, bool kGlobal>
__global__ void __launch_bounds__(kThreads) edge_distances_kernel(Args a) {
  extern __shared__ int s_mem[];
  if (!kGlobal) {
    distance_row<kFused>(a, blockIdx.x, s_mem);
    return;
  }
  int* words = a.workspace + blockIdx.x * row_words(a.w);
  for (int row = blockIdx.x; row < a.n; row += gridDim.x) {
    distance_row<kFused>(a, row, words);
    __syncthreads();  // the next row overwrites the words
  }
}

// ctas: the grid of the kGlobal instances (each with row_words(w) words of
// workspace); 0 when the words fit in shared memory.
template <bool kFused>
int launch(const Args& a, int ctas, void* stream) {
  if (a.n == 0 || a.w == 0) return 0;
  if (a.w > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    if (a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    edge_distances_kernel<kFused, true><<<ctas, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * row_words(a.w);
  cudaError_t err = cs::allow_dynamic_smem(edge_distances_kernel<kFused, false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_distances_kernel<kFused, false><<<a.n, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// masks: [n, w] bool (one byte each); dists: [n, w] float32. Rows of up to
// 309,920 columns take ctas = 0 and no workspace; wider ones a grid of
// `ctas` CTAs and a workspace of ctas * row_words(w) 4-byte words. Returns
// the cudaError_t of the launch.
extern "C" int cs_edge_distances(const void* mask_a, const void* mask_b, void* dist_a,
                                 void* dist_b, void* workspace, int ctas, int n, int w,
                                 void* stream) {
  Args a{};
  a.mask_a = static_cast<const unsigned char*>(mask_a);
  a.mask_b = static_cast<const unsigned char*>(mask_b);
  a.out_a = static_cast<float*>(dist_a);
  a.out_b = static_cast<float*>(dist_b);
  a.workspace = static_cast<int*>(workspace);
  a.n = n;
  a.w = w;
  return launch<false>(a, ctas, stream);
}

// depth: [n, w] float32 0-255, rows of n / height images; weights: [n, w]
// float32 (left eye's edges, then the right eye's). threshold10 is
// float32(10 * edge_threshold); pow_mode from kernels/_common.py:pow_mode.
// Otherwise as cs_edge_distances.
extern "C" int cs_edge_weights(const void* depth, void* weight_a, void* weight_b,
                               void* workspace, int ctas, int n, int w, int height,
                               float threshold10, float radius, float falloff, int pow_mode,
                               void* stream) {
  Args a{};
  a.depth = static_cast<const float*>(depth);
  a.height = height;
  a.threshold10 = threshold10;
  a.radius = radius;
  a.falloff = falloff;
  a.pow_mode = pow_mode;
  a.out_a = static_cast<float*>(weight_a);
  a.out_b = static_cast<float*>(weight_b);
  a.workspace = static_cast<int*>(workspace);
  a.n = n;
  a.w = w;
  return launch<true>(a, ctas, stream);
}

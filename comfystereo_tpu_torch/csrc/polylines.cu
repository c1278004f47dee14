// Supersampled polylines renderer of image rows (the legacy polylines_soft /
// polylines_sharp fills and the hybrid_edge_plus backfill when
// polylines_exact=False): colour sums over S sub-samples, float32 out.
//
// Replaces the Pallas kernel `polylines_scanline` / `_poly_kernel`
// (comfystereo_tpu/pallas/polylines_kernel.py) and computes what it computes,
// in its float32 expression forms, for one image row per CTA:
//
//   1. the row's x, coord and colour planes go to shared memory;
//   2. on the row's W + 1 slots, each thread builds its contiguous chunk of
//      the two endpoint streams (right endpoints of the positive group's
//      member segments, left endpoints of the negative group's), and a chunk
//      scan joined by one block scan turns them into the prefix max and the
//      suffix min, in shared memory;
//   3. per column (strided over the threads): the two windowed binary
//      searches of the Pallas kernel's fixed number of rounds, unfrozen
//      (`search_up`, `search_dn`), give each group's base slot;
//   4. each group's 2K (sharp) or K (soft) candidate segments, in the sweep
//      order (upward: between then within; downward: within then between),
//      are reduced to one key each in registers: the right end (upward) or
//      left end (downward) of a member segment with x1 > x0, else -inf /
//      +inf. A sample s hits candidate j where key > s (upward) or key < s
//      (downward), which is the kernel's `hit`;
//   5. per sample s = col + (t + 0.5) / S, t = 0..S-1 in order: each group's
//      first hit is rebuilt from shared memory (its ends, closenesses and
//      colour columns, by the same expressions that made its key) and
//      interpolated; the closer covering group wins, with the kernel's
//      `neither` fallback; the colour is added to the sum.
//
// Bound on Hopper: bytes and operations are of the same size. Per pixel it
// moves 32 bytes (x, coord and three colours in, three sums out); per pixel
// and sample it tests the two groups' keys up to their first hits and blends
// the two winners (an IEEE division and 4 + 3C products and sums each).
// chip_smoke.py (polylines_ss_work) counts both from this code and its
// inputs. The TPU kernel gathered candidate points with per-vreg dynamic
// gathers and rebuilt every candidate for every sample; here the candidates'
// hit tests are one compare each on register keys, and only the two winners
// touch shared memory. Built with -fmad=false, never fast math: the
// division and every product and sum round as the plain version's.
#include <cuda_runtime.h>
#include <math.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;
constexpr int kK = 4;  // k_candidates, the K of the JAX package

struct Row {  // one row staged in shared memory
  const float* x;
  const float* co;
  const float* col;  // c planes of w floats
  int w;
  float hw;  // half width of a pixel's flat top: 0.45 sharp, 0 soft
};

// One candidate segment: ends, closenesses, colour columns, membership.
struct Seg {
  float x0, x1, cl0, cl1;
  int c_l, c_r;
  bool ok;  // member & x1 > x0: may be hit at all
};

// Candidate k of a group (`iter_candidates`): the segment from point
// base + k - 1 to point base + k (within: the flat top of point base + k).
template <bool kUpward>
__device__ __forceinline__ Seg segment(const Row& r, int base, int k, bool within) {
  const int w = r.w;
  const int slot = base + k;
  const bool sl = slot == 0, sr = slot == w;
  const int pl = min(max(slot - 1, 0), w - 1), pr = min(max(slot, 0), w - 1);
  const float xr = r.x[pr], cor = r.co[pr];
  const bool m_r = (kUpward ? cor : -cor) >= 0.0f;
  Seg s;
  if (within) {
    s.x0 = xr - r.hw;
    s.x1 = xr + r.hw;
    s.cl0 = s.cl1 = fabsf(cor);
    s.c_l = s.c_r = pr;
    s.ok = m_r && slot < w && slot >= 0 && s.x1 > s.x0;
    return s;
  }
  const float wf = static_cast<float>(w);
  const float col = r.co[pl];
  const bool m_l = (kUpward ? col : -col) >= 0.0f;
  s.x0 = sl ? -1.0f * wf : r.x[pl] + r.hw;
  s.x1 = sr ? 2.0f * wf : xr - r.hw;
  s.cl0 = sl ? 0.0f : fabsf(col);
  s.cl1 = sr ? 0.0f : fabsf(cor);
  s.c_l = sl ? pr : pl;
  s.c_r = sr ? pl : pr;
  s.ok = (sl || sr || m_l || m_r) && slot >= 0 && slot <= w && s.x1 > s.x0;
  return s;
}

// Candidate j in the group's sweep order: sharp pairs (between, within)
// upward and (within, between) downward; downward offsets count 0, -1, ...
template <bool kSharp, bool kUpward>
__device__ __forceinline__ Seg candidate(const Row& r, int base, int j) {
  const int i = kSharp ? j >> 1 : j;
  const bool within = kSharp && ((j & 1) == (kUpward ? 1 : 0));
  return segment<kUpward>(r, base, kUpward ? i : -i, within);
}

// One group's sample (`sweep`): covered, closeness, colour and its fallback
// (the left colour), found.
struct Pick {
  bool covered, found;
  float closeness;
  float color[3], fallback[3];
};

template <bool kSharp, bool kUpward>
__device__ __forceinline__ Pick pick(const Row& r, int base, const float (&keys)[2 * kK],
                                     float s, int c) {
  constexpr int kCands = kSharp ? 2 * kK : kK;
  int hit = -1;
#pragma unroll
  for (int j = kCands - 1; j >= 0; --j) {  // the first hit in sweep order
    if (kUpward ? keys[j] > s : keys[j] < s) hit = j;
  }
  Seg g{0.0f, 1.0f, 0.0f, 0.0f, -1, -1, false};
  if (hit >= 0) g = candidate<kSharp, kUpward>(r, base, hit);
  const float denom = fabsf(g.x1 - g.x0) < 1e-9f ? 1.0f : g.x1 - g.x0;
  const float ip = fminf(fmaxf((s - g.x0) / denom, 0.0f), 1.0f);
  Pick p;
  p.found = hit >= 0;
  p.covered = p.found && g.x0 < s && s < g.x1;
  p.closeness = g.cl0 * (1.0f - ip) + g.cl1 * ip;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (ch >= c) break;
    const float a = p.found ? r.col[ch * r.w + g.c_l] : 0.0f;
    const float b = p.found ? r.col[ch * r.w + g.c_r] : 0.0f;
    p.color[ch] = a * (1.0f - ip) + b * ip;
    p.fallback[ch] = a;
  }
  return p;
}

template <bool kSharp>
__global__ void __launch_bounds__(kThreads) polylines_kernel(
    const float* __restrict__ xg, const float* __restrict__ cog,
    const float* __restrict__ colors, float* __restrict__ out, int w, int c, int samples,
    int max_disp, int rounds) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_co = s_x + w;
  float* s_col = s_co + w;
  float* s_hi = s_col + c * w;  // prefix max of the positive group's e_hi, W + 1 slots
  float* s_lo = s_hi + w + 1;   // suffix min of the negative group's e_lo, W + 1 slots
  __shared__ float s_scan[2 * kThreads];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float hw = kSharp ? 0.45f : 0.0f;
  const float wf = static_cast<float>(w);

  // 1. Stage the row.
  for (int i = tid; i < w; i += kThreads) {
    s_x[i] = xg[row * w + i];
    s_co[i] = cog[row * w + i];
  }
  for (int i = tid; i < w * c; i += kThreads) {
    s_col[(i % c) * w + i / c] = colors[row * w * c + i];
  }
  __syncthreads();

  // 2. Endpoint streams on slots 0..W (`endpoints`), chunk scans, block scans.
  const int slots = w + 1;
  const int per = (slots + kThreads - 1) / kThreads;
  const int j0 = min(tid * per, slots), j1 = min(j0 + per, slots);
  float run_hi = -INFINITY, run_lo = INFINITY;
  for (int j = j0; j < j1; ++j) {
    const bool sl = j == 0, sr = j == w, in_img = j < w;
    const float bx0 = sl ? -1.0f * wf : s_x[j - 1] + hw;
    const float bx1 = sr ? 2.0f * wf : s_x[j] - hw;
    const float co_prev = sl ? 0.0f : s_co[j - 1];
    const float co = in_img ? s_co[j] : 0.0f;
    const bool fwd = bx1 > bx0;
    const bool mp_in = in_img && co >= 0.0f, mn_in = in_img && co <= 0.0f;
    float e_hi = (sl || sr || co_prev >= 0.0f || mp_in) && fwd ? bx1 : -1e30f;
    float e_lo = (sl || sr || co_prev <= 0.0f || mn_in) && fwd ? bx0 : 1e30f;
    if (kSharp) {
      e_hi = fmaxf(e_hi, mp_in ? s_x[j] + hw : -1e30f);
      e_lo = fminf(e_lo, mn_in ? s_x[j] - hw : 1e30f);
    }
    run_hi = fmaxf(run_hi, e_hi);
    s_hi[j] = run_hi;
    s_lo[j] = e_lo;
  }
  for (int j = j1 - 1; j >= j0; --j) {
    run_lo = fminf(run_lo, s_lo[j]);
    s_lo[j] = run_lo;
  }
  const float carry_hi = cs::block_exclusive_scan<true>(run_hi, -INFINITY, s_scan, nullptr);
  const float carry_lo = cs::block_exclusive_scan<false>(run_lo, INFINITY, s_scan, nullptr);
  for (int j = j0; j < j1; ++j) {
    s_hi[j] = fmaxf(s_hi[j], carry_hi);
    s_lo[j] = fminf(s_lo[j], carry_lo);
  }
  __syncthreads();

  const Row r{s_x, s_co, s_col, w, hw};
  constexpr int kCands = kSharp ? 2 * kK : kK;
  for (int col = tid; col < w; col += kThreads) {
    const float colf = static_cast<float>(col);

    // 3. The two windowed binary searches (`search_up`, `search_dn`).
    int lo = max(col - max_disp, 0), hi = min(col + max_disp, w);
    for (int i = 0; i < rounds; ++i) {
      const int mid = (lo + hi) >> 1;
      const bool go = s_hi[min(mid, w)] <= colf;
      lo = go ? mid + 1 : lo;
      hi = go ? hi : mid;
    }
    const int idx_p = min(max(lo, 0), w);
    lo = max(col - max_disp, 0);
    hi = min(col + max_disp, w);
    for (int i = 0; i < rounds; ++i) {
      const int mid = (lo + hi) >> 1;
      const bool go = s_lo[min(mid, w)] < colf + 1.0f;
      lo = go ? mid + 1 : lo;
      hi = go ? hi : mid;
    }
    const int idx_n = min(max(lo - 1, 0), w);

    // 4. Hit keys of both groups' candidates.
    float keys_p[2 * kK], keys_n[2 * kK];
#pragma unroll
    for (int j = 0; j < kCands; ++j) {
      const Seg up = candidate<kSharp, true>(r, idx_p, j);
      keys_p[j] = up.ok ? up.x1 : -INFINITY;
      const Seg dn = candidate<kSharp, false>(r, idx_n, j);
      keys_n[j] = dn.ok ? dn.x0 : INFINITY;
    }

    // 5. The samples, in order (`t_body`).
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int t = 0; t < samples; ++t) {
      const float s = colf + (static_cast<float>(t) + 0.5f) / static_cast<float>(samples);
      const Pick p = pick<kSharp, true>(r, idx_p, keys_p, s, c);
      const Pick n = pick<kSharp, false>(r, idx_n, keys_n, s, c);
      const bool use_n = n.covered && (!p.covered || n.closeness > p.closeness);
      const bool neither = !(p.covered || n.covered);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (ch >= c) break;
        float v = use_n ? n.color[ch] : p.color[ch];
        if (neither) v = p.found ? p.fallback[ch] : n.fallback[ch];
        acc[ch] = acc[ch] + v;
      }
    }
    float* o = out + (row * w + col) * c;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (ch >= c) break;
      o[ch] = acc[ch];
    }
  }
}

// Rounds of the binary searches: max(1, ceil(log2(2 * max_disp + 2))) + 1.
int search_rounds(int max_disp) {
  const long long v = 2LL * max_disp + 2;
  int r = 0;
  while ((1LL << r) < v) ++r;
  return (r > 1 ? r : 1) + 1;
}

template <bool kSharp>
int launch(const void* x, const void* co, const void* colors, void* out, int n, int w, int c,
           int samples, int max_disp, void* stream) {
  const size_t smem = (static_cast<size_t>(2 + c) * w + 2 * (static_cast<size_t>(w) + 1)) *
                      sizeof(float);
  cudaError_t err = cs::allow_dynamic_smem(polylines_kernel<kSharp>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  polylines_kernel<kSharp><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(co),
      static_cast<const float*>(colors), static_cast<float*>(out), w, c, samples, max_disp,
      search_rounds(max_disp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, coord: [n, w] float32; colors, out: [n, w, c] float32 (HWC rows, c of 1
// to 3); out receives the colour sums over `samples` sub-samples. k_candidates
// must be 4. Returns the cudaError_t of the launch.
extern "C" int cs_polylines_rows(const void* x, const void* coord, const void* colors,
                                 void* out, int n, int w, int c, int sharp, int samples,
                                 int k_candidates, int max_disp, void* stream) {
  if (n == 0 || w == 0) return 0;
  if (c < 1 || c > 3 || k_candidates != kK || samples < 1 || max_disp < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sharp ? launch<true>(x, coord, colors, out, n, w, c, samples, max_disp, stream)
               : launch<false>(x, coord, colors, out, n, w, c, samples, max_disp, stream);
}

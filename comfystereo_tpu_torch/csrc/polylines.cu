// Supersampled polylines renderer of image rows (the legacy polylines_soft /
// polylines_sharp fills and the hybrid_edge_plus backfill when
// polylines_exact=False): colour sums over S sub-samples, float32 out, or
// through the fused entry the finished uint8-valued colour.
//
// Replaces the Pallas kernel `polylines_scanline` / `_poly_kernel`
// (comfystereo_tpu/pallas/polylines_kernel.py) and computes what it computes,
// in its float32 expression forms, for one image row per CTA:
//
//   1. the row's x and coord go to shared memory (the fused entry forms x
//      from coord: x = ((col + 0.5) + coord) + sep), and the S sample
//      offsets (t + 0.5) / S;
//   2. on the row's W + 1 slots, each thread builds its contiguous chunk of
//      the two endpoint streams (right endpoints of the positive group's
//      member segments, left endpoints of the negative group's), and a chunk
//      scan joined by one block scan turns them into the prefix max and the
//      suffix min, in shared memory;
//   3. per column (strided over the threads): the two windowed binary
//      searches of the Pallas kernel's fixed number of rounds, unfrozen
//      (`search_up`, `search_dn`), give each group's base slot;
//   4. per sample s = col + (t + 0.5) / S, t = 0..S-1 in order, each group's
//      first hit: the first of its 2K (sharp) or K (soft) candidate
//      segments, in the sweep order (upward: between then within; downward:
//      within then between), that is a member segment with x1 > x0 whose
//      right end (upward) lies above s or whose left end (downward) lies
//      below it, which is the kernel's `hit`. s grows with t, so the upward
//      group's hits only drop out and its first hit only moves later, and
//      the downward group's hits only join and its first hit only moves
//      earlier. Each group therefore keeps its winner (ends, closenesses,
//      denominator, and its two colours, read from device memory through
//      the read-only path) in registers with the sample at which it can
//      change (upward: its own right end; downward: the least left end
//      before it), and looks again only there: not at all where the
//      group's bound shows that none is hit (the largest e_hi, or least
//      e_lo, of its K slots before the scans: the largest right, or least
//      left, end of its candidates that may be hit), else by building the
//      candidates from shared memory in sweep order until one is hit
//      (upward from the one after the old winner);
//   5. per sample the covering groups' winners are interpolated by the
//      kernel's expressions, the closer covering group wins (closenesses
//      only where both cover), with the kernel's `neither` fallback, and
//      the colour is added to the sum; the fused entry ends with
//      trunc(clip(sum / S + 0.5, 0, 255)), S divided in IEEE arithmetic.
//
// Bound on Hopper: bytes, with operations close behind. Per pixel it moves
// 28 bytes through the fused entry (offset and three colours in, three
// out; 32 through the sums entry, which also reads x); per pixel and sample
// it tests each group's winner, interpolates the covering ones (an IEEE
// division each) and blends one colour; the searches, and the candidates
// built where a winner is looked for, are per column. chip_smoke.py
// (polylines_ss_work) counts these from this code and its inputs. The TPU
// kernel gathered candidate points with per-vreg dynamic gathers and
// rebuilt every candidate for every sample; here a group's winner is built
// once for the samples it serves, and its colours come from device memory,
// which keeps shared memory at 6W floats per row. Colours go in groups of
// up to 3 channels: steps 4-5 run once per group (C of 1 to 3 is one
// group), so any C is taken with three accumulators. K = k_candidates (1
// to 8) is a run-time bound of the candidate loops. Rows whose planes fit
// (up to 9,598 columns at S = 8) stage them in shared memory, one row per
// CTA; wider rows keep them in a device-memory workspace of one row per CTA
// (the kGlobal instances, whose CTAs walk rows at a stride of the grid).
// Built with -fmad=false,
// never fast math: the divisions and every product and sum round as the
// plain version's.
#include <cuda_runtime.h>
#include <math.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;
constexpr int kMaxK = 8;  // the largest k_candidates (K) the kernel takes

struct Row {  // one row's staged planes, its colours in device memory
  const float* x;
  const float* co;
  const float* img;  // [w, c] HWC, at the group's first channel
  int w, c;
  int cg;    // channels in the group, 1 to 3
  float hw;  // half width of a pixel's flat top: 0.45 sharp, 0 soft
};

// One candidate segment: ends, closenesses, colour columns, membership.
struct Seg {
  float x0, x1, cl0, cl1;
  int c_l, c_r;
  bool ok;  // member & x1 > x0: may be hit at all
};

// Candidate k of a group (`iter_candidates`): the segment from point
// base + k - 1 to point base + k (within: the flat top of point base + k),
// with points pl = clamp(base + k - 1) and pr = clamp(base + k) given by
// their x and coord.
template <bool kUpward>
__device__ __forceinline__ Seg segment(int w, float hw, int slot, float xl, float col,
                                       float xr, float cor, int pl, int pr, bool within) {
  const bool sl = slot == 0, sr = slot == w;
  const bool m_r = (kUpward ? cor : -cor) >= 0.0f;
  Seg s;
  if (within) {
    s.x0 = xr - hw;
    s.x1 = xr + hw;
    s.cl0 = s.cl1 = fabsf(cor);
    s.c_l = s.c_r = pr;
    s.ok = m_r && slot < w && slot >= 0 && s.x1 > s.x0;
    return s;
  }
  const float wf = static_cast<float>(w);
  const bool m_l = (kUpward ? col : -col) >= 0.0f;
  s.x0 = sl ? -1.0f * wf : xl + hw;
  s.x1 = sr ? 2.0f * wf : xr - hw;
  s.cl0 = sl ? 0.0f : fabsf(col);
  s.cl1 = sr ? 0.0f : fabsf(cor);
  s.c_l = sl ? pr : pl;
  s.c_r = sr ? pl : pr;
  s.ok = (sl || sr || m_l || m_r) && slot >= 0 && slot <= w && s.x1 > s.x0;
  return s;
}

// A group's winner, kept across samples: its first hit in sweep order,
// found by building the candidates from shared memory in that order
// (sharp pairs (between, within) upward and (within, between) downward;
// downward offsets count 0, -1, ...) until one is hit.
template <bool kSharp, bool kUpward>
struct Winner {
  int hit = -2;       // index in sweep order; -1: none; -2: not yet looked for
  float until;        // upward: its key; downward: the least key before it
  float x0, x1, cl0, cl1, denom;
  float a[3], b[3];   // colours of its left and right columns (0 when none)

  // The first hit at sample s (`sweep`), kept from the previous sample
  // unless s has passed the point where it can change. Upward, the
  // candidates before a kept hit stay missed, so the search goes on after
  // it; downward it starts again from the first.
  // `bound`: the largest right end (upward) or least left end (downward)
  // of the group's member segments with x1 > x0, which are its candidates'
  // keys: where it does not pass s, no candidate is hit.
  __device__ __forceinline__ void update(const Row& r, int base, float s, float bound,
                                         int k_cand) {
    if (hit != -2 && (kUpward ? s < until : !(until < s))) return;
    constexpr int kPer = kSharp ? 2 : 1;
    const int from = kUpward && hit >= 0 ? hit + 1 : 0;
    const bool none = kUpward ? !(bound > s) : !(bound < s);
    float lim = none ? bound : INFINITY;
    Seg g{0.0f, 1.0f, 0.0f, 0.0f, -1, -1, false};
    hit = -1;
    for (int i = from / kPer; i < k_cand && hit < 0 && !none; ++i) {
      const int slot = base + (kUpward ? i : -i);
      const int pl = min(max(slot - 1, 0), r.w - 1), pr = min(max(slot, 0), r.w - 1);
      const float xl = r.x[pl], col = r.co[pl], xr = r.x[pr], cor = r.co[pr];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int j = i * kPer + q;
        if (j < from || hit >= 0) continue;
        const bool within = kSharp && q == (kUpward ? 1 : 0);
        const Seg c = segment<kUpward>(r.w, r.hw, slot, xl, col, xr, cor, pl, pr, within);
        const float key = kUpward ? (c.ok ? c.x1 : -INFINITY) : (c.ok ? c.x0 : INFINITY);
        if (kUpward ? key > s : key < s) {
          hit = j;
          g = c;
        } else if (!kUpward) {
          lim = fminf(lim, key);
        }
      }
    }
    until = kUpward ? (hit >= 0 ? g.x1 : INFINITY) : lim;
    x0 = g.x0;
    x1 = g.x1;
    cl0 = g.cl0;
    cl1 = g.cl1;
    denom = fabsf(g.x1 - g.x0) < 1e-9f ? 1.0f : g.x1 - g.x0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (ch >= r.cg) break;
      a[ch] = hit >= 0 ? __ldg(r.img + static_cast<long long>(g.c_l) * r.c + ch) : 0.0f;
      b[ch] = hit >= 0 ? __ldg(r.img + static_cast<long long>(g.c_r) * r.c + ch) : 0.0f;
    }
  }

  // Covered at s (`sweep`'s `covered`), and then ip.
  __device__ __forceinline__ bool covers(float s, float& ip) const {
    if (!(hit >= 0 && x0 < s && s < x1)) return false;
    ip = fminf(fmaxf((s - x0) / denom, 0.0f), 1.0f);
    return true;
  }
};

struct Params {
  const float* x;  // the sums entry's point positions (not kFused)
  const float* co;
  float sep;
  const float* colors;
  float* out;
  float* workspace;  // kGlobal: row_words(w, samples) words per CTA
  int n, w, c, samples, k_cand, max_disp, rounds;
};

// 4-byte words of one row's planes: x and coord, the two endpoint streams on
// W + 1 slots scanned and as they are, and the sample offsets.
__host__ __device__ inline size_t row_words(int w, int samples) {
  return 2 * static_cast<size_t>(w) + 4 * (static_cast<size_t>(w) + 1) + samples;
}

// One row, its planes at `planes` (shared memory or the CTA's workspace).
// kC: the channel count when it is 3 (the colour loops then unroll), 0 for
// a count taken from c.
template <bool kSharp, bool kFused, int kC>
__device__ __forceinline__ void polylines_row(const Params& p, long long row, float* planes) {
  const float* __restrict__ xg = p.x;
  const float* __restrict__ cog = p.co;
  const float sep = p.sep;
  float* __restrict__ out = p.out;
  const int w = p.w, samples = p.samples, k_cand = p.k_cand, max_disp = p.max_disp;
  const int rounds = p.rounds;
  const int c = kC ? kC : p.c;
  float* s_x = planes;
  float* s_co = s_x + w;
  float* s_hi = s_co + w;       // prefix max of the positive group's e_hi, W + 1 slots
  float* s_lo = s_hi + w + 1;   // suffix min of the negative group's e_lo, W + 1 slots
  float* s_off = s_lo + w + 1;  // the samples' offsets (t + 0.5) / S
  float* s_ehi = s_off + samples;  // e_hi and e_lo of each slot, not scanned
  float* s_elo = s_ehi + w + 1;
  __shared__ float s_scan[2 * kThreads];

  const int tid = threadIdx.x;
  const float hw = kSharp ? 0.45f : 0.0f;
  const float wf = static_cast<float>(w);

  // 1. Stage the row and the sample offsets.
  for (int i = tid; i < w; i += kThreads) {
    const float co = cog[row * w + i];
    s_co[i] = co;
    s_x[i] = kFused ? ((static_cast<float>(i) + 0.5f) + co) + sep : xg[row * w + i];
  }
  for (int t = tid; t < samples; t += kThreads) {
    s_off[t] = (static_cast<float>(t) + 0.5f) / static_cast<float>(samples);
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
    s_ehi[j] = e_hi;
    s_elo[j] = e_lo;
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

  const float* img = p.colors + row * w * c;
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

    // A slot's e_hi (e_lo) is the largest right (least left) end of its
    // candidates that may be hit, so these bound each group's keys.
    float hi_k = -INFINITY, lo_k = INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i >= k_cand) break;
      if (idx_p + i <= w) hi_k = fmaxf(hi_k, s_ehi[idx_p + i]);
      if (idx_n - i >= 0) lo_k = fminf(lo_k, s_elo[idx_n - i]);
    }

    // 4-5. For each group of up to 3 channels, the samples, in order
    // (`t_body`). Only a covering group's ip, and both groups' closenesses
    // only where both cover, are used.
    for (int g0 = 0; g0 < c; g0 += 3) {
      const Row r{s_x, s_co, img + g0, w, c, min(c - g0, 3), hw};
      Winner<kSharp, true> wp;
      Winner<kSharp, false> wn;
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int t = 0; t < samples; ++t) {
        const float s = colf + s_off[t];
        wp.update(r, idx_p, s, hi_k, k_cand);
        wn.update(r, idx_n, s, lo_k, k_cand);
        float ip_p = 0.0f, ip_n = 0.0f;
        const bool cov_p = wp.covers(s, ip_p);
        const bool cov_n = wn.covers(s, ip_n);
        bool use_n = cov_n;
        if (cov_p && cov_n) {
          const float cl_p = wp.cl0 * (1.0f - ip_p) + wp.cl1 * ip_p;
          const float cl_n = wn.cl0 * (1.0f - ip_n) + wn.cl1 * ip_n;
          use_n = cl_n > cl_p;
        }
        const bool neither = !(cov_p || cov_n);
        const float ip = use_n ? ip_n : ip_p;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if (ch >= r.cg) break;
          float v;
          if (neither) {
            v = wp.hit >= 0 ? wp.a[ch] : wn.a[ch];
          } else {
            const float ca = use_n ? wn.a[ch] : wp.a[ch], cb = use_n ? wn.b[ch] : wp.b[ch];
            v = ca * (1.0f - ip) + cb * ip;
          }
          acc[ch] = acc[ch] + v;
        }
      }
      float* o = out + (row * w + col) * c + g0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (ch >= r.cg) break;
        o[ch] = kFused ? truncf(fminf(fmaxf(acc[ch] / static_cast<float>(samples) + 0.5f,
                                            0.0f), 255.0f))
                       : acc[ch];
      }
    }
  }
}

// kGlobal: the planes live in the workspace, and each CTA renders rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; otherwise one row per CTA with
// its planes in shared memory.
template <bool kSharp, bool kFused, int kC, bool kGlobal>
__global__ void __launch_bounds__(kThreads) polylines_kernel(Params p) {
  extern __shared__ float smem[];
  if (!kGlobal) {
    polylines_row<kSharp, kFused, kC>(p, blockIdx.x, smem);
    return;
  }
  float* planes = p.workspace + blockIdx.x * row_words(p.w, p.samples);
  for (int row = blockIdx.x; row < p.n; row += gridDim.x) {
    polylines_row<kSharp, kFused, kC>(p, row, planes);
    __syncthreads();  // the next row overwrites the planes
  }
}

// Rounds of the binary searches: max(1, ceil(log2(2 * max_disp + 2))) + 1.
int search_rounds(int max_disp) {
  const long long v = 2LL * max_disp + 2;
  int r = 0;
  while ((1LL << r) < v) ++r;
  return (r > 1 ? r : 1) + 1;
}

template <bool kSharp, bool kFused, int kC, bool kGlobal>
int launch_kernel(const Params& p, int ctas, void* stream) {
  const size_t smem = kGlobal ? 0 : row_words(p.w, p.samples) * sizeof(float);
  auto kernel = polylines_kernel<kSharp, kFused, kC, kGlobal>;
  cudaError_t err = cs::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<kGlobal ? ctas : p.n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ctas > 0 takes the workspace instances (any C).
template <bool kSharp, bool kFused>
int launch(const Params& p, int ctas, void* stream) {
  if (p.n == 0 || p.w == 0) return 0;
  if (p.c < 1 || p.k_cand < 1 || p.k_cand > kMaxK || p.samples < 1 || p.max_disp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ctas > 0) {
    if (p.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel<kSharp, kFused, 0, true>(p, ctas, stream);
  }
  return p.c == 3 ? launch_kernel<kSharp, kFused, 3, false>(p, 0, stream)
                  : launch_kernel<kSharp, kFused, 0, false>(p, 0, stream);
}

Params params(const void* x, const void* coord, float sep, const void* colors, void* out,
              void* workspace, int n, int w, int c, int samples, int k_candidates,
              int max_disp) {
  return Params{static_cast<const float*>(x), static_cast<const float*>(coord), sep,
                static_cast<const float*>(colors), static_cast<float*>(out),
                static_cast<float*>(workspace), n, w, c, samples, k_candidates, max_disp,
                search_rounds(max_disp)};
}

}  // namespace

// x, coord: [n, w] float32; colors, out: [n, w, c] float32 (HWC rows, any c
// >= 1); out receives the colour sums over `samples` sub-samples.
// k_candidates is K, 1 to 8. Rows whose planes fit in shared memory take
// ctas = 0 and no workspace; wider ones a grid of `ctas` CTAs and a
// workspace of ctas * row_words(w, samples) 4-byte words. Returns the
// cudaError_t of the launch.
extern "C" int cs_polylines_rows(const void* x, const void* coord, const void* colors,
                                 void* out, void* workspace, int ctas, int n, int w, int c,
                                 int sharp, int samples, int k_candidates, int max_disp,
                                 void* stream) {
  const Params p = params(x, coord, 0.0f, colors, out, workspace, n, w, c, samples,
                          k_candidates, max_disp);
  return sharp ? launch<true, false>(p, ctas, stream) : launch<false, false>(p, ctas, stream);
}

// The fused entry: x = ((col + 0.5) + coord) + sep is formed in the kernel
// (sep the separation in pixels as float32), and out receives
// trunc(clip(sum / samples + 0.5, 0, 255)). Otherwise as cs_polylines_rows.
extern "C" int cs_polylines_coord(const void* coord, float sep, const void* colors, void* out,
                                  void* workspace, int ctas, int n, int w, int c, int sharp,
                                  int samples, int k_candidates, int max_disp, void* stream) {
  const Params p = params(nullptr, coord, sep, colors, out, workspace, n, w, c, samples,
                          k_candidates, max_disp);
  return sharp ? launch<true, true>(p, ctas, stream) : launch<false, true>(p, ctas, stream);
}

// Exact polylines renderer of image rows (the polylines_soft / polylines_sharp
// fills and the hybrid_edge_plus backfill), uint8-valued float32 out.
//
// Replaces the Pallas kernel `polylines_exact_scanline` / `_scan_kernel`
// (comfystereo_tpu/pallas/polylines_exact_kernel.py). It computes what the
// XLA path `_exact_core` (comfystereo_tpu/ops/polylines_exact.py) computes,
// in its float32 expression forms, for one image row per CTA:
//
//   1. the row's x and closeness go to shared memory, and the row's
//      m = x - (col + 0.5) range (block reduction) gives the candidate window
//      d = source - col in [floor(-max m) - 2, ceil(-min m) + 2], clamped to
//      +-(max_disp + 4). Every segment that can be active at a column lies in
//      it, so the per-row window finds what the XLA path's 64-row window does;
//   2. breakpoints: each column walks the window and keeps, sorted in
//      registers by a K-slot bubble insert, the K smallest points in
//      [col, col + 1) (sharp mode: x - 0.45 and x + 0.45 of each source).
//      Empty slots hold the right sentinel 2w. Any value >= col + 1 acts as
//      that sentinel does (it clips the piece to col + 1 and ends the chain),
//      so these slots equal the XLA path's sorted points q0 .. q0 + K - 1;
//   3. pieces, with `_piece_geometry`'s forms: f = max(col, xq) + eps,
//      t = min(col + 1, xq1) - eps, sig = t - f, center = f + 0.5 * sig;
//      piece 0 starts at col + eps, and piece k > 0 is valid while
//      xq < col + 1. Pieces past the first invalid one add 0.0 to an
//      accumulator of at least 0.5 in the XLA path, so they are skipped;
//   4. winner scan per valid piece, in `_winner_scan_xla`'s order: the left
//      sentinel, the right sentinel, then d ascending (sharp: the flat
//      segment before the connecting one); strict `clp > best_cl` from
//      best_cl = -eps among 0 < ip < 1, and the lowest-x0 active segment as
//      the fallback. The winner is kept as an identity (left colour column,
//      ip, flat) and its colour is built once, col_l * (1 - ip) + col_r * ip,
//      or col_l for a flat segment;
//   5. acc = 0.5 + sum over pieces of colour * sig, then trunc(clip(acc, 0, 255)).
//
// Bound on Hopper: bytes and operations give bounds of about the same size.
// Per pixel it moves 32 bytes (x, closeness and three colours in, three
// out). Per column, valid piece and in-row window step, sharp mode spends 3
// adds and 4 compares on the activity tests of its two candidates; only the
// active ones, one or two per piece, go on to the IEEE division and the
// blend. chip_smoke.py (polylines_work) counts both on its inputs, from this
// code. The TPU kernel rolled packed planes one lane per
// step over a column tile and predicated piece counts per tile; here each
// thread owns a column, keeps its breakpoints and winner state in registers,
// and reads x and closeness from shared memory, where neighbouring threads
// read neighbouring words at every step. Built with -fmad=false, never fast
// math: ip's division and every product and sum round as the plain version's.
#include <cuda_runtime.h>
#include <math.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;
constexpr int kPieces = 12;  // max_pieces, the K of the JAX package
constexpr float kEps = 1e-7f;

struct Winner {
  int id;    // left colour column; -1: no candidate, colour 0
  float ip;
  bool flat;
};

struct Scan {
  float best_cl = -kEps;
  Winner best{-1, 0.0f, true};
  float fb_x0 = 1e30f;
  Winner fb{-1, 0.0f, true};

  __device__ __forceinline__ void consider(float center, float x0, float x1, float cl0,
                                           float cl1, int id, bool flat) {
    if (!(x0 < center && x1 >= center)) return;  // not active
    const float denom = x1 - x0;
    const float safe = denom == 0.0f ? 1.0f : denom;
    const float ip = (center - x0) / safe;
    const float clp = (1.0f - ip) * cl0 + ip * cl1;
    if (ip > 0.0f && ip < 1.0f && clp > best_cl) {
      best_cl = clp;
      best = Winner{id, ip, flat};
    }
    if (x0 < fb_x0) {
      fb_x0 = x0;
      fb = Winner{id, ip, flat};
    }
  }
};

__device__ __forceinline__ void insert(float (&slots)[kPieces], float pv, float colf,
                                       float colp1) {
  if (!(pv >= colf && pv < colp1)) return;
  float carry = pv;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const float s = slots[j];
    slots[j] = fminf(s, carry);
    carry = fmaxf(s, carry);
  }
}

template <bool kSharp>
__global__ void __launch_bounds__(kThreads) polylines_exact_kernel(
    const float* __restrict__ xg, const float* __restrict__ clg,
    const float* __restrict__ colors, float* __restrict__ out, int w, int c,
    int max_disp) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_cl = smem + w;
  __shared__ float s_red[64];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float hw = kSharp ? 0.45f : 0.0f;

  // 1. Stage the row; candidate window from its m range.
  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < w; i += kThreads) {
    const float xv = xg[row * w + i];
    s_x[i] = xv;
    s_cl[i] = clg[row * w + i];
    const float m = xv - (static_cast<float>(i) + 0.5f);
    lo = fminf(lo, m);
    hi = fmaxf(hi, m);
  }
  cs::block_min_max(lo, hi, s_red);  // also orders the staging stores
  const int r_static = max_disp + 4;
  const int d_lo = max(static_cast<int>(floorf(-hi)) - 2, -r_static);
  const int d_hi = min(static_cast<int>(ceilf(-lo)) + 2, r_static);

  const float wf = static_cast<float>(w);
  const float sent_l = -wf, sent_r = 2.0f * wf;
  const float first_x = s_x[0] - hw, last_x = s_x[w - 1] + hw;
  const float cl_first = s_cl[0], cl_last = s_cl[w - 1];
  const float* img = colors + row * w * c;

  for (int col = tid; col < w; col += kThreads) {
    const float colf = static_cast<float>(col);
    const float colp1 = colf + 1.0f;

    // 2. The K smallest points in [col, col + 1), sorted.
    float slots[kPieces];
#pragma unroll
    for (int j = 0; j < kPieces; ++j) slots[j] = sent_r;
    for (int d = d_lo; d <= d_hi; ++d) {
      const int cp = col + d;
      if (cp < 0 || cp > w - 1) continue;
      const float xv = s_x[cp];
      if (kSharp) {
        insert(slots, xv - hw, colf, colp1);
        insert(slots, xv + hw, colf, colp1);
      } else {
        insert(slots, xv, colf, colp1);
      }
    }

    float acc[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      // 3. Piece geometry.
      float f;
      if (k == 0) {
        f = colf + kEps;
      } else {
        const float xq = slots[k - 1];
        if (!(xq < colp1)) break;
        f = fmaxf(colf, xq) + kEps;
      }
      const float t = fminf(colp1, slots[k]) - kEps;
      const float sig = t - f;
      const float center = f + 0.5f * sig;

      // 4. Winner scan at the piece's center.
      Scan s;
      s.consider(center, sent_l, first_x, 0.0f, cl_first, 0, true);
      s.consider(center, last_x, sent_r, cl_last, 0.0f, w - 1, true);
      for (int d = d_lo; d <= d_hi; ++d) {
        const int cp = col + d;
        if (cp < 0 || cp > w - 1) continue;
        const float xc = s_x[cp], clc = s_cl[cp];
        if (kSharp) s.consider(center, xc - hw, xc + hw, clc, clc, cp, true);
        if (cp <= w - 2) s.consider(center, xc + hw, s_x[cp + 1] - hw, clc, s_cl[cp + 1], cp, false);
      }
      const Winner win = s.best_cl > -kEps ? s.best : s.fb;

      // 5. Accumulate the winner's colour over the piece.
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (ch >= c) break;
        float cval = 0.0f;
        if (win.id >= 0) {
          const float col_l = img[static_cast<long long>(win.id) * c + ch];
          if (win.flat) {
            cval = col_l;
          } else {
            const float col_r = img[static_cast<long long>(win.id + 1) * c + ch];
            cval = col_l * (1.0f - win.ip) + col_r * win.ip;
          }
        }
        acc[ch] = acc[ch] + cval * sig;
      }
    }
    float* o = out + (row * w + col) * c;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (ch >= c) break;
      o[ch] = truncf(fminf(fmaxf(acc[ch], 0.0f), 255.0f));
    }
  }
}

template <bool kSharp>
int launch(const void* x, const void* cl, const void* colors, void* out, int n, int w, int c,
           int max_disp, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w) * sizeof(float);
  cudaError_t err = cs::allow_dynamic_smem(polylines_exact_kernel<kSharp>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  polylines_exact_kernel<kSharp><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cl),
      static_cast<const float*>(colors), static_cast<float*>(out), w, c, max_disp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, cl: [n, w] float32; colors, out: [n, w, c] float32 (HWC rows, c of 1 to
// 3); max_pieces must be 12. Returns the cudaError_t of the launch.
extern "C" int cs_polylines_exact_rows(const void* x, const void* cl, const void* colors,
                                       void* out, int n, int w, int c, int sharp,
                                       int max_pieces, int max_disp, void* stream) {
  if (n == 0 || w == 0) return 0;
  if (c < 1 || c > 3 || max_pieces != kPieces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sharp ? launch<true>(x, cl, colors, out, n, w, c, max_disp, stream)
               : launch<false>(x, cl, colors, out, n, w, c, max_disp, stream);
}

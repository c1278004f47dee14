// Exact polylines renderer of image rows (the polylines_soft / polylines_sharp
// fills and the hybrid_edge_plus backfill), uint8-valued float32 out.
//
// Replaces the Pallas kernel `polylines_exact_scanline` / `_scan_kernel`
// (comfystereo_tpu/pallas/polylines_exact_kernel.py). It computes what the
// XLA path `_exact_core` (comfystereo_tpu/ops/polylines_exact.py) computes,
// in its float32 expression forms, for one image row per CTA:
//
//   1. the row's x and closeness go to shared memory (the fused entry forms
//      them from the signed offsets: x = ((col + 0.5) + coord) + sep,
//      cl = |coord|), with the m = x - (col + 0.5) range of the row (block
//      reduction) and of each 32-column block. The row's range gives the
//      candidate window d = source - col in [floor(-max m) - 2,
//      ceil(-min m) + 2], clamped to +-(max_disp + 4); every segment that can
//      be active at a column lies in it, so the per-row window finds what
//      the XLA path's 64-row window does. Each warp narrows it by the same
//      rule to the m range of the blocks its 32 columns can reach (sources
//      col + d and col + d + 1 of the row window): no segment outside that
//      can be active at those columns, nor put a point in them;
//   2. one walk over the window per column, d ascending, collects
//      - the candidate list: the flat (sharp only) and connecting segments
//        with x0 < col + 1 and x1 >= col, flat before connecting, as
//        (source << 1 | flat) in a per-thread stripe of shared memory. Every
//        piece center c of the column has col <= c <= col + 1, and a segment
//        is active at c when x0 < c <= x1, so no segment that any piece
//        activates is left out, and the list keeps the XLA path's order;
//      - the breakpoints: the smallest points in [col, col + 1), sorted in
//        registers by a bubble insert into kCap slots (soft: x of each
//        source in the walk; sharp: x - 0.45 and x + 0.45 of the listed
//        flat tops, which hold every such point). Empty slots hold the
//        right sentinel 2w; any value >= col + 1 acts as that sentinel does
//        (it clips the piece to col + 1 and ends the chain), so the first K
//        slots equal the XLA path's sorted points q0 .. q0 + K - 1 for any
//        K <= kCap: an insert keeps the slots sorted, and the K smallest
//        points are the first K slots of any longer array;
//   3. pieces, with `_piece_geometry`'s forms: f = max(col, xq) + eps,
//      t = min(col + 1, xq1) - eps, sig = t - f, center = f + 0.5 * sig;
//      piece 0 starts at col + eps, and piece k > 0 is valid while
//      xq < col + 1. Pieces past the first invalid one add 0.0 to an
//      accumulator of at least 0.5 in the XLA path, so they are skipped.
//      K = max_pieces (1 to 16, as the TPU kernel's static k_pieces) is a
//      run-time bound of the piece loop; the slot count kCap is 12 for K up
//      to 12 and 16 above (the TPU kernel likewise caps its piece loop per
//      tile), so K = 12, the callers' value, runs the 12-slot code;
//   4. winner scan per valid piece, in `_winner_scan_xla`'s order: the left
//      sentinel, the right sentinel, then the list; strict `clp > best_cl`
//      from best_cl = -eps among 0 < ip < 1, and the lowest-x0 active
//      segment as the fallback. A column whose list outgrows its capacity
//      scans, per piece, the sources from its first listed one to its last
//      instead (the same segments in the same order, and inactive ones
//      between them), and adds one to `overflow` when that is given. The
//      winner is kept as an identity (left colour column, ip, flat) and its
//      colour is built once, col_l * (1 - ip) + col_r * ip, or col_l for a
//      flat segment;
//   5. acc = 0.5 + sum over pieces of colour * sig, then trunc(clip(acc, 0, 255)).
//      Colours go in groups of up to 3 channels: steps 3-5 run once per
//      group (C of 1 to 3 is one group), so any C is taken with three
//      accumulators.
//
// Rows up to 26,181 columns stage x, closeness and the block ranges in
// shared memory, one row per CTA; wider rows keep them in a device-memory
// workspace of one row per CTA (the kGlobal instances, whose CTAs walk rows
// at a stride of the grid), and the lists stay in shared memory.
//
// Bound on Hopper: bytes, with operations close behind. Per pixel it moves
// 28 bytes through the fused entry (offset and three colours in, three
// out; 32 through the entry that takes x and closeness). Per column and
// step of the warp's window it spends 2 adds and 4 compares (sharp) on the
// list tests, per listed flat top 4 compares on its points, and per valid
// piece and list entry 2 adds and 2 compares; only the active entries, one
// or two per piece, go on to the IEEE division and the blend.
// chip_smoke.py (polylines_work) counts these on its inputs, from this
// code. The TPU kernel rolled packed planes one lane per step over a column
// tile and predicated piece counts per tile; here the list keeps the
// per-piece scans to the few segments that can meet the column. Built with
// -fmad=false, never fast math: ip's division and every product and sum
// round as the plain version's.
#include <cuda_runtime.h>
#include <math.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;
constexpr int kMaxPieces = 16;  // the largest max_pieces (K) the kernel takes
constexpr int kListCap = 16;   // entries of a column's candidate list
constexpr int kBlock = 32;     // columns per block of the m ranges (one warp)
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

  // Segment [x0, x1] with closenesses cl0, cl1 at its ends, taken when it is
  // active at `center` (x0 < center <= x1).
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

  // Source cp's flat top [x - hw, x + hw] or its connecting segment
  // [x + hw, x_next - hw]; closenesses are read only for an active one.
  __device__ __forceinline__ void consider_source(float center, const float* s_x,
                                                  const float* s_cl, int cp, bool flat,
                                                  float hw) {
    const float xc = s_x[cp];
    const float x0 = flat ? xc - hw : xc + hw;
    const float x1 = flat ? xc + hw : s_x[cp + 1] - hw;
    if (!(x0 < center && x1 >= center)) return;
    const float cl0 = s_cl[cp];
    consider(center, x0, x1, cl0, flat ? cl0 : s_cl[cp + 1], cp, flat);
  }
};

template <int kCap>
__device__ __forceinline__ void insert(float (&slots)[kCap], float pv, float colf,
                                       float colp1) {
  if (!(pv >= colf && pv < colp1)) return;
  float carry = pv;
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    const float s = slots[j];
    slots[j] = fminf(s, carry);
    carry = fmaxf(s, carry);
  }
}

__device__ __forceinline__ void warp_min_max(float& lo, float& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

struct Params {
  const float* a;  // kFused: the signed offsets (coord); otherwise x
  const float* b;  // the closeness (not kFused)
  float sep;
  const float* colors;
  float* out;
  float* workspace;  // kGlobal: row_words(w) words per CTA
  int n, w, c, max_pieces, max_disp, list_cap;
  int* overflow;
};

// 4-byte words of one row's staged planes: x, closeness, and the m range of
// each 32-column block.
__host__ __device__ inline size_t row_words(int w) {
  const size_t nb = (static_cast<size_t>(w) + kBlock - 1) / kBlock;
  return 2 * static_cast<size_t>(w) + 2 * nb;
}

// One row, its planes at `planes` (shared memory or the CTA's workspace),
// the candidate lists at `s_list` in shared memory. kFused: a holds the
// signed offsets (coord) and x, cl are formed here; otherwise a is x and b
// the closeness. kC: the channel count when it is 3 (the colour loops then
// unroll), 0 for a count taken from c. kCap: the breakpoint slots, at least
// max_pieces.
template <bool kSharp, bool kFused, int kC, int kCap>
__device__ __forceinline__ void exact_row(const Params& p, long long row, float* planes,
                                          int* s_list) {
  const float* __restrict__ a = p.a;
  const float* __restrict__ b = p.b;
  const float sep = p.sep;
  const float* __restrict__ colors = p.colors;
  float* __restrict__ out = p.out;
  const int w = p.w, max_pieces = p.max_pieces, max_disp = p.max_disp;
  const int list_cap = p.list_cap;
  int* __restrict__ overflow = p.overflow;
  const int c = kC ? kC : p.c;
  const int nb = (w + kBlock - 1) / kBlock;
  float* s_x = planes;
  float* s_cl = s_x + w;
  float* s_bmin = s_cl + w;  // per 32-column block: min and max of m
  float* s_bmax = s_bmin + nb;
  __shared__ float s_red[2 * cs::kThreads / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float hw = kSharp ? 0.45f : 0.0f;

  // 1. Stage the row; m ranges of the row and of each 32-column block.
  float lo = INFINITY, hi = -INFINITY;
  for (int i0 = 0; i0 < w; i0 += kThreads) {
    const int i = i0 + tid;
    float m_lo = INFINITY, m_hi = -INFINITY;
    if (i < w) {
      float xv, clv;
      if (kFused) {
        const float co = a[row * w + i];
        xv = ((static_cast<float>(i) + 0.5f) + co) + sep;
        clv = fabsf(co);
      } else {
        xv = a[row * w + i];
        clv = b[row * w + i];
      }
      s_x[i] = xv;
      s_cl[i] = clv;
      m_lo = m_hi = xv - (static_cast<float>(i) + 0.5f);
    }
    warp_min_max(m_lo, m_hi);
    if (lane == 0 && i0 + warp * kBlock < w) {
      s_bmin[i0 / kBlock + warp] = m_lo;
      s_bmax[i0 / kBlock + warp] = m_hi;
    }
    lo = fminf(lo, m_lo);
    hi = fmaxf(hi, m_hi);
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
  int* list = s_list + tid;

  for (int c0 = 0; c0 < w; c0 += kThreads) {
    const int cw = c0 + warp * kBlock;  // the warp's first column
    if (cw >= w) break;                 // warp-uniform
    // The warp's window: the row window narrowed to the m range of the
    // blocks holding sources cw + d_lo .. cw + 31 + d_hi + 1.
    const int src_lo = max(cw + d_lo, 0), src_hi = min(cw + kBlock + d_hi, w - 1);
    float wlo = INFINITY, whi = -INFINITY;
    for (int bk = src_lo / kBlock; bk <= src_hi / kBlock && src_lo <= src_hi; ++bk) {
      wlo = fminf(wlo, s_bmin[bk]);
      whi = fmaxf(whi, s_bmax[bk]);
    }
    const bool any = src_lo <= src_hi;
    const int dl = any ? max(static_cast<int>(floorf(-whi)) - 2, d_lo) : 1;
    const int dh = any ? min(static_cast<int>(ceilf(-wlo)) + 2, d_hi) : 0;

    const int col = c0 + tid;
    if (col >= w) continue;
    const float colf = static_cast<float>(col);
    const float colp1 = colf + 1.0f;

    // 2. One walk: breakpoints, and the candidate list.
    float slots[kCap];
#pragma unroll
    for (int j = 0; j < kCap; ++j) slots[j] = sent_r;
    int n = 0, first_cp = w, last_cp = -1;
    const int cp0 = max(col + dl, 0), cp1 = min(col + dh, w - 1);
    float prev_hi = 0.0f;  // x + hw of source cp - 1
    for (int cp = cp0; cp <= min(cp1 + 1, w - 1); ++cp) {
      const float xv = s_x[cp];
      const float lo_pt = xv - hw, hi_pt = xv + hw;
      // connecting segment of cp - 1: [x[cp - 1] + hw, x[cp] - hw]
      if (cp > cp0 && prev_hi < colp1 && lo_pt >= colf) {
        if (n < list_cap) list[n * kThreads] = (cp - 1) << 1;
        ++n;
        first_cp = min(first_cp, cp - 1);
        last_cp = cp - 1;
      }
      prev_hi = hi_pt;
      if (cp > cp1) break;  // the step past the window serves only that segment
      if (kSharp) {
        if (lo_pt < colp1 && hi_pt >= colf) {  // flat top of cp
          if (n < list_cap) list[n * kThreads] = (cp << 1) | 1;
          ++n;
          first_cp = min(first_cp, cp);
          last_cp = cp;
        }
      } else {
        insert(slots, xv, colf, colp1);
      }
    }
    const bool listed = n <= list_cap;
    if (!listed && overflow != nullptr) atomicAdd(overflow, 1);
    if (kSharp) {
      // A point x -+ hw in [col, col + 1) is an end of a flat top that
      // passes the list's test, so the listed flat tops (or, past the list's
      // capacity, those from the first listed source to the last) hold
      // every breakpoint.
      for (int j = 0; j < (listed ? n : last_cp - first_cp + 1); ++j) {
        int cp = first_cp + j;
        if (listed) {
          const int code = list[j * kThreads];
          if (!(code & 1)) continue;
          cp = code >> 1;
        }
        const float xv = s_x[cp];
        insert(slots, xv - hw, colf, colp1);
        insert(slots, xv + hw, colf, colp1);
      }
    }

    // 3-5 for each group of up to 3 channels.
    for (int g0 = 0; g0 < c; g0 += 3) {
      const float* gimg = img + g0;
      float acc[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
      for (int k = 0; k < kCap; ++k) {
        // 3. Piece geometry.
        if (k >= max_pieces) break;
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
        if (listed) {
          for (int j = 0; j < n; ++j) {
            const int code = list[j * kThreads];
            s.consider_source(center, s_x, s_cl, code >> 1, code & 1, hw);
          }
        } else {
          for (int cp = first_cp; cp <= last_cp; ++cp) {
            if (kSharp) s.consider_source(center, s_x, s_cl, cp, true, hw);
            if (cp <= w - 2) s.consider_source(center, s_x, s_cl, cp, false, hw);
          }
        }
        const Winner win = s.best_cl > -kEps ? s.best : s.fb;

        // 5. Accumulate the winner's colour over the piece.
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if (g0 + ch >= c) break;
          float cval = 0.0f;
          if (win.id >= 0) {
            const float col_l = gimg[static_cast<long long>(win.id) * c + ch];
            if (win.flat) {
              cval = col_l;
            } else {
              const float col_r = gimg[static_cast<long long>(win.id + 1) * c + ch];
              cval = col_l * (1.0f - win.ip) + col_r * win.ip;
            }
          }
          acc[ch] = acc[ch] + cval * sig;
        }
      }
      float* o = out + (row * w + col) * c + g0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (g0 + ch >= c) break;
        o[ch] = truncf(fminf(fmaxf(acc[ch], 0.0f), 255.0f));
      }
    }
  }
}

// kGlobal: the staged planes live in the workspace, and each CTA renders
// rows blockIdx.x, blockIdx.x + gridDim.x, ...; otherwise one row per CTA
// with them in shared memory. Five CTAs per SM: ptxas then keeps 48
// registers and spills a few bytes, which measured faster than four CTAs
// at 61 registers.
template <bool kSharp, bool kFused, int kC, int kCap, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 5) polylines_exact_kernel(Params p) {
  // The planes (unless kGlobal), then the lists: entry j of thread t at
  // j * kThreads + t.
  extern __shared__ float smem[];
  if (!kGlobal) {
    exact_row<kSharp, kFused, kC, kCap>(p, blockIdx.x, smem,
                                        reinterpret_cast<int*>(smem + row_words(p.w)));
    return;
  }
  float* planes = p.workspace + blockIdx.x * row_words(p.w);
  for (int row = blockIdx.x; row < p.n; row += gridDim.x) {
    exact_row<kSharp, kFused, kC, kCap>(p, row, planes, reinterpret_cast<int*>(smem));
    __syncthreads();  // the next row overwrites the planes and the lists
  }
}

// Shared memory of a CTA: the lists, and the staged planes unless kGlobal.
size_t smem_bytes(int w, bool global) {
  return static_cast<size_t>(kListCap) * kThreads * sizeof(int) +
         (global ? 0 : row_words(w) * sizeof(float));
}

template <bool kSharp, bool kFused, int kC, int kCap, bool kGlobal>
int launch_kernel(const Params& p, int ctas, void* stream) {
  const size_t smem = smem_bytes(p.w, kGlobal);
  auto kernel = polylines_exact_kernel<kSharp, kFused, kC, kCap, kGlobal>;
  cudaError_t err = cs::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<kGlobal ? ctas : p.n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K up to 12 runs the 12-slot instance, 13 to 16 the 16-slot one. ctas > 0
// takes the workspace instances (any C).
template <bool kSharp, bool kFused, int kCap>
int launch_cap(const Params& p, int ctas, void* stream) {
  if (ctas > 0) {
    if (p.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel<kSharp, kFused, 0, kCap, true>(p, ctas, stream);
  }
  return p.c == 3 ? launch_kernel<kSharp, kFused, 3, kCap, false>(p, 0, stream)
                  : launch_kernel<kSharp, kFused, 0, kCap, false>(p, 0, stream);
}

template <bool kSharp, bool kFused>
int launch(const Params& p, int ctas, void* stream) {
  if (p.n == 0 || p.w == 0) return 0;
  if (p.c < 1 || p.max_pieces < 1 || p.max_pieces > kMaxPieces || p.list_cap < 0 ||
      p.list_cap > kListCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return p.max_pieces <= 12 ? launch_cap<kSharp, kFused, 12>(p, ctas, stream)
                            : launch_cap<kSharp, kFused, kMaxPieces>(p, ctas, stream);
}

}  // namespace

// x, cl: [n, w] float32; colors, out: [n, w, c] float32 (HWC rows, any c >=
// 1); max_pieces is K, 1 to 16; list_cap (0 to 16) is the candidate lists'
// capacity; overflow (int, or null) counts the columns that outgrew it.
// Rows of up to 26,181 columns take ctas = 0 and no workspace; wider ones a
// grid of `ctas` CTAs and a workspace of ctas * row_words(w) 4-byte words.
// Returns the cudaError_t of the launch.
extern "C" int cs_polylines_exact_rows(const void* x, const void* cl, const void* colors,
                                       void* out, void* workspace, int ctas, int n, int w,
                                       int c, int sharp, int max_pieces, int max_disp,
                                       int list_cap, void* overflow, void* stream) {
  const Params p{static_cast<const float*>(x), static_cast<const float*>(cl), 0.0f,
                 static_cast<const float*>(colors), static_cast<float*>(out),
                 static_cast<float*>(workspace), n, w, c, max_pieces, max_disp, list_cap,
                 static_cast<int*>(overflow)};
  return sharp ? launch<true, false>(p, ctas, stream) : launch<false, false>(p, ctas, stream);
}

// The fused entry: coord [n, w] float32 signed offsets, sep the separation
// in pixels as float32; x = ((col + 0.5) + coord) + sep and cl = |coord|
// are formed in the kernel. Otherwise as cs_polylines_exact_rows.
extern "C" int cs_polylines_exact_coord(const void* coord, float sep, const void* colors,
                                        void* out, void* workspace, int ctas, int n, int w,
                                        int c, int sharp, int max_pieces, int max_disp,
                                        int list_cap, void* overflow, void* stream) {
  const Params p{static_cast<const float*>(coord), nullptr, sep,
                 static_cast<const float*>(colors), static_cast<float*>(out),
                 static_cast<float*>(workspace), n, w, c, max_pieces, max_disp, list_cap,
                 static_cast<int*>(overflow)};
  return sharp ? launch<true, true>(p, ctas, stream) : launch<false, true>(p, ctas, stream);
}

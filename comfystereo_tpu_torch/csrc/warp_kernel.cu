// Exact z-buffer forward warp of image rows (the gpu_warp fill technique).
//
// Replaces the Pallas kernel `warp_scanline` / `_warp_kernel`
// (comfystereo_tpu/pallas/warp_kernel.py). One CTA of 256 threads warps one
// image row; each warp takes 32 neighbouring columns at a time. Two entries
// share the device code: one takes the offsets and normalised depth (the
// Pallas contract), the fused one takes the eye's depth with the per-image
// min and max and forms both in registers, in the float32 forms of
// ops/depth.py (normalize_depth, then pixel_offsets with PyTorch's pow), so
// neither reaches device memory.
//
//   1. per column: nd, the offset and dl = x + offset go to shared memory
//      (the fused entry forms nd and the offset here, stepping 31 columns a
//      warp so that the next column's offset comes from lane + 1 by a
//      shuffle), and so does the column interval of segment x (joining
//      columns x and x + 1), empty where the segment is disconnected. The row's offset range gives the candidate
//      window d = i - x in [max(floor(-off_max - 1), -R), min(ceil(-off_min),
//      R)], R = max_disp + 2: every segment that can cover a column lies in
//      it;
//   2. each warp narrows that window to the d of the segments whose
//      intervals meet its 32 columns, then each column walks it in
//      ascending d with the strict `zz > zbest + 1e-6` rule, which keeps
//      ties on the lowest source index. A candidate costs one 4-byte shared
//      load and two integer compares; only a column inside the segment's
//      interval forms sw, frac, mstart and zz, in the plain version's
//      forms, and applies its exact tests. Each warp ballots its filled
//      columns into one bit word per 32 columns;
//   3. border fill: a column's nearest filled column to the left is a bit
//      of its own word or found by a warp-wide search back over the words;
//      the row's rightmost filled column (the reference's right border,
//      reference :399-404) by the same search from the end;
//   4. sqrt-biased interpolation of the source position across gaps, the
//      clip at max_disp + 126 and to [0, W-1], and the bilinear taps, read
//      straight from the HWC image (L1 holds the row).
//
// Why the interval drops no column that the exact test accepts (sw = width,
// or 1 where |width| < 1e-4; frac = fl(fl(col - dl) / sw); rounding is
// monotone and keeps the sign of col - dl):
//   - sw > 0: frac < 1 needs col - dl < sw, so col <= fl(dl + sw); frac >= 0
//     needs col >= dl, unless the quotient of a negative col - dl underflows
//     to -0, which needs |col - dl| < 2^-21 (|sw| < 2^128). So
//     col in [ceil(fl(dl - 2^-20)), floor(fl(dl + sw))];
//   - sw < 0: frac < 1 needs col - dl > sw, so col >= fl(dl + sw); frac >= 0
//     needs col <= dl but for the same underflow. So col in
//     [ceil(fl(dl + sw)), floor(fl(dl + 2^-20))];
//   - col - mstart < max_stretch, mstart = floor(min(dl, dr)) an integer, is
//     col <= mstart + max_stretch - 1 while |mstart| < 2^24; beyond that the
//     cut is either empty or above the row.
// A disconnected segment's zz is -1e30 in the plain version and never wins,
// so its interval is empty. Where the window per warp is concerned: a
// (column, segment) pair with the column in the segment's interval adds its
// d to the window of the column's warp.
//
// Planes: 20 B per column (dl, nd, interval, src, z) and one bit; 38,704 B
// per CTA at W = 1920, so 5 CTAs (40 warps) per SM. Rows up to 11,547
// columns hold them in shared memory, one row per CTA
// (`kernels/warp_kernel.py:smem_bytes`); wider rows, up to 65,536 columns
// (the interval packs a column into 16 bits), hold them in a device-memory
// workspace of one row per CTA, and each CTA walks rows at a stride of the
// grid (the kGlobal instances; L2 and L1 hold a CTA's row). Colours are any
// C: the taps loop over the channels. Bound on Hopper: bytes, 29 B per pixel through
// the fused entry in float32 (depth 4, colour 12 in and 12 out, gap 1), 17 B
// in bfloat16. Built with -fmad=false so zz, the offsets, the gap
// interpolation and the lerp round as the plain version does; division and
// sqrt are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "row_scan.cuh"
#include "torch_math.cuh"

namespace {

using cs::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 1u;  // interval [1, 0]
constexpr float kMargin = 9.5367431640625e-07f;  // 2^-20
constexpr size_t kSmemLimit = 232448;  // what one CTA may opt in to on sm_90
constexpr size_t kStaticSmem = 2 * kWarps * sizeof(float);  // s_red

constexpr int kMaxWidth = 65536;  // the interval packs a column into 16 bits

// 4-byte words of one row's planes: five planes and one bit per column.
__host__ __device__ inline size_t plane_words(int w) {
  return 5 * static_cast<size_t>(w) + static_cast<size_t>((w + 31) / 32);
}

__device__ __forceinline__ float load_color(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_color(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_color(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_color(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  // Pallas contract: offsets and normalised depth, [n, w] each.
  const float* offset;
  const float* nd;
  // Fused: the eye's depth [n, w] and each image's min and max [n / height].
  const float* depth;
  const float* dmin;
  const float* dmax;
  int height;
  float divergence, separation, exponent, convergence;
  int pow_mode;
  const void* image;  // [n, w, c]
  void* out;          // [n, w, c]
  unsigned char* gap;  // [n, w]
  float* workspace;    // kGlobal: plane_words(w) words per CTA
  int n, w, c;
  float gradient_threshold;
  int max_stretch, max_disp;
};

// nd and offset of one column of depth d, formed as normalize_depth and
// pixel_offsets form them (the fused entry).
__device__ __forceinline__ void form(const Args& a, float d, float dmin, float rng, float& nd,
                                     float& off) {
  nd = rng > 1e-6f ? (d - dmin) / fmaxf(rng, 1e-6f) : 0.0f;
  const float v = nd - a.convergence;
  const float p = cs::torch_pow(fabsf(v), a.exponent, a.pow_mode);
  off = cs::torch_sign(v) * p * a.divergence + a.separation;
}

// Columns that segment x (dl .. dr, offsets o0 .. o1) can cover, packed as
// lo | hi << 16 (see the header for why nothing is dropped).
__device__ __forceinline__ unsigned interval(int x, int w, float dl, float dr, float o0,
                                             float o1, float threshold, int stretch) {
  if (x > w - 2 || !(fabsf(o1 - o0) < threshold)) return kEmpty;
  const float width = dr - dl;
  const float sw = fabsf(width) < 1e-4f ? 1.0f : width;
  const float end = dl + sw;
  float lo = sw > 0.0f ? ceilf(dl - kMargin) : ceilf(end);
  float hi = sw > 0.0f ? floorf(end) : floorf(dl + kMargin);
  hi = fminf(hi, floorf(fminf(dl, dr)) + static_cast<float>(stretch - 1));
  lo = fmaxf(lo, 0.0f);
  hi = fminf(hi, static_cast<float>(w - 1));
  if (!(lo <= hi)) return kEmpty;
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// One row, its planes at `planes` (shared memory or the CTA's workspace).
template <typename T, bool kFused>
__device__ __forceinline__ void warp_row(const Args& a, int row, float* planes) {
  const int w = a.w;
  const int n_words = (w + 31) / 32;
  float* s_dl = planes;
  float* s_nd = s_dl + w;
  unsigned* s_iv = reinterpret_cast<unsigned*>(s_nd + w);
  float* s_src = reinterpret_cast<float*>(s_iv + w);
  float* s_z = s_src + w;
  unsigned* s_filled = reinterpret_cast<unsigned*>(s_z + w);
  __shared__ float s_red[2 * kWarps];

  const long long at0 = static_cast<long long>(row) * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.c;
  const T* img = static_cast<const T*>(a.image) + at0 * c;
  float dmin = 0.0f, rng = 0.0f;
  if (kFused) {
    const int image_index = row / a.height;
    dmin = __ldg(a.dmin + image_index);
    rng = __ldg(a.dmax + image_index) - dmin;
  }

  // 1. Planes and intervals; the row's offset range.
  float lo = INFINITY, hi = -INFINITY;
  // The entry taking offsets reads the next column's offset itself. The
  // fused entry takes it from lane + 1 by a shuffle, so each warp steps 31
  // columns: lane 31 forms the next column only for lane 30 (the next step
  // forms it again), and no lane forms two columns.
  const float* depth = kFused ? a.depth + at0 : nullptr;
  const float* nd_in = kFused ? nullptr : a.nd + at0;
  const float* off_in = kFused ? nullptr : a.offset + at0;
  constexpr int kStep = kFused ? 31 : 32;
  for (int base = warp * kStep; base < w; base += kWarps * kStep) {
    const int x = base + lane;
    const int at = min(x, w - 1);
    float nd0, off0, off1;
    if (kFused) {
      form(a, __ldg(depth + at), dmin, rng, nd0, off0);
      off1 = __shfl_down_sync(kFull, off0, 1);
    } else {
      nd0 = __ldg(nd_in + at);
      off0 = __ldg(off_in + at);
      off1 = __ldg(off_in + min(x + 1, w - 1));
    }
    if (lane < kStep && x < w) {
      const float dl = static_cast<float>(x) + off0;
      const float dr = static_cast<float>(x + 1) + off1;
      s_dl[x] = dl;
      s_nd[x] = nd0;
      s_iv[x] = interval(x, w, dl, dr, off0, off1, a.gradient_threshold, a.max_stretch);
      lo = fminf(lo, off0);
      hi = fmaxf(hi, off0);
    }
  }
  cs::block_min_max(lo, hi, s_red);  // also orders the plane stores
  const int r_static = a.max_disp + 2;
  const int d_lo = max(static_cast<int>(floorf(-hi - 1.0f)), -r_static);
  const int d_hi = min(static_cast<int>(ceilf(-lo)), r_static);

  // 2. The warp's window, then the z-max walk in ascending source index.
  const float stretch = static_cast<float>(a.max_stretch);
  for (int base = warp * 32; base < w; base += kThreads) {
    const int x = base + lane;
    const int last = min(base + 31, w - 1);
    int wlo = INT_MAX, whi = INT_MIN;
    const int i_end = min(last + d_hi, w - 2);
    for (int i = max(base + d_lo, 0) + lane; i <= i_end; i += 32) {
      const unsigned iv = s_iv[i];
      const int c0 = max(static_cast<int>(iv & 0xffffu), base);
      const int c1 = min(static_cast<int>(iv >> 16), last);
      if (c0 <= c1) {
        wlo = min(wlo, i - c1);
        whi = max(whi, i - c0);
      }
    }
    wlo = __reduce_min_sync(kFull, wlo);
    whi = __reduce_max_sync(kFull, whi);
    const float col = static_cast<float>(x);
    float zbest = -1.0f, src = -1.0f;
    if (x < w) {
      const int d_end = min(min(d_hi, whi), w - 2 - x);
      for (int d = max(max(d_lo, wlo), -x); d <= d_end; ++d) {
        const int i = x + d;
        const unsigned iv = s_iv[i];
        if (x < static_cast<int>(iv & 0xffffu) || x > static_cast<int>(iv >> 16)) continue;
        const float dl = s_dl[i], dr = s_dl[i + 1];
        const float width = dr - dl;
        const float sw = fabsf(width) < 1e-4f ? 1.0f : width;
        const float frac = (col - dl) / sw;
        if (!(frac >= 0.0f && frac < 1.0f && col - floorf(fminf(dl, dr)) < stretch)) continue;
        const float zz = s_nd[i] * (1.0f - frac) + s_nd[i + 1] * frac;
        if (zz > zbest + 1e-6f) {
          zbest = zz;
          src = static_cast<float>(i) + frac;
        }
      }
      s_src[x] = src;
      s_z[x] = zbest;
    }
    const unsigned filled = __ballot_sync(kFull, src >= 0.0f);
    if (lane == 0) s_filled[base >> 5] = filled;
  }
  __syncthreads();

  // 3-4. Borders, gap interpolation, clips and bilinear taps. An empty row
  // (rn = -1) reads column 0's unfilled values, as the reference's clipped
  // gather does.
  const int rn = cs::last_set_before(s_filled, n_words);
  const int rn_c = rn < 0 ? 0 : rn;
  const float r_src = s_src[rn_c], r_z = s_z[rn_c];
  const float bil = static_cast<float>(a.max_disp + 126);
  const float wmax = static_cast<float>(w - 1);
  T* o = static_cast<T*>(a.out) + at0 * c;
  unsigned char* gap = a.gap + at0;
  for (int base = warp * 32; base < w; base += kThreads) {
    const int x = base + lane;
    const unsigned own = s_filled[base >> 5] & cs::lanes_upto(lane);
    int ln = own != 0u ? base + 31 - __clz(own) : -1;
    if (__any_sync(kFull, own == 0u)) {
      const int before = cs::last_set_before(s_filled, base >> 5);
      if (own == 0u) ln = before;
    }
    if (x >= w) continue;
    const float col = static_cast<float>(x);
    float src = s_src[x];
    const bool filled = src >= 0.0f;
    const bool has_l = ln >= 0, has_r = x <= rn;
    if (!filled && (has_l || has_r)) {
      // Without a left border the forward fill carries column 0's values.
      const float l_src = s_src[has_l ? ln : 0];
      const float l_z = s_z[has_l ? ln : 0];
      const float ld = col - static_cast<float>(ln);
      const float rd = static_cast<float>(rn - x);
      float t = ld / fmaxf(ld + rd, 1.0f);
      if (!has_l) t = 1.0f;
      if (!has_r) t = 0.0f;
      const float tb = l_z < r_z ? sqrtf(t) : 1.0f - sqrtf(1.0f - t);
      src = l_src * (1.0f - tb) + r_src * tb;
    }
    src = fminf(fmaxf(src, col - bil), col + bil);
    src = fminf(fmaxf(src, 0.0f), wmax);
    const float xf = floorf(src);
    const float fr = src - xf;
    const int i0 = static_cast<int>(xf);
    const int i1 = min(i0 + 1, w - 1);
    for (int ch = 0; ch < c; ++ch) {
      const float g0 = load_color(img + i0 * c + ch);
      const float g1 = load_color(img + i1 * c + ch);
      store_color(o + x * c + ch, g0 * (1.0f - fr) + g1 * fr);
    }
    gap[x] = filled ? 0 : 1;
  }
}

// kGlobal: the planes live in the workspace, and each CTA warps rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; otherwise one row per CTA with
// its planes in shared memory.
template <typename T, bool kFused, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 5) warp_rows_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  if (!kGlobal) {
    warp_row<T, kFused>(a, blockIdx.x, smem);
    return;
  }
  float* planes = a.workspace + blockIdx.x * plane_words(a.w);
  for (int row = blockIdx.x; row < a.n; row += gridDim.x) {
    warp_row<T, kFused>(a, row, planes);
    __syncthreads();  // the next row overwrites the planes
  }
}

// ctas: the grid of the kGlobal instances (each with plane_words(w) words
// of workspace); 0 when the planes fit in shared memory.
template <typename T, bool kFused>
int launch(const Args& a, int ctas, void* stream) {
  if (a.n == 0 || a.w == 0) return 0;
  if (a.w > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    if (a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    warp_rows_kernel<T, kFused, true><<<ctas, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * plane_words(a.w);
  if (smem + kStaticSmem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cs::allow_dynamic_smem(warp_rows_kernel<T, kFused, false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_rows_kernel<T, kFused, false><<<a.n, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args rows_args(const void* offset, const void* nd, const void* image, void* out, void* gap,
               void* workspace, int n, int w, int c, float gradient_threshold,
               int max_stretch, int max_disp) {
  Args a{};
  a.offset = static_cast<const float*>(offset);
  a.nd = static_cast<const float*>(nd);
  a.image = image;
  a.out = out;
  a.gap = static_cast<unsigned char*>(gap);
  a.workspace = static_cast<float*>(workspace);
  a.n = n;
  a.w = w;
  a.c = c;
  a.gradient_threshold = gradient_threshold;
  a.max_stretch = max_stretch;
  a.max_disp = max_disp;
  return a;
}

Args depth_args(const void* depth, const void* dmin, const void* dmax, const void* image,
                void* out, void* gap, void* workspace, int n, int w, int c, int height,
                float divergence, float separation, float exponent, int pow_mode,
                float convergence, float gradient_threshold, int max_stretch, int max_disp) {
  Args a = rows_args(nullptr, nullptr, image, out, gap, workspace, n, w, c,
                     gradient_threshold, max_stretch, max_disp);
  a.depth = static_cast<const float*>(depth);
  a.dmin = static_cast<const float*>(dmin);
  a.dmax = static_cast<const float*>(dmax);
  a.height = height;
  a.divergence = divergence;
  a.separation = separation;
  a.exponent = exponent;
  a.pow_mode = pow_mode;
  a.convergence = convergence;
  return a;
}

}  // namespace

// offset, nd: [n, w] float32; image, out: [n, w, c] colour (HWC rows, any
// c >= 1); gap: [n, w] bool (one byte each). Rows of up to 11,547 columns
// take ctas = 0 and no workspace; wider ones, up to 65,536 columns, a grid
// of `ctas` CTAs and a workspace of ctas * plane_words(w) 4-byte words.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a row
// that neither fits).
extern "C" int cs_warp_rows_f32(const void* offset, const void* nd, const void* image,
                                void* out, void* gap, void* workspace, int ctas, int n, int w,
                                int c, float gradient_threshold, int max_stretch, int max_disp,
                                void* stream) {
  return launch<float, false>(rows_args(offset, nd, image, out, gap, workspace, n, w, c,
                                        gradient_threshold, max_stretch, max_disp),
                              ctas, stream);
}

extern "C" int cs_warp_rows_bf16(const void* offset, const void* nd, const void* image,
                                 void* out, void* gap, void* workspace, int ctas, int n, int w,
                                 int c, float gradient_threshold, int max_stretch,
                                 int max_disp, void* stream) {
  return launch<__nv_bfloat16, false>(rows_args(offset, nd, image, out, gap, workspace, n, w,
                                                c, gradient_threshold, max_stretch,
                                                max_disp),
                                      ctas, stream);
}

// The fused entry: depth [n, w] float32 (rows of n / height images), dmin
// and dmax [n / height] float32; pow_mode from kernels/_common.py:pow_mode.
extern "C" int cs_warp_rows_depth_f32(const void* depth, const void* dmin, const void* dmax,
                                      const void* image, void* out, void* gap,
                                      void* workspace, int ctas, int n, int w, int c,
                                      int height, float divergence, float separation,
                                      float exponent, int pow_mode, float convergence,
                                      float gradient_threshold, int max_stretch, int max_disp,
                                      void* stream) {
  return launch<float, true>(depth_args(depth, dmin, dmax, image, out, gap, workspace, n, w,
                                        c, height, divergence, separation, exponent,
                                        pow_mode, convergence, gradient_threshold,
                                        max_stretch, max_disp),
                             ctas, stream);
}

extern "C" int cs_warp_rows_depth_bf16(const void* depth, const void* dmin, const void* dmax,
                                       const void* image, void* out, void* gap,
                                       void* workspace, int ctas, int n, int w, int c,
                                       int height, float divergence, float separation,
                                       float exponent, int pow_mode, float convergence,
                                       float gradient_threshold, int max_stretch,
                                       int max_disp, void* stream) {
  return launch<__nv_bfloat16, true>(depth_args(depth, dmin, dmax, image, out, gap, workspace,
                                                n, w, c, height, divergence, separation,
                                                exponent, pow_mode, convergence,
                                                gradient_threshold, max_stretch, max_disp),
                                     ctas, stream);
}

// Exact z-buffer forward warp of image rows (the gpu_warp fill technique).
//
// Replaces the Pallas kernel `warp_scanline` / `_warp_kernel`
// (comfystereo_tpu/pallas/warp_kernel.py). One CTA warps one image row:
//
//   1. the row's offset min/max (block reduction) gives the candidate window
//      d = i - x in [max(floor(-off_max - 1), -R), min(ceil(-off_min), R)],
//      R = max_disp + 2. Every segment that can cover column x lies in it, so
//      the per-row window finds the same winners as the TPU kernel's 16-row
//      window and the XLA path's whole-batch window;
//   2. the five segment planes go to shared memory: dl = x + off, the safe
//      width, zl and zr (poisoned to -1e30 for disconnected segments, so they
//      never win) and mstart = floor(min(dl, dr));
//   3. each column walks the window in ascending d with the strict
//      `zz > zbest + 1e-6` rule, which keeps ties on the lowest source index;
//   4. border fill: a block scan gives each gap its nearest filled column to
//      the left, a block max the row's rightmost filled column (the
//      reference's right border, reference :399-404);
//   5. sqrt-biased interpolation of the source position across gaps, the
//      clip at max_disp + 126 and to [0, W-1], and the bilinear taps, read
//      straight from the HWC image.
//
// Bound on Hopper: bytes at the shapes of the main path (offset, depth, three
// colour channels in; three channels and the gap mask out, about 33 B/px in
// float32), with the candidate walk (about 8 float ops per candidate, the
// window's width per pixel) the next limit. The TPU kernel rolled the packed
// segment planes one lane per step and gathered taps with vreg gathers; here
// the planes sit in shared memory, consecutive threads read consecutive
// addresses at every step, and taps are plain loads from the row, which L1
// holds. Built with -fmad=false so zz, the gap interpolation and the lerp
// round as the plain version does; division and sqrt are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "row_scan.cuh"

namespace {

using cs::kThreads;
constexpr float kPoison = -1e30f;
constexpr int kPlanes = 7;  // dl, safe width, zl, zr, mstart, src, z

__device__ __forceinline__ float load_color(const float* p) { return *p; }
__device__ __forceinline__ float load_color(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_color(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_color(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) warp_rows_kernel(
    const float* __restrict__ offset, const float* __restrict__ nd,
    const T* __restrict__ image, T* __restrict__ out, unsigned char* __restrict__ gap,
    int w, int c, float gradient_threshold, int max_stretch, int max_disp) {
  extern __shared__ float smem[];
  float* s_dl = smem;
  float* s_sw = s_dl + w;
  float* s_zl = s_sw + w;
  float* s_zr = s_zl + w;
  float* s_ms = s_zr + w;
  float* s_src = s_ms + w;
  float* s_z = s_src + w;
  int* s_ln = reinterpret_cast<int*>(s_ms);  // mstart is dead after step 3
  __shared__ int s_scan[2 * kThreads];
  __shared__ float s_red[64];

  const long long row = blockIdx.x;
  const float* off = offset + row * w;
  const float* ndr = nd + row * w;
  const int tid = threadIdx.x;

  // 1. Candidate window from the row's offset range.
  float lo = INFINITY, hi = -INFINITY;
  for (int x = tid; x < w; x += kThreads) {
    const float o = off[x];
    lo = fminf(lo, o);
    hi = fmaxf(hi, o);
  }
  cs::block_min_max(lo, hi, s_red);
  const int r_static = max_disp + 2;
  const int d_lo = max(static_cast<int>(floorf(-hi - 1.0f)), -r_static);
  const int d_hi = min(static_cast<int>(ceilf(-lo)), r_static);

  // 2. Segment planes; segment i joins columns i and i + 1 (i <= w - 2).
  for (int i = tid; i < w - 1; i += kThreads) {
    const float o0 = off[i], o1 = off[i + 1];
    const float dl = static_cast<float>(i) + o0;
    const float dr = static_cast<float>(i + 1) + o1;
    const float width = dr - dl;
    const bool conn = fabsf(o1 - o0) < gradient_threshold;
    s_dl[i] = dl;
    s_sw[i] = fabsf(width) < 1e-4f ? 1.0f : width;
    s_zl[i] = conn ? ndr[i] : kPoison;
    s_zr[i] = conn ? ndr[i + 1] : kPoison;
    s_ms[i] = floorf(fminf(dl, dr));
  }
  __syncthreads();

  // 3. Windowed z-max over candidate segments, ascending source index.
  const float stretch = static_cast<float>(max_stretch);
  for (int x = tid; x < w; x += kThreads) {
    const float col = static_cast<float>(x);
    float zbest = -1.0f, src = -1.0f;
    for (int d = d_lo; d <= d_hi; ++d) {
      const int i = x + d;
      if (i < 0 || i > w - 2) continue;
      const float frac = (col - s_dl[i]) / s_sw[i];
      if (!(frac >= 0.0f && frac < 1.0f && col - s_ms[i] < stretch)) continue;
      const float zz = s_zl[i] * (1.0f - frac) + s_zr[i] * frac;
      if (zz > zbest + 1e-6f) {
        zbest = zz;
        src = static_cast<float>(i) + frac;
      }
    }
    s_src[x] = src;
    s_z[x] = zbest;
  }
  __syncthreads();

  // 4. Nearest filled column at or left of each column; rightmost filled column.
  const int per = (w + kThreads - 1) / kThreads;
  const int x0 = min(tid * per, w), x1 = min(x0 + per, w);
  int last = -1;
  for (int x = x0; x < x1; ++x) {
    if (s_src[x] >= 0.0f) last = x;
  }
  int rn;
  int run = cs::block_exclusive_scan<true>(last, -1, s_scan, &rn);
  for (int x = x0; x < x1; ++x) {
    if (s_src[x] >= 0.0f) run = x;
    s_ln[x] = run;
  }
  __syncthreads();

  // 5. Gap interpolation, clips and bilinear taps. An empty row (rn = -1)
  // reads column 0's unfilled values, as the reference's clipped gather does.
  const int rn_c = rn < 0 ? 0 : rn;
  const float r_src = s_src[rn_c], r_z = s_z[rn_c];
  const float bil = static_cast<float>(max_disp + 126);
  const float wmax = static_cast<float>(w - 1);
  const T* img = image + row * w * c;
  T* o = out + row * w * c;
  for (int x = tid; x < w; x += kThreads) {
    const float col = static_cast<float>(x);
    float src = s_src[x];
    const bool filled = src >= 0.0f;
    const int ln = s_ln[x];
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
      const float g0 = load_color(img + static_cast<long long>(i0) * c + ch);
      const float g1 = load_color(img + static_cast<long long>(i1) * c + ch);
      store_color(o + static_cast<long long>(x) * c + ch, g0 * (1.0f - fr) + g1 * fr);
    }
    gap[row * w + x] = filled ? 0 : 1;
  }
}

template <typename T>
int launch(const void* offset, const void* nd, const void* image, void* out, void* gap,
           int n, int w, int c, float gradient_threshold, int max_stretch, int max_disp,
           void* stream) {
  if (n == 0 || w == 0) return 0;
  const size_t smem = kPlanes * static_cast<size_t>(w) * sizeof(float);
  cudaError_t err = cs::allow_dynamic_smem(warp_rows_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_rows_kernel<T><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(offset), static_cast<const float*>(nd),
      static_cast<const T*>(image), static_cast<T*>(out), static_cast<unsigned char*>(gap),
      w, c, gradient_threshold, max_stretch, max_disp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// offset, nd: [n, w] float32; image, out: [n, w, c] colour (HWC rows);
// gap: [n, w] bool (one byte each). Returns the cudaError_t of the launch.
extern "C" int cs_warp_rows_f32(const void* offset, const void* nd, const void* image,
                                void* out, void* gap, int n, int w, int c,
                                float gradient_threshold, int max_stretch, int max_disp,
                                void* stream) {
  return launch<float>(offset, nd, image, out, gap, n, w, c, gradient_threshold,
                       max_stretch, max_disp, stream);
}

extern "C" int cs_warp_rows_bf16(const void* offset, const void* nd, const void* image,
                                 void* out, void* gap, int n, int w, int c,
                                 float gradient_threshold, int max_stretch, int max_disp,
                                 void* stream) {
  return launch<__nv_bfloat16>(offset, nd, image, out, gap, n, w, c, gradient_threshold,
                               max_stretch, max_disp, stream);
}

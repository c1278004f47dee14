// The depth blur's box means and blends, in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves the box means to XLA
// (comfystereo_tpu/ops/blur.py: box_blur_h, box_blur_w and the blend of
// directional_motion_blur). The port ran them as a plain PyTorch composition,
// one launch per tap, clamp and blend operation (62 launches a 12-frame
// chunk); that composition is the plain version
// (kernels/box_blend.py:box_blend_plain). For [n, h, w] float32 depth d and
// the two eyes' edge weights wl, wr it computes, per pixel:
//   - with radius r > 0, each weight's vertical box mean: p[k] is the weight
//     at row clamp(y - r + k, 0, h - 1) (edge-replicate), acc = p[0], then
//     acc + p[k] for k = 1 .. 2r in ascending k, then an IEEE division by
//     2r + 1 and a clamp to [0, 1] as torch.clamp makes it (NaN kept); with
//     r = 0 the weights as they are;
//   - with taps n > 1, the depth's horizontal box mean, in the same order over
//     the columns clamp(x - (n - 1 - n / 2) + k, 0, w - 1), k = 0 .. n - 1,
//     divided by n; with n <= 1 the depth itself;
//   - each eye's blend w * b + (1 - w) * d in ATen's order: t1 = w * b,
//     t2 = 1 - w, t3 = t2 * d, t1 + t3.
// Every operation is a rounded intrinsic (and the build takes -fmad=false),
// so nothing is contracted into an FMA and the kernel is bit-equal to the
// plain version, on the card and on the CPU. A running sum (add the new tap,
// subtract the old) would round differently, so each window is added anew.
//
// Bound on Hopper: bytes. d, wl and wr are read once and both eyes written
// once: 20 B/px, 498 MB for a 12-frame 1080p chunk, 0.149 ms at 3.35 TB/s.
// The arithmetic (about 45 adds, 3 divisions, 2 clamps and 8 blend
// operations a pixel) is far under the card's rate, but its sums are long
// dependent chains, so the kernel needs many warps in flight: registers per
// thread set its speed. And a zero dividend sends the IEEE division down its
// slow path, so zeros (most edge weights) skip it (`div_by`). Design: a CTA takes a strip of kStrip rows of a tile
// of kThreads columns of one image, one column a thread, and walks the strip
// a row at a time. Rows reach shared memory by cp.async through a ring of
// kStages stages, each the depth row with its horizontal halo and the
// weights' row r rows below it (16-byte copies where the tile lies whole in
// an aligned row; the halo and ragged tiles column by column, clamped to the
// row). Each thread keeps the last 2r + 1 weights of its column in
// registers, shifted a row each step (r up to kRingRadius; a larger radius
// reads its taps through L1 and L2), and reads the horizontal taps from
// shared memory, neighbouring threads on neighbouring words. The strips' 2r
// halo rows of weights are the only bytes read twice (2r / kStrip of the
// weights). On an H100 at [12, 1080, 1920], 20 taps, radius 6: 0.245 ms, 61%
// of the floor. Tried and left (ms before `div_by`, when this design took
// 0.31): four or two columns a thread (0.56, 0.38: more registers, fewer
// warps), four rows a step (0.46-0.59), the ring indexed modulo 2r + 1 with
// the rows unrolled by it in place of the shift (0.35 against 0.33), strips
// of 48, 64 or 128 rows (0.249, 0.249, 0.335 after `div_by`).
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // columns per CTA, one a thread
constexpr int kStrip = 32;       // rows per CTA
constexpr int kStages = 4;       // rows in flight
constexpr int kRingRadius = 8;   // largest r whose window lives in registers
constexpr int kGeneric = -1;     // the instance for larger radii
constexpr int kMaxTaps = 8192;   // the stages stay within shared memory
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // what a CTA may opt in to on sm_90

struct Args {
  const float* depth;  // [n, h, w] each
  const float* wl;
  const float* wr;
  float* left;
  float* right;
  int h, w, taps, radius;
  int lead;    // columns of the horizontal window left of its output: taps - 1 - taps / 2
  int tiles;   // column tiles of an image
  int strips;  // row strips of an image
  int dofs;    // index of the tile's first column in a staged depth row: lead rounded up to 4
  int wofs;    // offset of the weights in a stage: dofs + kThreads + taps / 2, rounded up to 4
  int stage;   // floats of a stage: wofs + 2 * kThreads (wl's row, then wr's)
  int vec;     // rows and planes 16-byte aligned: whole tiles are copied 16 bytes at a time
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// x / k in IEEE division for k > 0, finite and normal. A zero dividend's
// quotient is the dividend itself (its sign kept); it is returned as it is,
// because the division's check (FCHK) sends a zero dividend down its slow
// path, and most edge weights are zero.
__device__ __forceinline__ float div_by(float x, float k) {
  const bool zero = x == 0.0f;
  const float q = __fdiv_rn(zero ? k : x, k);
  return zero ? x : q;
}

// torch.clamp(v, 0, 1) on CUDA: NaN kept, else min(max(v, 0), 1).
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// wgt * b + (1 - wgt) * d as ATen's four launches round it.
__device__ __forceinline__ float blend(float wgt, float b, float d) {
  return __fadd_rn(__fmul_rn(wgt, b), __fmul_rn(__fsub_rn(1.0f, wgt), d));
}

// R: the vertical radius (0: no vertical box), or kGeneric for any radius
// over kRingRadius (a.radius), whose taps are read from device memory.
template <int R>
__global__ void __launch_bounds__(kThreads) box_blend_kernel(Args a) {
  extern __shared__ float4 s_raw[];
  float* smem = reinterpret_cast<float*>(s_raw);
  constexpr int kRing = R > 0 ? 2 * R + 1 : 1;
  const int t = threadIdx.x;
  const int tile = blockIdx.x % a.tiles;
  const int rest = blockIdx.x / a.tiles;
  const int y0 = rest % a.strips * kStrip;
  const size_t plane = static_cast<size_t>(rest / a.strips) * a.h * a.w;
  const int x0 = tile * kThreads;
  const int x = x0 + t;  // this thread's column
  const int rows = min(kStrip, a.h - y0);
  const float* depth = a.depth + plane;
  const float* wl = a.wl + plane;
  const float* wr = a.wr + plane;
  // The whole tile in an aligned row: 16-byte copies by the first quarter
  // of the threads. Else column by column (past the row: its last column
  // for the depth, nothing for the weights).
  const bool whole = a.vec && x0 + kThreads <= a.w;
  const int xc = min(x, a.w - 1);
  // The halo column this thread copies, if any: lead on the left, taps / 2
  // on the right, and where it goes in a staged depth row.
  const bool halo = t < a.taps - 1;
  const int hcol = clampi(t < a.lead ? x0 - a.lead + t : x0 + kThreads + t - a.lead, 0, a.w - 1);
  const int hat = t < a.lead ? a.dofs - a.lead + t : a.dofs + kThreads + t - a.lead;

  // Stage m: depth row y0 + m with its halo; with R >= 0 the weights' row
  // y0 + m + R (the newest tap of the window of row y0 + m).
  auto load = [&](int m) {
    float* s = smem + (m % kStages) * a.stage;
    const float* drow = depth + static_cast<size_t>(y0 + m) * a.w;
    const size_t yw = static_cast<size_t>(min(y0 + m + max(R, 0), a.h - 1)) * a.w;
    if (whole) {
      if (t < kThreads / 4) {
        copy16(s + a.dofs + 4 * t, drow + x0 + 4 * t);
        if constexpr (R >= 0) {
          copy16(s + a.wofs + 4 * t, wl + yw + x0 + 4 * t);
          copy16(s + a.wofs + kThreads + 4 * t, wr + yw + x0 + 4 * t);
        }
      }
    } else {
      copy4(s + a.dofs + t, drow + xc);
      if (R >= 0 && x < a.w) {
        copy4(s + a.wofs + t, wl + yw + x);
        copy4(s + a.wofs + kThreads + t, wr + yw + x);
      }
    }
    if (halo) copy4(s + hat, drow + hcol);
    for (int i = t + kThreads; i < a.taps - 1; i += kThreads) {  // halos wider than the tile
      const int col = i < a.lead ? x0 - a.lead + i : x0 + kThreads + i - a.lead;
      copy4(s + (i < a.lead ? a.dofs - a.lead + i : a.dofs + kThreads + i - a.lead),
            drow + clampi(col, 0, a.w - 1));
    }
  };

  // The window's older 2R rows, rows y0 - R .. y0 + R - 1 (a column past the
  // image reads its last one; its outputs are not kept).
  float ring_l[kRing], ring_r[kRing];
  if constexpr (R > 0) {
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
      const size_t at = static_cast<size_t>(clampi(y0 - R + k, 0, a.h - 1)) * a.w + xc;
      ring_l[k] = __ldg(wl + at);
      ring_r[k] = __ldg(wr + at);
    }
  }

#pragma unroll
  for (int m = 0; m < kStages - 1; ++m) {
    if (m < rows) load(m);
    commit();
  }
  const float n_taps = static_cast<float>(a.taps);
  float* left = a.left + plane + static_cast<size_t>(y0) * a.w + x;
  float* right = a.right + plane + static_cast<size_t>(y0) * a.w + x;
  for (int m = 0; m < rows; ++m, left += a.w, right += a.w) {
    wait_pending<kStages - 2>();  // stage m has landed, for this thread's copies ...
    __syncthreads();              // ... and every thread's; stage m - 1 is read
    if (m + kStages - 1 < rows) load(m + kStages - 1);
    commit();
    const float* s = smem + (m % kStages) * a.stage;
    float gl, gr;
    if constexpr (R == 0) {
      gl = s[a.wofs + t];
      gr = s[a.wofs + kThreads + t];
    } else if constexpr (R > 0) {
      ring_l[2 * R] = s[a.wofs + t];
      ring_r[2 * R] = s[a.wofs + kThreads + t];
      float al = ring_l[0], ar = ring_r[0];
#pragma unroll
      for (int k = 1; k < kRing; ++k) {
        al = __fadd_rn(al, ring_l[k]);
        ar = __fadd_rn(ar, ring_r[k]);
      }
      gl = clamp01(div_by(al, static_cast<float>(kRing)));
      gr = clamp01(div_by(ar, static_cast<float>(kRing)));
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) {
        ring_l[k] = ring_l[k + 1];
        ring_r[k] = ring_r[k + 1];
      }
    } else {
      const int y = y0 + m;
      const size_t first = static_cast<size_t>(clampi(y - a.radius, 0, a.h - 1)) * a.w + xc;
      float al = __ldg(wl + first), ar = __ldg(wr + first);
      for (int k = 1; k <= 2 * a.radius; ++k) {
        const size_t at = static_cast<size_t>(clampi(y - a.radius + k, 0, a.h - 1)) * a.w + xc;
        al = __fadd_rn(al, __ldg(wl + at));
        ar = __fadd_rn(ar, __ldg(wr + at));
      }
      const float n_rows = static_cast<float>(2 * a.radius + 1);
      gl = clamp01(div_by(al, n_rows));
      gr = clamp01(div_by(ar, n_rows));
    }
    const float d = s[a.dofs + t];
    float b = d;
    if (a.taps > 1) {
      const float* p = s + a.dofs - a.lead + t;
      float acc = p[0];
#pragma unroll 4
      for (int k = 1; k < a.taps; ++k) acc = __fadd_rn(acc, p[k]);
      b = div_by(acc, n_taps);
    }
    if (x < a.w) {
      *left = blend(gl, b, d);
      *right = blend(gr, b, d);
    }
  }
}

template <int R>
int launch_instance(const Args& a, unsigned blocks, size_t smem, cudaStream_t st) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        box_blend_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  box_blend_kernel<R><<<blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instance of a.radius: R for R <= kRingRadius, else kGeneric.
template <int R>
int dispatch(const Args& a, unsigned blocks, size_t smem, cudaStream_t st) {
  if constexpr (R > kRingRadius) {
    return launch_instance<kGeneric>(a, blocks, smem, st);
  } else {
    if (a.radius == R) return launch_instance<R>(a, blocks, smem, st);
    return dispatch<R + 1>(a, blocks, smem, st);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// depth, wl, wr, left, right: [n, h, w] float32, contiguous. taps >= 1 (1:
// no horizontal box), radius >= 0 (0: no vertical box). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments out of range).
extern "C" int cs_box_blend(const void* depth, const void* wl, const void* wr, void* left,
                            void* right, int n, int h, int w, int taps, int radius,
                            void* stream) {
  if (n < 0 || h < 0 || w < 0 || taps < 1 || taps > kMaxTaps || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || h == 0 || w == 0) return 0;
  Args a{};
  a.depth = static_cast<const float*>(depth);
  a.wl = static_cast<const float*>(wl);
  a.wr = static_cast<const float*>(wr);
  a.left = static_cast<float*>(left);
  a.right = static_cast<float*>(right);
  a.h = h;
  a.w = w;
  a.taps = taps;
  a.radius = radius;
  a.lead = taps - 1 - taps / 2;
  a.tiles = (w + kThreads - 1) / kThreads;
  a.strips = (h + kStrip - 1) / kStrip;
  a.dofs = (a.lead + 3) / 4 * 4;
  a.wofs = (a.dofs + kThreads + taps / 2 + 3) / 4 * 4;
  a.stage = a.wofs + 2 * kThreads;
  a.vec = w % 4 == 0 && aligned16(depth) && aligned16(wl) && aligned16(wr);
  const size_t blocks = static_cast<size_t>(a.tiles) * a.strips * n;
  if (blocks > static_cast<size_t>(INT_MAX)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kStages * static_cast<size_t>(a.stage);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<0>(a, static_cast<unsigned>(blocks), smem, static_cast<cudaStream_t>(stream));
}

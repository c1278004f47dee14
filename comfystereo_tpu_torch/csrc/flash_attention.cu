// Softmax attention with f32 logits and an online softmax over key tiles:
//   out[b, i, :] = sum_j softmax_j(scale * q[b, i, :] . k[b, j, :]) v[b, j, :]
//
// Replaces the Pallas kernel `flash_attention` / `_flash_call` / `_kernel`
// (comfystereo_tpu/pallas/flash_attention.py). It computes what `_kernel`
// computes, in the same order of operations per key tile:
//   s     = q . k^T, bf16 products accumulated in f32, unscaled;
//   m_new = max(m, rowmax(s))                  (running max of the raw logits)
//   e     = exp((s - m_new) * scale), corr = exp((m - m_new) * scale)   (f32)
//   l     = l * corr + rowsum(e)               (f32)
//   acc   = acc * corr + bf16(e) . v           (bf16 weights, f32 accumulation)
//   out   = bf16(acc / l)
// Only the key tile differs: 64 keys here, 1024 on the TPU, so the running
// max is taken at other points and the same f32 sums are rounded in another
// order. The head dimension is padded with zeros to a multiple of 16 inside
// shared memory (the TPU kernel pads d=40 to 64 and d=80 to 128 in HBM).
//
// Bound on Hopper at the UNet's shapes (16 heads x 4096 queries x 4096 keys,
// d=40): 4*bh*nq*nk*d = 4.3e10 tensor-core operations (0.043 ms at 989
// TFLOP/s bf16) and bh*nq*nk = 2.7e8 exponentials (0.069 ms at the special
// function units' ~3.9e12/s), against 21 MB of q/k/v/out (0.006 ms). So the
// exponentials bound it, then the products; the N^2 logits never leave the
// SM. Design: one CTA of 4 warps per (head, block of 64 queries); each warp
// owns 16 query rows, keeps its Q fragments in registers, and runs
// mma.sync m16n8k16 bf16 for both products. Key and value tiles of 64 rows
// are staged in shared memory (V transposed, so the PV B-fragments are
// 32-bit loads); rows are padded by 8 bf16 so fragment loads do not collide
// on banks. The softmax state of a row lives in the 4 lanes that hold it and
// is combined with warp shuffles. No TMA, wgmma or copy/compute overlap yet:
// other CTAs on the SM hide the synchronous tile loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per CTA
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 of padding per shared-memory row
constexpr int kLdV = kBlockK + kPad;  // row length of the transposed V tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values -> one register of two bf16 (round to nearest even), the
// first in the low half, as an mma fragment holds consecutive columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a . b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment) and a 16x8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x d contiguous bf16 from global memory into rows of length ld in
// shared memory; 16-byte chunks when `vec` (d % 8 == 0, aligned pointers).
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int rows, int d,
                                          bool vec) {
  if (vec) {
    const int cpr = d >> 3;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * d + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d;
      dst[r * ld + (i - r * d)] = src[i];
    }
  }
}

// A kBlockK x d tile of V into shared memory as its transpose [d][kLdV].
__device__ __forceinline__ void load_vt(__nv_bfloat16* vt, const __nv_bfloat16* src, int d,
                                        bool vec) {
  if (vec) {
    const int cpr = d >> 3;
    for (int i = threadIdx.x; i < kBlockK * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * d + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kLdV + r] = e[j];
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * d; i += kThreads) {
      const int r = i / d;
      vt[(i - r * d) * kLdV + r] = src[i];
    }
  }
}

// DP: the head dimension padded to a multiple of 16 (the mma depth).
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int nq, int nk,
    int d, float scale, bool vec) {
  constexpr int kLd = DP + kPad;  // row length of the Q and K tiles
  constexpr int kSteps = DP / 16;  // mma k-steps of q . k^T
  constexpr int kOut = DP / 8;     // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * kLd;
  __nv_bfloat16* vt = ks + kBlockK * kLd;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
  const __nv_bfloat16* kb = k + static_cast<long long>(bh) * nk * d;
  const __nv_bfloat16* vb = v + static_cast<long long>(bh) * nk * d;

  // Zero padding columns (Q, K) and rows (V^T) stay zero; then the Q tile.
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < (kBlockQ + kBlockK) * kLd + DP * kLdV; i += kThreads)
    qs[i] = zero;
  __syncthreads();
  const int q_rows = min(kBlockQ, nq - q0);
  load_rows(qs, kLd, q + (static_cast<long long>(bh) * nq + q0) * d, q_rows, d, vec);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + t4 * 2;
    qf[s][0] = ld32(qs + (r0 + g) * kLd + c);
    qf[s][1] = ld32(qs + (r0 + g + 8) * kLd + c);
    qf[s][2] = ld32(qs + (r0 + g) * kLd + c + 8);
    qf[s][3] = ld32(qs + (r0 + g + 8) * kLd + c + 8);
  }

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  // This lane's two rows: r0 + g (index 0) and r0 + g + 8 (index 1).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int kt = 0; kt < nk; kt += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows(ks, kLd, kb + static_cast<long long>(kt) * d, kBlockK, d, vec);
    load_vt(vt, vb + static_cast<long long>(kt) * d, d, vec);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * kLd + st * 16 + t4 * 2;
        mma_bf16(s[n], qf[st], ld32(kp), ld32(kp + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = expf((m0 - mx0) * scale), c1 = expf((m1 - mx1) * scale);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // exp of the tile; the accumulator layout of key columns 16j..16j+15
    // is the A-fragment layout of the PV product's k-step j.
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float e00 = expf((s[n][0] - m0) * scale), e01 = expf((s[n][1] - m0) * scale);
      const float e10 = expf((s[n][2] - m1) * scale), e11 = expf((s[n][3] - m1) * scale);
      l0 += e00 + e01;
      l1 += e10 + e11;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(e00, e01);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(e10, e11);
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        const __nv_bfloat16* vp = vt + (n * 8 + g) * kLdV + j * 16 + t4 * 2;
        mma_bf16(acc[n], pf[j], ld32(vp), ld32(vp + 8));
      }
    }
  }

  // Each lane summed its own columns of the row; add the group's four.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  __nv_bfloat16* ob = o + static_cast<long long>(bh) * nq * d;
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    const int c = n * 8 + t4 * 2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (c + j >= d) continue;
      if (row0 < nq) ob[static_cast<long long>(row0) * d + c + j] = __float2bfloat16(acc[n][j] / l0);
      if (row1 < nq)
        ob[static_cast<long long>(row1) * d + c + j] = __float2bfloat16(acc[n][2 + j] / l1);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int nq, int nk, int d,
           float scale, bool vec, cudaStream_t stream) {
  const int smem = ((kBlockQ + kBlockK) * (DP + kPad) + DP * kLdV) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq, nk, d, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q: [bh, nq, d], k and v: [bh, nk, d], o: [bh, nq, d], all contiguous bf16;
// 1 <= d <= 128 and nk a multiple of 64. Returns the cudaError_t of the launch.
extern "C" int cs_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       int bh, int nq, int nk, int d, float scale,
                                       void* stream) {
  if (bh == 0 || nq == 0) return 0;
  if (bh < 0 || bh > 65535 || nq < 0 || d < 1 || d > 128 || nk <= 0 || nk % kBlockK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 2: return launch<32>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 3: return launch<48>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 4: return launch<64>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 5: return launch<80>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 6: return launch<96>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    case 7: return launch<112>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
    default: return launch<128>(q, k, v, o, bh, nq, nk, d, scale, vec, s);
  }
}

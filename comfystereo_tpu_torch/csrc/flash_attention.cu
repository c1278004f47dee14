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
// Each exponential is one fused multiply-add and one ex2:
// exp((s - m) * scale) = ex2(fma(s, c, -m * c)) with c = scale * log2(e).
// The key tile is 128 keys here, 1024 on the TPU, so the running max is taken
// at other points and the same f32 sums are rounded in another order.
//
// Bound on Hopper at the UNet's level-0 shape (16 heads x 4096 queries x
// 4096 keys, d = 40): 2.7e8 exponentials (0.069 ms at the special function
// units' ~3.9e12/s), then 4*bh*nq*nk*d = 4.3e10 tensor-core operations
// (0.043 ms at 989 TFLOP/s bf16), against 21 MB of q/k/v/out (0.006 ms).
// The N^2 logits never leave the SM.
//
// Design (Hopper: TMA, mbarriers, wgmma, warp specialisation):
// - one CTA of three warpgroups per (head, 128 queries). Warpgroups 0 and 1
//   consume, 64 query rows each; one thread of warpgroup 2 produces.
//   setmaxnreg moves the producer's registers to the consumers. At the
//   UNet's level 1 (16 heads x 1024 queries) that is 128 CTAs, one wave on
//   132 SMs;
// - the producer loads the Q tile once and keeps K and V tiles of 128 keys
//   in flight in a ring of stages (4 for d <= 64, 2 for d <= 128) with TMA
//   (cp.async.bulk.tensor), signalling full mbarriers; a consumer releases a
//   stage on its empty mbarrier after its P.V wgmma has been waited on;
// - tensor maps are 2-D over [rows, d] bf16 with a [64, 128] box and 128-byte
//   swizzle; TMA zero-fills the columns past d, so the head dimension is
//   padded to DP = 64 or 128 in shared memory only (d % 8 == 0: the wrapper
//   pads other d in PyTorch). Each 64-column block of a tile is 16 KB. DP
//   is the TPU kernel's padding; tiles of 48 or 80 columns with 32- or
//   64-byte swizzle were not tried: Q.K^T stops at d instead (below), and
//   P.V runs at the full DP;
// - S = Q.K^T by wgmma m64n128k16 with both operands K-major in shared memory,
//   in ceil(d / 16) k-steps (a template parameter: the zero columns past
//   them add nothing); the softmax stays in f32 registers (row max over the
//   quad by shuffles);
//   O += P.V by wgmma with P as the register A operand (the S accumulator
//   layout of 16 key columns is the A fragment of one k-step) and V from
//   shared memory as an MN-major B (the transpose flag; nothing is moved by
//   hand);
// - the exponentials (special function units) and the products (tensor
//   cores) overlap twice over: each warpgroup starts Q.K^T of tile t and P.V
//   of tile t - 1 together and runs the softmax of t while P.V runs, and the
//   two warpgroups take turns to start their products (named barriers), so
//   one's softmax runs beside the other's products;
// - epilogue: acc / l in bf16 is staged, swizzled, in the warpgroup's own Q
//   rows and written with 16-byte stores of the d real columns.
// A wait on an mbarrier that lasts about a second traps, so a fault in the
// pipeline ends the launch with an error rather than hanging the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;                   // query rows per CTA
constexpr int kBlockK = 128;                   // keys per tile
constexpr int kAtom = 64;                      // bf16 columns per 128-byte swizzled row
constexpr int kBlockBytes = kBlockK * 128;     // one [128 rows, 64 columns] block: 16 KB
constexpr int kThreads = 384;                  // warpgroups 0-1 consume, 2 produces
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Named barriers: 1 + wg for a consumer warpgroup's epilogue, 3 + wg for its
// turn to start its products (the two consumers take turns, so one's
// softmax overlaps the other's products).
constexpr int kEpilogueBar = 1, kTurnBar = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// Named barriers of `count` threads: sync waits, arrive does not.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- TMA -----------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand in shared memory; address and
// offsets in bytes (encoded in 16-byte units). K-major: sbo = 1024 (8 rows of
// 128 B), lbo unused. MN-major: sbo = 1024 (8 k-rows), lbo = the distance
// between 64-column blocks.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_p(uint32_t (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[j][r])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F16(i) F4(i), F4((i) + 4), F4((i) + 8), F4((i) + 12)
#define F32(i) F16(i), F16((i) + 16)
#define R32                                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define R64_HI                                                                                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "     \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128 f32) = A . B (+ d when `accumulate`): A 64x16 and B 16x128 bf16,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" R32 ", " R64_HI "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F32(0), F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A . B: A 64x16 bf16 in registers, B 16x64 bf16 MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" R32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128 f32) += A . B: A 64x16 bf16 in registers, B 16x128 bf16
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" R32 ", " R64_HI "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : F32(0), F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef F4
#undef F16
#undef F32
#undef R32
#undef R64_HI

// --- softmax arithmetic -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values -> one register of two bf16 (round to nearest even), the
// first in the low half, as a fragment holds consecutive columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q.K^T over KS k-steps of 16 columns (the columns past them are zero):
// Q (this warpgroup's 64 rows at qa) and K (128 keys at kt), both in
// 64-column blocks of 16 KB.
template <int KS>
__device__ __forceinline__ void mma_qk(float (&sacc)[64], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    const uint32_t off = (st >> 2) * kBlockBytes + (st & 3) * 32;
    wgmma_ss_n128(sacc, smem_desc(qa + off, 16, 1024), smem_desc(kt + off, 16, 1024), st > 0);
  }
}

// O += P.V: k-step j takes keys 16j..16j+15 (16 rows of 128 B at vt) and the
// A fragment p[j].
template <int NB>
__device__ __forceinline__ void mma_pv(float (&acc)[NB * 32], const uint32_t (&p)[8][4],
                                         uint32_t vt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t db = smem_desc(vt + j * 16 * 128, kBlockBytes, 1024);
    if constexpr (NB == 1) {
      wgmma_rs_n64(acc, p[j], db);
    } else {
      wgmma_rs_n128(acc, p[j], db);
    }
  }
}

// One online-softmax step on a tile of logits, in place: the running max
// (m) and sum (l) of this thread's two rows take in the tile, and s becomes
// exp((s - m) * scale) in f32. Returns the rows' corrections
// exp((m_old - m) * scale), by which the caller scales O.
__device__ __forceinline__ float2 softmax_tile(float (&s)[64], float& m0, float& m1, float& l0,
                                               float& l1, float c) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float mc0 = mx0 * c, mc1 = mx1 * c;
  const float corr0 = ex2(__fmaf_rn(m0, c, -mc0)), corr1 = ex2(__fmaf_rn(m1, c, -mc1));
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      s[8 * j + r] = ex2(__fmaf_rn(s[8 * j + r], c, (r & 2) ? -mc1 : -mc0));
    sum0 += (s[8 * j] + s[8 * j + 1]) + (s[8 * j + 4] + s[8 * j + 5]);
    sum1 += (s[8 * j + 2] + s[8 * j + 3]) + (s[8 * j + 6] + s[8 * j + 7]);
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
  return make_float2(corr0, corr1);
}

// The accumulator layout of key columns 16j..16j+15 is the A-fragment
// layout of the P.V product's k-step j: consecutive pairs, rounded to bf16.
__device__ __forceinline__ void pack_p(const float (&e)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[j][r] = pack_bf16(e[8 * j + 2 * r], e[8 * j + 2 * r + 1]);
}

// NB: 64-column blocks of the padded head dimension (DP = 64 * NB).
template <int NB>
struct Config {
  static constexpr int kStages = NB == 1 ? 4 : 2;
  static constexpr int kTile = NB * kBlockBytes;  // bytes of one Q, K or V tile
  static constexpr int kSmem = kTile * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// KS: Q.K^T k-steps, ceil(d / 16); NB = ceil(KS / 4) 64-column blocks of the
// padded head dimension.
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap qmap,
                     __grid_constant__ const CUtensorMap kmap,
                     __grid_constant__ const CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                     int nq, int nk, int d, float c) {
  constexpr int NB = (KS + 3) / 4;
  constexpr int kStages = Config<NB>::kStages;
  constexpr int kTile = Config<NB>::kTile;
  extern __shared__ unsigned char smem_raw[];
  // q_full, then k_full, v_full and empty per stage.
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];

  // Swizzled tiles need 1024-byte alignment.
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + kTile;             // K stage s at ks + s * kTile
  const uint32_t vs = ks + kStages * kTile;   // V stage s at vs + s * kTile
  const uint32_t q_full = smem_u32(bars);
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tiles = nk / kBlockK;
  // The warpgroup's role, read from lane 0 so the compiler knows it is
  // uniform across the warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      const int krow = bh * nk;
      mbar_expect_tx(q_full, kTile);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load_2d(qs + b * kBlockBytes, &qmap, q_full, b * kAtom, bh * nq + q0);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTile);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load_2d(ks + s * kTile + b * kBlockBytes, &kmap, k_full + 8 * s, b * kAtom,
                      krow + t * kBlockK);
        mbar_expect_tx(v_full + 8 * s, kTile);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load_2d(vs + s * kTile + b * kBlockBytes, &vmap, v_full + 8 * s, b * kAtom,
                      krow + t * kBlockK);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
    const uint32_t qa = qs + wg * 64 * 128;   // this warpgroup's rows in each Q block

    float sacc[64];      // S: 64 x 128 logits of this warpgroup, then their exponentials
    float acc[NB * 32];  // O: 64 x DP
    uint32_t p[8][4];    // bf16 exponentials, the A operand of P.V
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) acc[i] = 0.0f;
    // This thread's two rows: 16 * warp + g (index 0) and 16 * warp + g + 8 (1).
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    // Tile 0, then for each tile t: Q.K^T of t and P.V of t - 1 in flight
    // together, the softmax of t overlapping P.V of t - 1.
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    fence_regs(sacc);
    wgmma_fence();
    mma_qk<KS>(sacc, qa, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile(sacc, m0, m1, l0, l1, c);
    pack_p(sacc, p);
    if (wg == 1) bar_arrive(kTurnBar, 256);  // warpgroup 0 goes first
    for (int t = 1; t < tiles; ++t) {
      const int s = t % kStages, sp = (t - 1) % kStages;
      mbar_wait(k_full + 8 * s, (t / kStages) & 1);
      bar_sync(kTurnBar + wg, 256);
      fence_regs(sacc);
      wgmma_fence();
      mma_qk<KS>(sacc, qa, ks + s * kTile);
      wgmma_commit();
      mbar_wait(v_full + 8 * sp, ((t - 1) / kStages) & 1);
      fence_regs(acc);
      fence_p(p);
      wgmma_fence();
      mma_pv<NB>(acc, p, vs + sp * kTile);
      wgmma_commit();
      bar_arrive(kTurnBar + 1 - wg, 256);
      wgmma_wait<1>();  // Q.K^T of tile t is done; P.V of t - 1 runs on
      fence_regs(sacc);
      const float2 corr = softmax_tile(sacc, m0, m1, l0, l1, c);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p(p);
      mbar_arrive(empty + 8 * sp);
#pragma unroll
      for (int i = 0; i < NB * 8; ++i) {
        acc[4 * i] *= corr.x;
        acc[4 * i + 1] *= corr.x;
        acc[4 * i + 2] *= corr.y;
        acc[4 * i + 3] *= corr.y;
      }
      pack_p(sacc, p);
    }
    if (wg == 0) bar_sync(kTurnBar, 256);  // warpgroup 1's last turn
    const int sl = (tiles - 1) % kStages;
    mbar_wait(v_full + 8 * sl, ((tiles - 1) / kStages) & 1);
    fence_regs(acc);
    fence_p(p);
    wgmma_fence();
    mma_pv<NB>(acc, p, vs + sl * kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_p(p);
    mbar_arrive(empty + 8 * sl);

    // Each lane summed its own columns of the row; add the quad's four.
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    // Stage bf16(acc / l) in this warpgroup's own Q rows (its last Q.K^T has
    // been waited on), 16-byte chunks swizzled by row so that neither these
    // stores nor the reads below collide on banks.
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int i = 0; i < NB * 8; ++i) {
      const uint32_t blk = qa + (i >> 3) * kBlockBytes;
      const uint32_t col = (((i & 7) ^ (r0 & 7)) << 4) + t4 * 4;
      const uint32_t v0 = pack_bf16(acc[4 * i] / l0, acc[4 * i + 1] / l0);
      const uint32_t v1 = pack_bf16(acc[4 * i + 2] / l1, acc[4 * i + 3] / l1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(blk + r0 * 128 + col), "r"(v0) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(blk + (r0 + 8) * 128 + col), "r"(v1)
                   : "memory");
    }
    bar_sync(kEpilogueBar + wg, 128);
    const int chunks = d >> 3;  // 16-byte chunks of a row's d real columns
    __nv_bfloat16* ob = o + (static_cast<long long>(bh) * nq + q0 + wg * 64) * d;
    for (int i = tid; i < 64 * chunks; i += 128) {
      const int r = i / chunks, ch = i - r * chunks;
      const uint32_t src = qa + (ch >> 3) * kBlockBytes + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(src)
                   : "memory");
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * d + ch * 8) = val;
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so the library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows, d] bf16 tensor map with a [64, 128] box, 128-byte swizzle and zero
// fill past d.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, long long rows, int d) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {kAtom, kBlockK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS>
int launch(EncodeTiledFn encode, const void* q, const void* k, const void* v, void* o, int bh,
           int nq, int nk, int d, float c, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(encode, &qmap, q, static_cast<long long>(bh) * nq, d) ||
      !make_map(encode, &kmap, k, static_cast<long long>(bh) * nk, d) ||
      !make_map(encode, &vmap, v, static_cast<long long>(bh) * nk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Config<(KS + 3) / 4>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nq / kBlockQ, bh);
  flash_fwd_kernel<KS><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), nq, nk, d, c);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q: [bh, nq, d], k and v: [bh, nk, d], o: [bh, nq, d], all contiguous bf16
// with 16-byte aligned data; 8 <= d <= 128 with d % 8 == 0, nq and nk
// multiples of 128. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for anything else).
extern "C" int cs_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       int bh, int nq, int nk, int d, float scale,
                                       void* stream) {
  if (bh == 0 || nq == 0) return 0;
  if (bh < 0 || bh > 65535 || nq < 0 || nq % kBlockQ != 0 || nk <= 0 || nk % kBlockK != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o) || static_cast<long long>(bh) * (nq > nk ? nq : nk) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 2: return launch<2>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 3: return launch<3>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 4: return launch<4>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 5: return launch<5>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 6: return launch<6>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    case 7: return launch<7>(encode, q, k, v, o, bh, nq, nk, d, c, s);
    default: return launch<8>(encode, q, k, v, o, bh, nq, nk, d, c, s);
  }
}

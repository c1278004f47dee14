// Host-side pixel-conversion kernels for the streaming video path.
//
// The marshalling around cv2 decode/encode: BGR uint8 -> RGB float32 [0,1]
// on ingest, luma extraction for depth videos, and RGB float32 -> BGR uint8
// on writeback (reference GenerateStereo.py:131-171 does the same marshalling
// with torch/numpy). numpy runs these single-threaded; these kernels
// partition rows across std::thread workers and run the inner loops
// branch-free so the compiler vectorizes them.
//
// Exposed via ctypes (comfystereo_tpu_torch/native/__init__.py builds this
// file with g++ on first use and falls back to numpy when no toolchain
// exists). The port's video loop converts BGR chunks on the GPU instead
// (utils/video.py:device_chunk); these serve host-side callers.
//
// Semantics notes:
//  * f32 -> u8 uses C truncation after clamping, matching numpy's
//    `(x * 255).astype(np.uint8)` cast on in-range values.
//  * luma uses the reference's Rec.601 weights (GenerateStereo.py:135).
#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Run fn(begin_px, end_px) over [0, n_px) partitioned across `threads`.
template <typename Fn>
void parallel_for(int64_t n_px, int threads, Fn fn) {
  if (threads <= 1 || n_px < (1 << 16)) {
    fn(0, n_px);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  const int64_t step = (n_px + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * step;
    const int64_t hi = std::min(n_px, lo + step);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto &th : pool) th.join();
}

}  // namespace

extern "C" {

// src: [n_px, 3] interleaved BGR uint8; dst: [n_px, 3] RGB float32 in [0,1].
void bgr_u8_to_rgb_f32(const uint8_t *src, float *dst, int64_t n_px,
                       int threads) {
  // IEEE division (not reciprocal multiply) so the result is bit-identical
  // to numpy's `astype(float32) / 255.0`; the loop is memory-bound either
  // way. A 256-entry LUT keeps it cheap regardless.
  float lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = static_cast<float>(v) / 255.0f;
  parallel_for(n_px, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t *p = src + 3 * i;
      float *q = dst + 3 * i;
      q[0] = lut[p[2]];
      q[1] = lut[p[1]];
      q[2] = lut[p[0]];
    }
  });
}

// src: [n_px, 3] RGB float32 (any range); dst: [n_px, 3] BGR uint8.
// Values are scaled by 255, clamped to [0, 255], and truncated (numpy cast).
void rgb_f32_to_bgr_u8(const float *src, uint8_t *dst, int64_t n_px,
                       int threads) {
  parallel_for(n_px, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float *p = src + 3 * i;
      uint8_t *q = dst + 3 * i;
      for (int c = 0; c < 3; ++c) {
        float v = p[2 - c] * 255.0f;
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        q[c] = static_cast<uint8_t>(v);
      }
    }
  });
}

// src: [n_px, 3] interleaved BGR uint8; dst: [n_px] float32 Rec.601 luma in
// [0,1] (0.2989 R + 0.5870 G + 0.1140 B, the node's depth-gray weights).
void bgr_u8_to_gray_f32(const uint8_t *src, float *dst, int64_t n_px,
                        int threads) {
  parallel_for(n_px, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t *p = src + 3 * i;
      // IEEE division matches numpy's `/ 255.0` bit-for-bit.
      dst[i] = (0.2989f * p[2] + 0.5870f * p[1] + 0.1140f * p[0]) / 255.0f;
    }
  });
}

}  // extern "C"

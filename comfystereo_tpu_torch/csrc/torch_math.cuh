// Float32 arithmetic in the forms PyTorch's CUDA kernels give it, for fused
// kernels whose plain versions are PyTorch expressions.
#pragma once

#include <math.h>

namespace cs {

// torch.pow(x, e) for a float32 tensor and a Python float e: ATen fills 1
// for e == 0 and copies for e == 1; its CUDA kernel takes sqrt, rsqrt and
// the reciprocal for 0.5, -0.5 and -1, and x*x, x*x*x and 1/(x*x) for e ==
// 2, 3 and -2 once e is rounded to float32; powf otherwise. The wrapper
// picks the mode (kernels/_common.py:pow_mode), so every case is one branch
// that the whole grid takes.
enum PowMode : int {
  kPowOne = 0, kPowCopy, kPowSqrt, kPowRsqrt, kPowRecip, kPowSquare, kPowCube,
  kPowRecipSquare, kPowGeneral
};

__device__ __forceinline__ float torch_pow(float x, float e, int mode) {
  switch (mode) {
    case kPowOne: return 1.0f;
    case kPowCopy: return x;
    case kPowSqrt: return sqrtf(x);
    case kPowRsqrt: return rsqrtf(x);
    case kPowRecip: return 1.0f / x;
    case kPowSquare: return x * x;
    case kPowCube: return x * x * x;
    case kPowRecipSquare: return 1.0f / (x * x);
    default: return powf(x, e);
  }
}

// torch.sign of a float32 value: (0 < x) - (x < 0).
__device__ __forceinline__ float torch_sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

}  // namespace cs

// The z taps of the composite, shared by K4 (composite.cu) and its adjoint
// K14 (composite_grad.cu), so that the backward reads exactly the froxels
// and weights that the forward read.
#pragma once

#include <cuda_runtime.h>

// froxel.depth_to_froxel_z - 0.5 of the pixel's depth, clipped to the
// volume: the two z taps and the lerp weight.
__device__ __forceinline__ void depth_taps(float depth, const float* fp,
                                           int d, int& z0, int& z1,
                                           float& f) {
  const float fpz = fp[0], fpw = fp[1], near_ = fp[2];
  float fz = (float)d * logf(fmaxf((depth - near_) / fpw + 1.0f, 1e-8f))
             / logf(fpz);
  fz = fz - 0.5f;
  fz = fminf(fmaxf(fz, 0.0f), (float)d - 1.0f);
  const float z0f = floorf(fz);
  f = fz - z0f;
  z0 = min(max((int)z0f, 0), d - 1);
  z1 = min(z0 + 1, d - 1);
}

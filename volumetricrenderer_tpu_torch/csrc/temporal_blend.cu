// K10 temporal_blend: reproject, warp the history and blend, in one pass.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/temporal.py
// `_kernel` / `fused_temporal_blend`, which walked z sequentially with the
// history slices in a (2k+2)-deep VMEM ring and ran the three tent passes
// on whole [H, W] planes. On the GPU every froxel is independent: one
// thread per froxel evaluates the analytic reprojection offsets
// (common.cuh reproj_offsets), gathers its 8 history taps per channel
// (warp8, the three passes collapsed, summed in the passes' order) and
// lerps against the current value. These are the functions shadow_blend.cu
// and integrate_blend.cu use on values they hold in registers, so the
// raycast shadow (dir_shadow.cu) followed by this kernel in weight mode
// gives shadow_blend.cu's volume bit for bit, and the integration
// (integrate.cu) followed by the alpha mode gives integrate_blend.cu's.
//
// Per froxel (z, y, x) and channel c of n_ch:
//   out[c] = cur[c] + wgt * (warped prev[c] - cur[c])
//   mode 0 "weight" (shadow blend; offsets take the jitter):
//          wgt = alpha * success_xy
//   mode 1 "alpha" (accumulation blend; no jitter):
//          wgt = alpha * (warped last channel != 0)
// bpar is a pack_blend_params table [24]. Writes a new buffer: the warp
// reads neighbours of the history.
//
// Bound on the H100: bytes. Read prev and cur, write out: 3 n_ch planes of
// 16.6 MB at 240x135x128 -- 0.015 ms for one shadow channel, 0.059 ms for
// the four accumulation channels at 3.35 TB/s. Work: 7 reprojections (the
// froxel's own and those at the 6 neighbour columns the passes read; each
// a log, an exp and 2 divides) and 14 multiply-adds per channel, ~400
// flops per froxel, ~25 us at the fp32 rate: recomputing the offsets
// instead of staging offset volumes trades flops for bytes.
#include "common.cuh"

template <int NC>
__global__ void temporal_blend_kernel(const float* __restrict__ bpar,
                                      const float* __restrict__ prev,
                                      const float* __restrict__ cur,
                                      float* __restrict__ out, int w, int h,
                                      int d, int h_glob, int k, int mode) {
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));
  const bool with_jitter = mode == 0;
  const float vzc = view_z(bpar, (float)z + 0.5f, d);
  const Reproj r0 = reproj_offsets(bpar, z, y, x, vzc, w, h, d, h_glob, k,
                                   with_jitter);
  float warped[NC];
  warp8<NC>(bpar, prev, n, z, y, x, vzc, w, h, d, h_glob, k, with_jitter, r0,
            warped);
  const float wgt = mode == 0
      ? bpar[20] * r0.success
      : bpar[20] * (warped[NC - 1] != 0.0f ? 1.0f : 0.0f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float v = __ldg(cur + c * n + i);
    out[c * n + i] = v + wgt * (warped[c] - v);
  }
}

extern "C" int vr_temporal_blend(const float* bpar, const float* prev,
                                 const float* cur, float* out, int n_ch,
                                 int w, int h, int d, int h_glob, int k,
                                 int mode, cudaStream_t stream) {
  const long n = (long)d * h * w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
#define VR_BLEND(NC)                                                  \
  temporal_blend_kernel<NC><<<grid, block, 0, stream>>>(              \
      bpar, prev, cur, out, w, h, d, h_glob, k, mode)
  switch (n_ch) {
    case 1: VR_BLEND(1); break;
    case 2: VR_BLEND(2); break;
    case 3: VR_BLEND(3); break;
    case 4: VR_BLEND(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VR_BLEND
  return (int)cudaGetLastError();
}

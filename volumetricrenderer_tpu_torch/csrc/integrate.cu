// K8 integrate: jittered sample of the scatter planes -> front-to-back
// integration, no temporal blend.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/integrate.py
// `_kernel` / `accumulate_fused_pallas`, which walked z in d + 1 sequential
// grid steps with the xy-blended previous plane and the (L, T) carry in VMEM
// scratch. The frame runs it when temporal_blend_accumulation is off; with
// the blend on, integrate_blend.cu integrates the same way and blends in the
// same pass.
//
// One thread owns one (y, x) column and carries (L, T) in registers while
// it marches z. Per slice z:
//   xyb(z)   = 3-tap clamped xy tent of the 4 scatter planes at the jitter
//              offset (ox, oy);
//   sampled  = xyb(z) + oz * (xyb(z+1) - xyb(z)); the top slice lerps
//              xyb(d-1) with itself (clamp to edge);
//   the per-slice integral (expm1 form, Taylor below od = 1e-2) advances
//   the carry, which is the stored value.
//
// Bound on the H100: bytes. Read the scatter planes and write the
// accumulation, 2 x 66 MB at 240x135x128, ~40 us at 3.35 TB/s; the work is
// ~100 flops per froxel, ~6 us. This first form reads each scatter value 9
// times (through L1/L2), and its 32,400 column threads under-fill 132 SMs,
// as integrate_blend.cu's do.
#include "common.cuh"

__global__ void integrate_kernel(VrTables T, const float* __restrict__ sc,
                                 float* __restrict__ out_acc) {
  const int w = T.w, h = T.h, d = T.d;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w * h) return;
  const int x = i % w;
  const int y = i / w;
  const long n = (long)d * h * w;
  const float* ap = T.abpar;
  const float fpw = ap[15], near_ = ap[16];
  const float oz = ap[26];
  float wts[6];
  xy_blend_weights(ap[24], ap[25], wts);
  const float lfpz = logf(ap[14]);

  float cur[4], nxt[4];
  xy_blend4(sc, n, 0, y, x, w, h, wts, cur);
  float carry[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  for (int z = 0; z < d; ++z) {
    if (z + 1 < d) {
      xy_blend4(sc, n, z + 1, y, x, w, h, wts, nxt);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) nxt[c] = cur[c];
    }
    float sampled[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sampled[c] = cur[c] + oz * (nxt[c] - cur[c]);
    integrate_slice(lfpz, fpw, near_, z, d, sampled, carry);
    const long o = ((long)z * h + y) * w + x;
#pragma unroll
    for (int c = 0; c < 4; ++c) out_acc[c * n + o] = carry[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
  }
}

extern "C" int vr_integrate(const VrTables* T, const float* sc,
                            float* out_acc, cudaStream_t stream) {
  const int n = T->w * T->h;
  const int block = 64;
  integrate_kernel<<<(n + block - 1) / block, block, 0, stream>>>(*T, sc,
                                                                  out_acc);
  return (int)cudaGetLastError();
}

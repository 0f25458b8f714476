// K3 integrate_blend: jittered xy sample -> front-to-back integration ->
// accumulation temporal blend.
//
// Replaces the integrate and accumulation-blend stages of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 281-324 and 365-388, with integrate.make_xy_blend and
// temporal._reproj_offsets/_tent_pass inlined), and the standalone TPU
// kernel that computes the same four planes for the staged frame
// (volumetricrenderer_tpu/ops/pallas/integrate_blend.py `_kernel` /
// `integrate_blend_fused`). The TPU carried (L, T) from
// one sequential grid step to the next in VMEM scratch; here one thread owns
// one (y, x) column and carries (L, T) in registers while it marches z.
//
// Per slice z of the column:
//   xyb(z)   = 3-tap clamped xy tent of the 4 scatter planes at the jitter
//              offset (ox, oy); the top slice's upper tap is xyb(d-1) itself;
//   sampled  = xyb(z) + oz * (xyb(z+1) - xyb(z));
//   the per-slice integral (expm1 form, Taylor below od = 1e-2) advances
//   the (L, T) carry; then the alpha-mode blend against the previous
//   accumulation (8-tap warp, offsets unjittered with eps = 0, weight
//   alpha * (warped T != 0)) gives the stored value. The carry continues
//   with the un-blended values.
//
// Bound on the H100: bytes. Read the scatter planes (66 MB) and the previous
// accumulation (66 MB), write the new accumulation (66 MB) at FULL: ~200 MB,
// ~60 us at 3.35 TB/s. This first form reads each scatter value 9 times
// (through L1/L2) and the warp recomputes 7 reprojections per froxel; its
// 32,400 column threads under-fill 132 SMs, which a later change that splits
// the column march or stages tiles in shared memory can address.
#include "common.cuh"

__global__ void integrate_blend_kernel(VrTables T,
                                       const float* __restrict__ sc,
                                       const float* __restrict__ prev_acc,
                                       float* __restrict__ out_acc) {
  const int w = T.w, h = T.h, d = T.d;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w * h) return;
  const int x = i % w;
  const int y = i / w;
  const long n = (long)d * h * w;
  const float* ap = T.abpar;
  const float fpw = ap[15], near_ = ap[16];
  const float alpha = ap[20];
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

    // accumulation blend (alpha mode: success = warped T != 0); the carry
    // continues with the un-blended values
    const float vzc = view_z(ap, (float)z + 0.5f, d);
    const Reproj r0 = reproj_offsets(ap, z, y, x, vzc, w, h, d, T.h_glob,
                                     T.k, false);
    float warped[4];
    warp8<4>(ap, prev_acc, n, z, y, x, vzc, w, h, d, T.h_glob, T.k, false,
             r0, warped);
    const float wgt = alpha * (warped[3] != 0.0f ? 1.0f : 0.0f);
    const long o = ((long)z * h + y) * w + x;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out_acc[c * n + o] = carry[c] + wgt * (warped[c] - carry[c]);
#pragma unroll
    for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
  }
}

extern "C" int vr_integrate_blend(const VrTables* T, const float* sc,
                                  const float* prev_acc, float* out_acc,
                                  cudaStream_t stream) {
  const int n = T->w * T->h;
  const int block = 64;
  integrate_blend_kernel<<<(n + block - 1) / block, block, 0, stream>>>(
      *T, sc, prev_acc, out_acc);
  return (int)cudaGetLastError();
}

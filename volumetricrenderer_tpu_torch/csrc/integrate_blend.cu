// K3 integrate_blend: jittered xy sample -> front-to-back integration ->
// accumulation temporal blend.
//
// Replaces the integrate and accumulation-blend stages of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 281-324 and 365-388, with integrate.make_xy_blend and
// temporal._reproj_offsets/_tent_pass inlined). The TPU carried (L, T) from
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

__device__ __forceinline__ void xy_blend4(const float* __restrict__ sc,
                                          long n, int z, int y, int x,
                                          int w, int h, const float* wts,
                                          float* out) {
  const int xm = max(x - 1, 0), xp = min(x + 1, w - 1);
  const int ym = max(y - 1, 0), yp = min(y + 1, h - 1);
  const int rows[3] = {ym, y, yp};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* pl = sc + c * n + (long)z * h * w;
    float px[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* row = pl + (long)rows[r] * w;
      px[r] = wts[0] * __ldg(row + xm) + wts[1] * __ldg(row + x)
              + wts[2] * __ldg(row + xp);
    }
    out[c] = wts[3] * px[0] + wts[4] * px[1] + wts[5] * px[2];
  }
}

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
  const float fpz = ap[14], fpw = ap[15], near_ = ap[16];
  const float alpha = ap[20];
  const float ox = ap[24], oy = ap[25], oz = ap[26];
  const float wts[6] = {fmaxf(-ox, 0.0f), 1.0f - fabsf(ox), fmaxf(ox, 0.0f),
                        fmaxf(-oy, 0.0f), 1.0f - fabsf(oy), fmaxf(oy, 0.0f)};
  const float lfpz = logf(fpz);

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

    const float zf = (float)z;
    const float vz_hi = (expf(lfpz * (zf + 0.5f) / (float)d) - 1.0f) * fpw
                        + near_;
    const float vz_lo = zf > 0.0f
        ? (expf(lfpz * (zf - 0.5f) / (float)d) - 1.0f) * fpw + near_
        : near_;
    const float dz = vz_hi - vz_lo;
    const float od = sampled[3] * dz;
    const float t = expf(-od);
    const bool small = od < 1e-2f;
    const float factor = small
        ? dz * (1.0f - 0.5f * od * (1.0f - od / 3.0f))
        : (1.0f - t) / sampled[3];
    const float tc = carry[3];
    float vals[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) vals[c] = carry[c] + tc * sampled[c] * factor;
    vals[3] = tc * t;
#pragma unroll
    for (int c = 0; c < 4; ++c) carry[c] = vals[c];

    // accumulation blend (alpha mode: success = warped T != 0)
    const float vzc = view_z(ap, zf + 0.5f, d);
    const Reproj r0 = reproj_offsets(ap, z, y, x, vzc, w, h, d, T.h_glob,
                                     T.k, false);
    float warped[4];
    warp8<4>(ap, prev_acc, n, z, y, x, vzc, w, h, d, T.h_glob, T.k, false,
             r0, warped);
    const float wgt = alpha * (warped[3] != 0.0f ? 1.0f : 0.0f);
    const long o = ((long)z * h + y) * w + x;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out_acc[c * n + o] = vals[c] + wgt * (warped[c] - vals[c]);
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

// K2 shadow_scatter: sun shadow -> shadow temporal blend -> scatter.
//
// Replaces stage 1, the shadow blend and the scatter of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 264-273 and 327-365, with dir_shadow.dir_shadow_slice,
// temporal._reproj_offsets/_tent_pass and scatter.scatter_slice inlined).
// The TPU grid carried the history in a VMEM ring and handed the blended
// shadow to the scatter in registers; here every froxel is independent, so
// one thread per froxel does the whole chain and the blended shadow never
// leaves registers on its way to the scatter.
//
// Per froxel (z, y, x):
//   1. world position at the jittered froxel centre; for each sun an
//      any-hit ray towards it, visibility^2 gated by has_shadow;
//   2. weight-mode blend against the previous shadow history: the
//      separable tent warp as an 8-tap gather (common.cuh warp8), weight
//      alpha * (global-uvw success), offsets with jitter and eps = 1e-4;
//   3. material at the jittered position with the fBm factor upsampled from
//      the low-rate bake, the local radiance upsampled and times sigma_s,
//      each sun's colour x blended shadow x HG at the UNJITTERED centre, and
//      ext = luma(sigma_s) + sigma_a times the sun count.
// Writes the new shadow history [Nd, D, H, W] and the scatter planes
// [4, D, H, W] (L_r, L_g, L_b, ext); histories are never updated in place.
//
// Bound on the H100: operations. Bytes: read the previous shadow (16.6 MB)
// and write shadow + scatter (83 MB) at FULL -- ~30 us at 3.35 TB/s. Work:
// per froxel one 7-primitive shadow ray, 7 reprojection evaluations (each a
// log, 2 divides) and ~30 gathered low-volume taps, ~800 flops, so
// ~3.5 GFLOP, ~0.05 ms at the fp32 peak. The 8-tap warp recomputes the
// analytic offsets at the neighbour columns instead of staging an offset
// volume, trading flops for bytes.
#include "common.cuh"

__global__ void shadow_scatter_kernel(VrTables T,
                                      const float* __restrict__ prev_sh,
                                      const float* __restrict__ bake,
                                      float* __restrict__ out_sh,
                                      float* __restrict__ out_sc) {
  const int w = T.w, h = T.h, d = T.d;
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));
  const float* p = T.spar;

  // 1. dir_shadow_slice: jittered world position, one ray per sun
  const float vzj = view_z(p, (float)z + 0.5f + p[19], d);
  const float ys = clampf((float)y + p[23], 0.0f, (float)T.h_glob - 1.0f);
  float wx, wy, wz;
  froxel_world(p, (float)x + 0.5f + p[17], ys + 0.5f + p[18], vzj, w,
               T.h_glob, wx, wy, wz);
  float cur[VR_MAX_DIR];
  for (int li = 0; li < T.n_dir; ++li) {
    const float* q = T.slights + 8 * li;
    const float strength_r = q[3], gate = q[4];
    const bool occ = any_hit(T, wx, wy, wz, -q[0], -q[1], -q[2], 1e4f);
    float vis = strength_r + (1.0f - strength_r) * (1.0f - (occ ? 1.f : 0.f));
    vis = vis * vis;
    cur[li] = 1.0f + gate * (vis - 1.0f);
  }

  // 2. shadow blend (weight mode)
  const float* sb = T.sbpar;
  const float vzc = view_z(sb, (float)z + 0.5f, d);
  const Reproj r0 = reproj_offsets(sb, z, y, x, vzc, w, h, d, T.h_glob, T.k,
                                   true);
  const float swgt = sb[20] * r0.success;
  float blended[VR_MAX_DIR];
  for (int li = 0; li < T.n_dir; ++li) {
    float warped;
    warp8<1>(sb, prev_sh + li * n, n, z, y, x, vzc, w, h, d, T.h_glob, T.k,
             true, r0, &warped);
    blended[li] = cur[li] + swgt * (warped - cur[li]);
    out_sh[li * n + i] = blended[li];
  }

  // 3. scatter_slice (radiance mode, material fused, dir lights folded)
  const long lplane = (long)T.dl * T.hl * T.wl;
  float noise[VR_MAX_NOISE];
  for (int c = 0; c < T.n_noise; ++c)
    noise[c] = upsample_low(T, bake + (3 + c) * lplane, z, y, x);
  float sr, sg, sbl, s_a, phg;
  material(T, wx, wy, wz, T.n_noise ? noise : nullptr, sr, sg, sbl, s_a,
           phg);
  const float ext = (0.3f * sr + 0.59f * sg + 0.11f * sbl + s_a)
                    * (float)T.n_dir;
  const float g2 = phg * phg;
  const float hg_num = (1.0f - g2) / (float)(4.0 * VR_PI);
  float ar = upsample_low(T, bake, z, y, x) * sr;
  float ag = upsample_low(T, bake + lplane, z, y, x) * sg;
  float ab = upsample_low(T, bake + 2 * lplane, z, y, x) * sbl;
  if (T.n_dir) {
    float cwx = wx, cwy = wy, cwz = wz;
    if (!T.jitter_dir) {
      const float vzu = view_z(p, (float)z + 0.5f, d);
      froxel_world(p, (float)x + 0.5f, ys + 0.5f, vzu, w, T.h_glob, cwx,
                   cwy, cwz);
    }
    float dvx = cwx - p[20], dvy = cwy - p[21], dvz = cwz - p[22];
    const float inv = rsqrt_exact(dvx * dvx + dvy * dvy + dvz * dvz + 1e-18f);
    dvx = dvx * inv;
    dvy = dvy * inv;
    dvz = dvz * inv;
    for (int li = 0; li < T.n_dir; ++li) {
      const float* q = T.dirs + 8 * li;
      const float cos_t = -(dvx * q[0] + dvy * q[1] + dvz * q[2]);
      const float b = 1.0f + g2 - 2.0f * phg * cos_t;
      const float rb = rsqrt_exact(b);
      const float hg = hg_num * rb * rb * rb;
      const float base = blended[li] * hg;
      ar = ar + base * q[3] * sr;
      ag = ag + base * q[4] * sg;
      ab = ab + base * q[5] * sbl;
    }
  }
  out_sc[i] = ar;
  out_sc[n + i] = ag;
  out_sc[2 * n + i] = ab;
  out_sc[3 * n + i] = ext;
}

extern "C" int vr_shadow_scatter(const VrTables* T, const float* prev_sh,
                                 const float* bake, float* out_sh,
                                 float* out_sc, cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  shadow_scatter_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                          stream>>>(*T, prev_sh, bake, out_sh, out_sc);
  return (int)cudaGetLastError();
}

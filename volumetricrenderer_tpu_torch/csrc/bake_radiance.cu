// K1 bake_radiance: the low-rate local-light radiance + fBm bake.
//
// Replaces stage 0 of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 179-262: the inline radiance bake with INLINE_VIS), which baked low slices
// into a VMEM ring just ahead of the scatter that reads them; and the
// standalone TPU kernel that bakes the same volume for the staged frame
// (volumetricrenderer_tpu/ops/pallas/visibility.py `_radiance_kernel` /
// `bake_radiance_pallas`). Here the whole
// low volume [3 + n_noise, DL, HL, WL] is baked up front into device memory
// (65,280 samples at FULL, ss=4: 1 MB), before shadow_scatter reads it.
//
// One thread per low sample. Per sample: the jittered world position
// (visibility.bake_world_planes), the camera direction, phase g, then for
// every local light that low_slice_active keeps for this low slice the
// light factor (falloff x cone x HG) and an any-hit shadow ray, summed in
// light order; then one fBm factor per noise-bearing medium. The shadow
// ray is common.cuh any_hit: with heightfield_local_shadows it also marches
// the terrain (hf_steps fBm samples over the band it crosses), and with
// fractional boxes it returns an occlusion amount, not 0 or 1.
//
// Bound on the H100: operations. The bytes are tiny (1 MB out); each
// sample runs up to 16 lights x 7 primitive tests plus 3 Perlin octaves,
// ~2-4k flops, so ~0.2 GFLOP in all -- a few microseconds at the fp32 rate,
// and in practice bound by the launch and the divergent light loop (the
// culling differs between slices, not within one, so a warp stays uniform
// along z). The design keeps all tables in device memory read through the
// read-only cache and loops over lights at run time (no per-scene build).
#include "common.cuh"

template <bool ARMS>
__global__ void bake_radiance_kernel(VrTables T, float* __restrict__ out) {
  const int n = T.dl * T.hl * T.wl;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = i % T.wl;
  const int r = (i / T.wl) % T.hl;
  const int m = i / (T.wl * T.hl);
  const float* p = T.spar;
  float wx, wy, wz;
  low_sample_world(T, m, r, c, wx, wy, wz);

  // visibility.radiance_view_dirs
  float vdx = wx - p[20], vdy = wy - p[21], vdz = wz - p[22];
  const float inv = rsqrt_exact(vdx * vdx + vdy * vdy + vdz * vdz + 1e-18f);
  vdx = vdx * inv;
  vdy = vdy * inv;
  vdz = vdz * inv;

  const float phg = phase_g(T, wx, wy, wz);
  const float g2 = phg * phg;
  const float hg_num = (1.0f - g2) / (float)(4.0 * VR_PI);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int li = 0; li < T.n_lights; ++li) {
    if (!T.active[li * T.dl + m]) continue;
    const float* q = T.lights + 16 * li;
    float ldx, ldy, ldz, dist;
    const float factor = light_factor(q, wx, wy, wz, vdx, vdy, vdz, phg, g2,
                                      hg_num, ldx, ldy, ldz, dist);
    const float occ = any_hit<ARMS>(T, wx, wy, wz, -ldx, -ldy, -ldz,
                                    dist - 0.05f, T.hf_local);
    const float base = factor * (1.0f - occ * q[14]);
    acc_r = acc_r + base * q[3];
    acc_g = acc_g + base * q[4];
    acc_b = acc_b + base * q[5];
  }
  const long plane = (long)n;
  out[i] = acc_r;
  out[plane + i] = acc_g;
  out[2 * plane + i] = acc_b;

  // material.noise_factor_planes; out has no noise channels when the fBm
  // is not baked (n_noise = 0)
  int ni = 0;
  for (int mi = 0; mi < T.n_media && ni < T.n_noise; ++mi) {
    if (!T.med_static[6 * mi]) continue;
    out[(3 + ni) * plane + i] = noise_factor(T, mi, wx, wy, wz);
    ++ni;
  }
}

extern "C" int vr_bake_radiance(const VrTables* T, float* out,
                                cudaStream_t stream) {
  const int n = T->dl * T->hl * T->wl;
  const int block = 128;
  const unsigned grid = (n + block - 1) / block;
  if (needs_arms(*T))
    bake_radiance_kernel<true><<<grid, block, 0, stream>>>(*T, out);
  else
    bake_radiance_kernel<false><<<grid, block, 0, stream>>>(*T, out);
  return (int)cudaGetLastError();
}

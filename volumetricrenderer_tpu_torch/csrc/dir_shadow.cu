// K7 dir_shadow: the raycast sun shadow volume, no temporal blend.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/dir_shadow.py
// `_kernel` / `dir_shadow_pallas` (one z-slice per grid step). The frame
// runs it when temporal_blend_shadow is off; with the blend on,
// shadow_blend.cu computes the same value and blends it in the same pass.
//
// One thread per froxel (z, y, x): world position at the jittered froxel
// centre, then for each sun an any-hit ray towards it against the planes,
// spheres, boxes and the terrain, visibility^2 gated by has_shadow
// (common.cuh sun_shadow). Writes [Nd, D, H, W].
//
// Bound on the H100: operations against bytes about even. Bytes: one write
// of 16.6 MB at 240x135x128 and one sun, ~5 us at 3.35 TB/s. Work: ~150
// flops per froxel (the depth mapping's exp/log, a 7-primitive ray), ~0.6
// GFLOP, ~9 us at the fp32 rate. The primitive tables are a few hundred
// bytes read by every thread through the read-only cache; the any-hit loop
// exits early, and neighbouring froxels mostly hit the same primitive, so a
// warp stays nearly uniform.
//
// Every sun ray marches the procedural terrain where the scene has one
// (common.cuh heightfield_occluded: hf_steps fBm samples over the band
// [base, base + amp] the ray crosses, skipped where it crosses none or a
// primitive occludes first); that march, ~700 flops a sample at 2
// octaves, is then most of the work of the froxels near the ground.
#include "common.cuh"

template <bool ARMS>
__global__ void dir_shadow_kernel(VrTables T, float* __restrict__ out_sh) {
  const int w = T.w, h = T.h, d = T.d;
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));

  float wx, wy, wz;
  froxel_center_world(T, z, y, x, true, wx, wy, wz);
  for (int li = 0; li < T.n_dir; ++li)
    out_sh[li * n + i] = sun_shadow<ARMS>(T, li, wx, wy, wz);
}

extern "C" int vr_dir_shadow(const VrTables* T, float* out_sh,
                             cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  if (needs_arms(*T))
    dir_shadow_kernel<true><<<grid, block, 0, stream>>>(*T, out_sh);
  else
    dir_shadow_kernel<false><<<grid, block, 0, stream>>>(*T, out_sh);
  return (int)cudaGetLastError();
}

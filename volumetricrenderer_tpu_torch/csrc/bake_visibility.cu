// K9 bake_visibility: the low-rate per-light visibility bake.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/visibility.py
// `_bake_kernel` / `bake_visibility_pallas`, whose grid ran over (light,
// low slice) pairs and either baked one [HL, WL] plane or, for a pair that
// low_slice_active culls, wrote a plane of ones. Here one thread owns one
// (light, low sample): the jittered world position of the low sample
// (common.cuh low_sample_world, shared with the radiance bake's
// arithmetic), one any-hit ray to the light, and 1 - occluded x has_shadow
// (the occlusion an amount with fractional boxes; the terrain marched with
// heightfield_local_shadows).
// Culled pairs are written 1 without a ray: the scatter's range cull
// zeroes those froxels anyway. A warp covers 32 neighbours in x of one
// (light, slice) pair, so the cull never splits it.
//
// Writes [NL, DL, HL, WL] float32, light order of pack_lights; the scatter
// (scatter.cu, VR_LOCAL_BAKED) upsamples it per light.
//
// Bound on the H100: operations. The output is 4 MB at 16 lights and
// 60x34x32 low samples; each active (light, sample) pair costs a
// 7-primitive ray (~190 flops) and ~40 flops of set-up, ~0.2 GFLOP in all:
// a few microseconds by either bound, so the launch is what one sees.
#include "common.cuh"

template <bool ARMS>
__global__ void bake_visibility_kernel(VrTables T, float* __restrict__ out) {
  const int n_low = T.dl * T.hl * T.wl;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)T.n_lights * n_low) return;
  const int li = (int)(i / n_low);
  const int s = (int)(i % n_low);
  const int c = s % T.wl;
  const int r = (s / T.wl) % T.hl;
  const int m = s / (T.wl * T.hl);
  if (!T.active[li * T.dl + m]) {
    out[i] = 1.0f;
    return;
  }
  float wx, wy, wz;
  low_sample_world(T, m, r, c, wx, wy, wz);

  // visibility.bake_light_plane
  const float* q = T.lights + 16 * li;
  const float tx = wx - q[0], ty = wy - q[1], tz = wz - q[2];
  const float d2 = tx * tx + ty * ty + tz * tz;
  const float inv_d = rsqrt_exact(d2 + 1e-18f);
  const float dist = d2 * inv_d;
  const float occ = any_hit<ARMS>(T, wx, wy, wz, -tx * inv_d, -ty * inv_d,
                                  -tz * inv_d, dist - 0.05f, T.hf_local);
  out[i] = 1.0f - occ * q[14];
}

extern "C" int vr_bake_visibility(const VrTables* T, float* out,
                                  cudaStream_t stream) {
  const long n = (long)T->n_lights * T->dl * T->hl * T->wl;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  if (needs_arms(*T))
    bake_visibility_kernel<true><<<grid, block, 0, stream>>>(*T, out);
  else
    bake_visibility_kernel<false><<<grid, block, 0, stream>>>(*T, out);
  return (int)cudaGetLastError();
}

// K9 bake_visibility: the low-rate per-light visibility bake.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/visibility.py
// `_bake_kernel` / `bake_visibility_pallas`, whose grid ran over (light,
// low slice) pairs and either baked one [HL, WL] plane or, for a pair that
// low_slice_active culls, wrote a plane of ones; and the inline bake of
// the TPU megakernel (ops/pallas/frame_fused.py `_kernel`). Per (light, low
// sample): the jittered world position of the low sample (common.cuh
// low_sample_world, shared with the radiance bake's arithmetic), one
// any-hit ray to the light, and 1 - occluded x has_shadow (the occlusion an
// amount with fractional boxes; the terrain marched with
// heightfield_local_shadows). Culled pairs are written 1 without a ray: the
// scatter's range cull zeroes those froxels anyway. Pairs that the light's
// range culls are baked all the same: the output is the reference's
// whatever the light factor.
//
// Writes [NL, DL, HL, WL] float32, light order of pack_lights; the scatter
// (scatter.cu, VR_LOCAL_BAKED) upsamples it per light.
//
// A block of K9_WARPS warps owns a run of consecutive samples of one low
// slice (row-major, so a run of 32 is a warp's one coalesced store), its
// lights spread over the warps in `groups` light groups (as K1's,
// bake_radiance.cu: the least power of two that takes every light, at most
// K9_WARPS), each group's warps holding the run's samples (lane = sample):
//   1. the light group 0 warps compute each sample's world position into
//      shared memory, once for all the lights (a thread per (light,
//      sample) computed it once a light: its log, exp and divisions 16
//      times at 16 lights);
//   2. after a barrier light group g takes the lights g, g + groups, ... in
//      light order, one at a time: the cull, uniform per (light, slice),
//      keeps a warp's control flow uniform, and its store is 32
//      neighbouring samples of one light. The ray takes any_hit's EARLY
//      exits (K1's: the same answers).
// There is no cap on the light count. Every value is the thread-per-pair
// form's, from the same expressions, so the volume is bit for bit the
// same. Indices are 32-bit: the launcher refuses tables past common.cuh
// past_int_index (the wrapper first, ops/scatter.check_tile_indices).
//
// Bound on the H100: operations. The output is 4 MB at 16 lights and
// 60x34x32 low samples; each active (light, sample) pair costs a
// 7-primitive ray (~190 flops) and ~40 flops of set-up, ~0.2 GFLOP in all:
// a few microseconds by either bound.
#include "common.cuh"

// A block's warps and their launch bounds (blocks an SM). Mirrored by
// ops/visibility.k9_geometry.
#define K9_WARPS 4
#define K9_MIN_BLOCKS 8
#define K9_MIN_BLOCKS_ARMS 6

// The light groups of a launch: the least power of two that takes every
// light, at most K9_WARPS.
__host__ __device__ __forceinline__ int k9_groups(int n_lights) {
  int g = 1;
  while (g < n_lights && g < K9_WARPS) g *= 2;
  return g;
}

template <bool ARMS>
__global__ void __launch_bounds__(32 * K9_WARPS,
                                  ARMS ? K9_MIN_BLOCKS_ARMS : K9_MIN_BLOCKS)
bake_visibility_kernel(VrTables T, float* __restrict__ out, int groups,
                       int runs) {
  __shared__ float pos_s[3][32 * K9_WARPS];
  const int sw = K9_WARPS / groups;  // warps of a light group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / sw;           // this warp's light group
  const int wi = warp - g * sw;      // its place in the group
  const int s = wi * 32 + lane;      // its lane's sample in the block
  const int m = blockIdx.x / runs;  // low slice
  const int plane = T.hl * T.wl;
  // the group's warps one after the other: a block's run is 32 sw samples
  const int at = ((blockIdx.x - m * runs) * sw + wi) * 32 + lane;
  const int r = min(at, plane - 1) / T.wl, c = min(at, plane - 1) % T.wl;

  // 1. the samples' world positions (the slice's last one again past its
  // end)
  if (g == 0) {
    float wx, wy, wz;
    low_sample_world(T, m, r, c, wx, wy, wz);
    pos_s[0][s] = wx;
    pos_s[1][s] = wy;
    pos_s[2][s] = wz;
  }
  __syncthreads();
  if (at >= plane) return;
  const float wx = pos_s[0][s], wy = pos_s[1][s], wz = pos_s[2][s];
  const int n_low = T.dl * plane;
  const int i = m * plane + at;

  // 2. light group g's lights: visibility.bake_light_plane
  for (int li = g; li < T.n_lights; li += groups) {
    float res = 1.0f;
    if (T.active[li * T.dl + m]) {
      const float* q = T.lights + 16 * li;
      const float tx = wx - q[0], ty = wy - q[1], tz = wz - q[2];
      const float d2 = tx * tx + ty * ty + tz * tz;
      const float inv_d = rsqrt_exact(d2 + 1e-18f);
      const float dist = d2 * inv_d;
      const float occ = any_hit<ARMS, false, true>(
          T, wx, wy, wz, -tx * inv_d, -ty * inv_d, -tz * inv_d, dist - 0.05f,
          T.hf_local);
      res = 1.0f - occ * q[14];
    }
    out[li * n_low + i] = res;
  }
}

// The launch of the low grid (wl, hl, dl) with n_lights local lights into
// out[0..5]: blocks, threads a block, samples a block (a run of its low
// slice), light groups, runs a slice and static shared bytes.
extern "C" int vr_bake_visibility_geometry(int n_lights, int wl, int hl,
                                           int dl, int* out) {
  const int groups = k9_groups(n_lights);
  const int samples = 32 * (K9_WARPS / groups);
  const int runs = (wl * hl + samples - 1) / samples;
  out[0] = runs * dl;
  out[1] = 32 * K9_WARPS;
  out[2] = samples;
  out[3] = groups;
  out[4] = runs;
  out[5] = 3 * 32 * K9_WARPS * (int)sizeof(float);
  return 0;
}

extern "C" int vr_bake_visibility(const VrTables* T, float* out,
                                  cudaStream_t stream) {
  if (past_int_index(*T)) return (int)cudaErrorInvalidValue;
  int geo[6];
  vr_bake_visibility_geometry(T->n_lights, T->wl, T->hl, T->dl, geo);
  if (needs_arms(*T))
    bake_visibility_kernel<true><<<geo[0], geo[1], 0, stream>>>(
        *T, out, geo[3], geo[4]);
  else
    bake_visibility_kernel<false><<<geo[0], geo[1], 0, stream>>>(
        *T, out, geo[3], geo[4]);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the two kernels, ARMS false then true: registers
// per thread, static shared bytes per block, local bytes per thread and
// largest block into out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)bake_visibility_kernel<ARMS>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_bake_visibility_attrs(int* out) {
  const cudaError_t errs[2] = {attrs_of<false>(out), attrs_of<true>(out + 4)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

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
// same.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/visibility.k9_form):
// the blocks are a 1-D grid, so the slice count never limits a launch. The
// narrow form indexes the [NL, DL, HL, WL] volume, the cull table [NL, DL]
// and the lights table in 32 bits (k9_narrow_fits: each under 2^31
// floats); past that the wide form, the same kernel with the volume's and
// the cull table's indices in 64 bits (I = int64_t), gives the same values
// bit for bit. Either refuses a launch of more than 2^31 - 1 blocks, a low
// slice of 2^31 samples or more, and a lights table past 2^31 floats.
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

template <bool ARMS, class I = int>
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
  const I n_low = (I)T.dl * plane;
  const I i = (I)m * plane + at;

  // 2. light group g's lights: visibility.bake_light_plane
  for (int li = g; li < T.n_lights; li += groups) {
    float res = 1.0f;
    if (T.active[(I)li * T.dl + m]) {
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

// Launches of the narrow (0) and wide (1) forms since the library was
// loaded (vr_bake_visibility_index_forms).
static long g_index_forms[2];

// Whether the wide form takes the table (mirrored by
// ops/visibility.k9_form): at most 2^31 - 1 blocks, the runs of a low slice
// under 2^31 samples (a sample's place in its slice is an int) and the
// lights table under 2^31 floats.
static bool k9_wide_fits(const VrTables& T) {
  const long samples = 32 * (K9_WARPS / k9_groups(T.n_lights));
  const long runs = ((long)T.wl * T.hl + samples - 1) / samples;
  return !past_int(runs, T.dl) && !past_int(runs, samples)
         && !past_int(T.n_lights, 16);
}

// Whether the narrow form takes it: also the [NL, DL, HL, WL] volume (and
// with it the cull table [NL, DL]) under 2^31 floats.
static bool k9_narrow_fits(const VrTables& T) {
  return k9_wide_fits(T)
         && !past_int(T.n_lights, (long)T.wl * T.hl * T.dl);
}

static int k9_form(const VrTables& T) {
  if (k9_narrow_fits(T)) return VR_FORM_NARROW;
  return k9_wide_fits(T) ? VR_FORM_WIDE : -1;
}

template <bool ARMS, class I>
static void launch_form(const VrTables* T, float* out, const int* geo,
                        cudaStream_t stream) {
  bake_visibility_kernel<ARMS, I><<<geo[0], geo[1], 0, stream>>>(
      *T, out, geo[3], geo[4]);
}

// form: VR_FORM_RULE (the size rule's, k9_form), or the narrow or the wide
// form, refused where it does not take the table.
extern "C" int vr_bake_visibility_form(const VrTables* T, float* out,
                                       int form, cudaStream_t stream) {
  if (form == VR_FORM_RULE) form = k9_form(*T);
  const bool fits = form == VR_FORM_NARROW ? k9_narrow_fits(*T)
                    : form == VR_FORM_WIDE ? k9_wide_fits(*T)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  int geo[6];
  vr_bake_visibility_geometry(T->n_lights, T->wl, T->hl, T->dl, geo);
  const bool arms = needs_arms(*T);
  if (form == VR_FORM_WIDE)
    arms ? launch_form<true, int64_t>(T, out, geo, stream)
         : launch_form<false, int64_t>(T, out, geo, stream);
  else
    arms ? launch_form<true, int>(T, out, geo, stream)
         : launch_form<false, int>(T, out, geo, stream);
  ++g_index_forms[form];
  return (int)cudaGetLastError();
}

// The size rule's form for the table into out[0] (-1: past the wide form
// too).
extern "C" int vr_bake_visibility_form_of(const VrTables* T, int* out) {
  out[0] = k9_form(*T);
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_bake_visibility_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// cudaFuncGetAttributes of the four kernels, the narrow form's ARMS false
// then true, then the wide form's: registers per thread, static shared
// bytes per block, local bytes per thread and largest block into
// out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS, class I = int>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)bake_visibility_kernel<ARMS, I>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_bake_visibility_attrs(int* out) {
  const cudaError_t errs[4] = {attrs_of<false>(out), attrs_of<true>(out + 4),
                               attrs_of<false, int64_t>(out + 8),
                               attrs_of<true, int64_t>(out + 12)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

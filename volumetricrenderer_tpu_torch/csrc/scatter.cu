// K6 scatter: the per-froxel in-scatter of every light.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/scatter.py
// `_kernel` / `scatter_local_pallas` in its modes. The local lights come
// from one of three sources:
//   radiance   they were baked at the low rate (bake_radiance.cu): three
//              tent upsamples x sigma_s, plus the baked fBm channels;
//   ray        no bake: a loop over the slice's light schedule
//              (slice_light_order) with light_factor and one any-hit shadow
//              ray per froxel and light;
//   baked      the same loop, the shadow term read from the low-rate
//              per-light visibility volume (bake_visibility.cu): z-lerp,
//              x tent, y tent at the light's channel;
// and the material from one of two:
//   fused      the media table evaluated per froxel (in the two loops with
//              its fBm); the extinction plane comes out as a 4th plane;
//   planes     sigma_s rgb and phase g read from material volumes; three
//              planes out, the caller adds the extinction.
//
// The TPU kernel took one z-slice per grid step with the tables in SMEM and
// a fori_loop over the slice's lights, whole [H, W] planes at a time, and
// upsampled a light's visibility plane with two small matmuls. Here one
// thread owns one froxel and runs common.cuh scatter_froxel, the same
// function shadow_scatter.cu calls with the blended shadow in registers;
// this kernel reads the blended shadow volume [Nd, D, H, W] from memory
// instead. The source and the material are template parameters, so each of
// the six kernels carries only its own branch; the ray loop has a seventh
// and eighth form with the any-hit's terrain and fractional arms
// (common.cuh any_hit<ARMS>), launched only for a scene that has them. The
// sun term is unjittered unless jitter_dir. The per-light sum adds the
// slice's active lights in ascending index, as the TPU loop does; the
// schedule is per slice, so a warp (32 neighbours in x) runs one loop
// length and diverges only inside any_hit's early exits.
//
// The per-light rays march the terrain under heightfield_local_shadows and
// carry occlusion amounts with fractional boxes (common.cuh any_hit).
//
// Writes the scatter planes [4, D, H, W] (r, g, b, ext), or [3, D, H, W]
// with material volumes.
//
// Bound on the H100: operations in the fused modes, bytes with material
// volumes. Bytes: read the shadow (16.6 MB at 240x135x128, one sun), the
// low volume (1 MB radiance, 4 MB visibility for 16 lights) and, in planes
// mode, four material planes (66 MB); write 66 or 50 MB: ~25 us fused,
// ~40 us planes at 3.35 TB/s. Work, radiance mode: ~30 gathered low-volume
// taps and the material per froxel, ~300 flops, ~1.2 GFLOP, ~20 us at the
// fp32 rate. The loops: per froxel and active light ~60 flops of
// light_factor and a 7-primitive ray or 8 gathered taps, plus (fused) three
// Perlin octaves per noise medium (~1000 flops): several GFLOP.
#include "common.cuh"

template <int LOCAL, bool MAT_PLANES, bool ARMS>
__global__ void scatter_kernel(VrTables T, const float* __restrict__ shadow,
                               const float* __restrict__ low,
                               const float* __restrict__ mat_a,
                               const float* __restrict__ mat_b,
                               float* __restrict__ out_sc) {
  const int w = T.w, h = T.h, d = T.d;
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));

  float wx, wy, wz;
  froxel_center_world(T, z, y, x, true, wx, wy, wz);
  float blended[VR_MAX_DIR];
  for (int li = 0; li < T.n_dir; ++li)
    blended[li] = __ldg(shadow + li * n + i);
  float sc[4];
  scatter_froxel<LOCAL, MAT_PLANES, ARMS>(T, low, z, y, x, wx, wy, wz,
                                          blended, sc, mat_a, mat_b);
#pragma unroll
  for (int c = 0; c < (MAT_PLANES ? 3 : 4); ++c) out_sc[c * n + i] = sc[c];
}

template <int LOCAL, bool MAT_PLANES>
static void launch_scatter_kernel(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  // only the ray loop casts rays: the arms matter to it alone
  constexpr bool RAYS = LOCAL == VR_LOCAL_RAY;
  if (RAYS && needs_arms(*T))
    scatter_kernel<LOCAL, MAT_PLANES, RAYS><<<grid, block, 0, stream>>>(
        *T, shadow, low, mat_a, mat_b, out_sc);
  else
    scatter_kernel<LOCAL, MAT_PLANES, false><<<grid, block, 0, stream>>>(
        *T, shadow, low, mat_a, mat_b, out_sc);
}

template <int LOCAL>
static void launch_scatter(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  if (mat_a)
    launch_scatter_kernel<LOCAL, true>(T, shadow, low, mat_a, mat_b, out_sc,
                                       stream);
  else
    launch_scatter_kernel<LOCAL, false>(T, shadow, low, mat_a, mat_b,
                                        out_sc, stream);
}

// local: VR_LOCAL_*; low: the radiance or visibility volume (null for
// VR_LOCAL_RAY); mat_a null selects the fused material.
extern "C" int vr_scatter(const VrTables* T, const float* shadow,
                          const float* low, const float* mat_a,
                          const float* mat_b, float* out_sc, int local,
                          cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || (!mat_a != !mat_b))
    return (int)cudaErrorInvalidValue;
  switch (local) {
    case VR_LOCAL_RADIANCE:
      launch_scatter<VR_LOCAL_RADIANCE>(T, shadow, low, mat_a, mat_b, out_sc,
                                        stream);
      break;
    case VR_LOCAL_RAY:
      launch_scatter<VR_LOCAL_RAY>(T, shadow, low, mat_a, mat_b, out_sc,
                                   stream);
      break;
    case VR_LOCAL_BAKED:
      launch_scatter<VR_LOCAL_BAKED>(T, shadow, low, mat_a, mat_b, out_sc,
                                     stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

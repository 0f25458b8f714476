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
//   3. material at the jittered position, the local lights from one of the
//      megakernel's three sources (the LOCAL template parameter):
//        radiance  the low-rate radiance bake (bake_radiance.cu) upsampled
//                  and times sigma_s, the fBm factor upsampled from its
//                  noise channels (the inline radiance bake, ss > 1);
//        ray       the slice's light schedule, one any-hit shadow ray per
//                  froxel and light (the per-light branch, ss = 1);
//        baked     the same loop, the shadow term upsampled from the
//                  low-rate per-light visibility (bake_visibility.cu: the
//                  inline visibility bake, frame_fused.py:482-527);
//      then each sun's colour x blended shadow x HG at the UNJITTERED
//      centre, and ext = luma(sigma_s) + sigma_a times the sun count.
// Writes the new shadow history [Nd, D, H, W] and the scatter planes
// [4, D, H, W] (L_r, L_g, L_b, ext); histories are never updated in place.
//
// The three steps are the shared device functions of common.cuh
// (sun_shadow, shadow_blend_froxel, scatter_froxel), which the staged
// frame's kernels (shadow_blend.cu, scatter.cu) call one at a time: the
// fused frames equal the staged ones bit for bit.
//
// Bound on the H100: operations. Bytes: read the previous shadow (16.6 MB)
// and write shadow + scatter (83 MB) at FULL -- ~30 us at 3.35 TB/s. Work,
// radiance source: per froxel one 7-primitive shadow ray, 7 reprojection
// evaluations (each a log, 2 divides) and ~30 gathered low-volume taps,
// ~800 flops, ~0.035 ms at the fp32 peak. The two loops add, per scheduled
// (froxel, light) pair, ~60 flops of light_factor and a 7-primitive ray
// (ray) or 8 gathered taps (baked), and per froxel the Perlin fBm of the
// media (no baked noise channel): the bound of K5 plus that of K6 in the
// same mode. The 8-tap warp recomputes the analytic offsets at the
// neighbour columns instead of staging an offset volume, trading flops for
// bytes. On a scene with the procedural terrain the sun rays march it
// (dir_shadow.cu), and the local rays too with heightfield_local_shadows;
// fractional boxes make every shadow term an occlusion amount. Both arms
// live in the kernel's ARMS instantiation (common.cuh any_hit), launched
// only for a scene that has them, so a scene without them keeps its
// registers and its time.
#include "common.cuh"

template <int LOCAL, bool ARMS>
__global__ void shadow_scatter_kernel(VrTables T,
                                      const float* __restrict__ prev_sh,
                                      const float* __restrict__ low,
                                      float* __restrict__ out_sh,
                                      float* __restrict__ out_sc) {
  const int w = T.w, h = T.h, d = T.d;
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));

  // 1. dir_shadow_slice: jittered world position, one ray per sun
  float wx, wy, wz;
  froxel_center_world(T, z, y, x, true, wx, wy, wz);
  float cur[VR_MAX_DIR];
  for (int li = 0; li < T.n_dir; ++li)
    cur[li] = sun_shadow<ARMS>(T, li, wx, wy, wz);

  // 2. shadow blend (weight mode)
  float blended[VR_MAX_DIR];
  shadow_blend_froxel(T, prev_sh, n, z, y, x, cur, blended);
  for (int li = 0; li < T.n_dir; ++li) out_sh[li * n + i] = blended[li];

  // 3. scatter_slice (material fused, dir lights folded)
  float sc[4];
  scatter_froxel<LOCAL, false, ARMS>(T, low, z, y, x, wx, wy, wz, blended,
                                     sc);
#pragma unroll
  for (int c = 0; c < 4; ++c) out_sc[c * n + i] = sc[c];
}

template <int LOCAL>
static void launch_shadow_scatter(const VrTables* T, const float* prev_sh,
                                  const float* low, float* out_sh,
                                  float* out_sc, cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  if (needs_arms(*T))
    shadow_scatter_kernel<LOCAL, true><<<grid, block, 0, stream>>>(
        *T, prev_sh, low, out_sh, out_sc);
  else
    shadow_scatter_kernel<LOCAL, false><<<grid, block, 0, stream>>>(
        *T, prev_sh, low, out_sh, out_sc);
}

// local: VR_LOCAL_*; low: the radiance (+ fBm) volume [3 + n_noise, DL,
// HL, WL], the visibility volume [NL, DL, HL, WL], or null for
// VR_LOCAL_RAY.
extern "C" int vr_shadow_scatter(const VrTables* T, const float* prev_sh,
                                 const float* low, float* out_sh,
                                 float* out_sc, int local,
                                 cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (local) {
    case VR_LOCAL_RADIANCE:
      launch_shadow_scatter<VR_LOCAL_RADIANCE>(T, prev_sh, low, out_sh,
                                               out_sc, stream);
      break;
    case VR_LOCAL_RAY:
      launch_shadow_scatter<VR_LOCAL_RAY>(T, prev_sh, low, out_sh, out_sc,
                                          stream);
      break;
    case VR_LOCAL_BAKED:
      launch_shadow_scatter<VR_LOCAL_BAKED>(T, prev_sh, low, out_sh, out_sc,
                                            stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

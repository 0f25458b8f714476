// K5 shadow_blend: raycast sun shadow + shadow temporal blend in one pass.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/shadow_blend.py
// `_kernel` / `dir_shadow_blend_fused`, which walked z sequentially with the
// current shadow slices in a (k+2)-deep and the history in a (2k+2)-deep
// VMEM ring so that the un-blended volume never reached HBM. On the GPU
// every froxel is independent: one thread per froxel casts the sun rays,
// reprojects, gathers its 8 history taps (common.cuh warp8, the three tent
// passes collapsed) and blends, so the un-blended value never leaves
// registers. This is the first two steps of shadow_scatter.cu with the
// blended value stored instead of handed on to the scatter.
//
// Per froxel (z, y, x):
//   1. world position at the jittered froxel centre; for each sun an
//      any-hit ray towards it, visibility^2 gated by has_shadow;
//   2. weight-mode blend against the previous shadow history: weight
//      alpha * (global-uvw success), offsets with jitter and eps = 1e-4.
// Writes a new buffer [Nd, D, H, W]: the warp reads neighbours of the
// history, so it cannot be updated in place.
//
// Bound on the H100: operations, barely. Bytes: read the history and write
// the new one, 2 x 16.6 MB at 240x135x128 and one sun, ~10 us at 3.35 TB/s.
// Work: per froxel one 7-primitive shadow ray and the reprojection, ~300
// flops, ~1.2 GFLOP, ~20 us at the fp32 rate. The warp recomputes the
// analytic offsets at the 6 neighbour columns instead of staging an offset
// volume, which trades flops (each a log and two divides) for bytes.
// Every sun ray marches the terrain where the scene has one, as in
// dir_shadow.cu.
#include "common.cuh"

template <bool ARMS>
__global__ void shadow_blend_kernel(VrTables T,
                                    const float* __restrict__ prev_sh,
                                    float* __restrict__ out_sh) {
  const int w = T.w, h = T.h, d = T.d;
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));

  float wx, wy, wz;
  froxel_center_world(T, z, y, x, true, wx, wy, wz);
  float cur[VR_MAX_DIR];
  for (int li = 0; li < T.n_dir; ++li)
    cur[li] = sun_shadow<ARMS>(T, li, wx, wy, wz);
  float blended[VR_MAX_DIR];
  shadow_blend_froxel(T, prev_sh, n, z, y, x, cur, blended);
  for (int li = 0; li < T.n_dir; ++li) out_sh[li * n + i] = blended[li];
}

extern "C" int vr_shadow_blend(const VrTables* T, const float* prev_sh,
                               float* out_sh, cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  if (needs_arms(*T))
    shadow_blend_kernel<true><<<grid, block, 0, stream>>>(*T, prev_sh,
                                                          out_sh);
  else
    shadow_blend_kernel<false><<<grid, block, 0, stream>>>(*T, prev_sh,
                                                           out_sh);
  return (int)cudaGetLastError();
}

// K6 scatter: the per-froxel in-scatter of every light, material evaluated
// in the kernel.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/scatter.py
// `_kernel` / `scatter_local_pallas` in two of its modes, both with the
// fused material (media table in, extinction plane out):
//   radiance   the local lights were baked at the low rate (bake_radiance.cu):
//              three tent upsamples x sigma_s, plus the baked fBm channels;
//   per-light  no bake: a loop over the slice's light schedule
//              (slice_light_order) with light_factor and one any-hit shadow
//              ray per froxel and light, and the fBm evaluated per froxel.
// The baked-visibility mode (per-light loop reading a low-rate visibility
// volume) and the mode that reads material volumes are not here.
//
// The TPU kernel took one z-slice per grid step with the tables in SMEM and
// a fori_loop over the slice's lights, whole [H, W] planes at a time. Here
// one thread owns one froxel and runs common.cuh scatter_froxel, the same
// function shadow_scatter.cu calls with the blended shadow in registers;
// this kernel reads the blended shadow volume [Nd, D, H, W] from memory
// instead. The sun term is unjittered unless jitter_dir. The per-light sum
// adds the slice's active lights in ascending index, as the TPU loop does;
// the schedule is per slice, so a warp (32 neighbours in x) runs one loop
// length and diverges only inside any_hit's early exits.
//
// Writes the scatter planes [4, D, H, W] (r, g, b, ext).
//
// Bound on the H100: operations in both modes. Bytes: read the shadow
// (16.6 MB at 240x135x128, one sun) and, in radiance mode, the 1 MB low
// volume; write 66 MB: ~25 us at 3.35 TB/s. Work, radiance mode: ~30
// gathered low-volume taps and the material per froxel, ~300 flops, ~1.2
// GFLOP, ~20 us at the fp32 rate, so the two bounds are close. Per-light
// mode: per froxel and active light ~60 flops of light_factor and a
// 7-primitive ray, plus three Perlin octaves per noise medium (~1000
// flops): several GFLOP, well past the bytes.
#include "common.cuh"

template <bool PER_LIGHT>
__global__ void scatter_kernel(VrTables T, const float* __restrict__ shadow,
                               const float* __restrict__ bake,
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
  scatter_froxel<PER_LIGHT>(T, bake, z, y, x, wx, wy, wz, blended, sc);
#pragma unroll
  for (int c = 0; c < 4; ++c) out_sc[c * n + i] = sc[c];
}

// bake null selects the per-light mode.
extern "C" int vr_scatter(const VrTables* T, const float* shadow,
                          const float* bake, float* out_sc,
                          cudaStream_t stream) {
  const long n = (long)T->d * T->h * T->w;
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  if (bake)
    scatter_kernel<false><<<grid, block, 0, stream>>>(*T, shadow, bake,
                                                      out_sc);
  else
    scatter_kernel<true><<<grid, block, 0, stream>>>(*T, shadow, bake,
                                                     out_sc);
  return (int)cudaGetLastError();
}

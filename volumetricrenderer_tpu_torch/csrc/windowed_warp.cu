// K11 windowed_warp: the separable windowed tent resample at arbitrary
// target volumes.
//
// Replaces the TPU kernels volumetricrenderer_tpu/ops/pallas/warp.py
// `_pass_kernel` / `_run_pass` / `windowed_warp_pallas`: three pass kernels
// (z, y, x), each reading its target volume and the previous pass's output
// and keeping its 2k+1 shifted taps in VMEM, with two intermediate volumes
// in HBM between them. A pass weights its taps by the offset of its target
// AT ITS OWN OUTPUT POINT, clipped to +-k, so output (z, y, x) is
//
//   sum_dx wx(offx[z,y,x]) sum_dy wy(offy[z,y,cx]) sum_dz wz(offz[z,cy,cx])
//       vol[cz, cy, cx]
//
// with clamped neighbours, and of each pass's 2k+1 taps only the two around
// its offset have a non-zero tent weight. On the GPU that is one gather:
// one thread per output froxel reads tx at its own point, ty at the 2
// columns the x pass reads, tz at the 4 (row, column) pairs the y passes
// read, and 8 taps per channel, summed in the passes' ascending tap order
// so the float sums match three sequential passes. No intermediate volume
// exists. The targets are arbitrary coordinate volumes (the reprojection
// through world space, pipeline.reproject_texel), not the analytic offsets
// of temporal_blend.cu.
//
// vol and out are [C, D, H, W], the targets [D, H, W] texel coordinates;
// targets are clipped to the volume, offsets to +-k, taps edge-clamped.
//
// Bound on the H100: bytes. Read C volume planes and 3 target planes, write
// C planes of 16.6 MB at 240x135x128: 11 planes, 0.054 ms at 3.35 TB/s for
// C = 4. Work: 7 offsets, 14 tent weights and 14 multiply-adds per channel,
// ~150 flops per froxel, ~10 us at the fp32 rate.
#include "common.cuh"

__device__ __forceinline__ float target_offset(const float* __restrict__ t,
                                               long idx, int n, int base,
                                               float kf) {
  const float v = clampf(__ldg(t + idx), 0.0f, (float)n - 1.0f);
  return clampf(v - (float)base, -kf, kf);
}

__global__ void windowed_warp_kernel(const float* __restrict__ vol,
                                     const float* __restrict__ tx,
                                     const float* __restrict__ ty,
                                     const float* __restrict__ tz,
                                     float* __restrict__ out, int nc, int d,
                                     int h, int w, int k) {
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));
  const float kf = (float)k;

  // the 8 taps and their pass weights: [a] x pass, [a][b] y, [a][b][e] z
  long idx[8];
  float wxa[2], wyb[4], wze[8];
  const float ox = target_offset(tx, i, w, x, kf);
  const int x0 = (int)floorf(ox);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    wxa[a] = tent_w(ox, x0 + a);
    const int cx = clampi(x + x0 + a, 0, w - 1);
    const float oy = target_offset(ty, ((long)z * h + y) * w + cx, h, y, kf);
    const int y0 = (int)floorf(oy);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wyb[2 * a + b] = tent_w(oy, y0 + b);
      const int cy = clampi(y + y0 + b, 0, h - 1);
      const float oz = target_offset(tz, ((long)z * h + cy) * w + cx, d, z,
                                     kf);
      const int z0 = (int)floorf(oz);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        wze[4 * a + 2 * b + e] = tent_w(oz, z0 + e);
        const int cz = clampi(z + z0 + e, 0, d - 1);
        idx[4 * a + 2 * b + e] = ((long)cz * h + cy) * w + cx;
      }
    }
  }
  for (int c = 0; c < nc; ++c) {
    const float* src = vol + c * n;
    float accx = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float accy = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float accz = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 4 * a + 2 * b + e;
          accz = accz + __ldg(src + idx[t]) * wze[t];
        }
        accy = accy + accz * wyb[2 * a + b];
      }
      accx = accx + accy * wxa[a];
    }
    out[c * n + i] = accx;
  }
}

extern "C" int vr_windowed_warp(const float* vol, const float* tx,
                                const float* ty, const float* tz, float* out,
                                int nc, int d, int h, int w, int k,
                                cudaStream_t stream) {
  if (nc < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)d * h * w;
  const int block = 128;
  windowed_warp_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                         stream>>>(vol, tx, ty, tz, out, nc, d, h, w, k);
  return (int)cudaGetLastError();
}

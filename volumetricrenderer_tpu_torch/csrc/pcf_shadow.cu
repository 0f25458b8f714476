// K12 pcf_shadow: the cascaded-PCF sun shadow volume of the shadow-map
// modes, for one sun.
//
// Replaces volumetricrenderer_tpu/ops/pallas/pcf_shadow.py `_kernel` /
// `pcf_dir_shadow_pallas` (:222, :355). The TPU kernel ran one z slice per
// grid step and, because Mosaic gathers only along 128 lanes, fetched the
// four PCF taps in two passes (a column gather of a 512x512 atlas window,
// a transpose, a row gather) over a doubled-lane x layout. On the GPU each
// thread reads its taps straight from the atlas: no window, no transposes.
//
// One thread per froxel (z, y, x) of the grid it is given (full rate, or
// the low-rate grid of dir_shadow_subsample): the jittered world position
// (for the split-sphere select), then over the slice's count[z] active
// cascades in order[z] (ops/pcf_shadow.schedule):
//   u = a_u x + c_u, v = a_v x + b_v y + c_v, ref = a_r x + b_r y + c_r,
//   four taps at (floor(v) + dy, floor(u) + dx) clamped to the atlas,
//   lit = ref <= stored weighted bilinearly, and the one-hot mask (inside
//   cascade ci's sphere and not inside ci - 1's);
// then cmp + (1 - min(sum of masks, 1)) (fully lit outside every cascade),
// the lerp to the strength, the square, the has_shadow gate and, where the
// schedule flagged a window overflow, the NaN poison: the arithmetic of the
// TPU kernel and of the twin ops/pcf_shadow.pcf_shadow_plain, in their
// order (no FMA contraction), so that a compare flips only for a coordinate
// within ulps of a texel edge.
//
// Bound on the H100: bytes. At 240x135x128 froxels, low rate (120x135x64)
// with one sun: 4.1 MB of output and a 4.2 MB atlas read once, ~2.5 us at
// 3.35 TB/s; full rate ~6 us. The atlas stays in the 50 MB L2, and
// neighbouring threads read neighbouring texels; with ~1.5 active cascades
// per slice the work is ~100 flops per froxel. The kernel is launch-bound.
#include "common.cuh"

__device__ __forceinline__ float inside_sphere(const float* sph, int ci,
                                               float wx, float wy, float wz) {
  const float dx = wx - sph[ci * 4 + 0];
  const float dy = wy - sph[ci * 4 + 1];
  const float dz = wz - sph[ci * 4 + 2];
  return dx * dx + dy * dy + dz * dz < sph[ci * 4 + 3] ? 1.0f : 0.0f;
}

__global__ void pcf_shadow_kernel(const float* __restrict__ par,
                                  const float* __restrict__ coef,
                                  const int* __restrict__ order,
                                  const int* __restrict__ count,
                                  const float* __restrict__ sph,
                                  const float* __restrict__ atlas, int w,
                                  int h, int d, int h_glob, int s2, int nc,
                                  float* __restrict__ out) {
  const long n = (long)d * h * w;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % w);
  const int y = (int)((i / w) % h);
  const int z = (int)(i / ((long)w * h));

  const float fpx = par[0], fpy = par[1], fpz = par[2], fpw = par[3];
  const float near_ = par[4], jx = par[5], jy = par[6], jz = par[7];
  const float sr = par[20], y0 = par[21], gate = par[22];

  // jittered world position of the froxel
  const float fz = (float)z + 0.5f + jz;
  const float vz = (expf(logf(fpz) * fz / (float)d) - 1.0f) * fpw + near_;
  const float xs = (float)x;
  const float ys = clampf((float)y + y0, 0.0f, (float)h_glob - 1.0f);
  const float vx = (2.0f * (xs + 0.5f + jx) / (float)w - 1.0f) * vz / fpx;
  const float vy = (2.0f * (ys + 0.5f + jy) / (float)h_glob - 1.0f) * vz /
                   fpy;
  const float wx = par[8] * vx + par[9] * vy + par[10] * vz + par[11];
  const float wy = par[12] * vx + par[13] * vy + par[14] * vz + par[15];
  const float wz = par[16] * vx + par[17] * vy + par[18] * vz + par[19];

  float acc_cmp = 0.0f, acc_mask = 0.0f;
  const int n_act = count[z];
  for (int k = 0; k < n_act; ++k) {
    const int ci = order[z * nc + k];
    const float* q = coef + ((long)z * nc + ci) * 8;
    const float u = q[0] * xs + q[1];
    const float v = q[2] * xs + q[3] * ys + q[4];
    const float ref = q[5] * xs + q[6] * ys + q[7];
    const float u0 = floorf(u);
    const float v0 = floorf(v);
    const float fu = u - u0;
    const float fv = v - v0;
    const int gu0 = clampi((int)u0, 0, s2 - 1);
    const int gu1 = clampi((int)u0 + 1, 0, s2 - 1);
    const long r0 = (long)clampi((int)v0, 0, s2 - 1) * s2;
    const long r1 = (long)clampi((int)v0 + 1, 0, s2 - 1) * s2;
    const float le00 = ref <= __ldg(atlas + r0 + gu0) ? 1.0f : 0.0f;
    const float le01 = ref <= __ldg(atlas + r0 + gu1) ? 1.0f : 0.0f;
    const float le10 = ref <= __ldg(atlas + r1 + gu0) ? 1.0f : 0.0f;
    const float le11 = ref <= __ldg(atlas + r1 + gu1) ? 1.0f : 0.0f;
    const float cmp = (1.0f - fv) * ((1.0f - fu) * le00 + fu * le01) +
                      fv * ((1.0f - fu) * le10 + fu * le11);
    const float prev =
        ci > 0 ? inside_sphere(sph, ci - 1, wx, wy, wz) : 0.0f;
    const float mask = inside_sphere(sph, ci, wx, wy, wz) * (1.0f - prev);
    acc_cmp = acc_cmp + mask * cmp;
    acc_mask = acc_mask + mask;
  }
  const float cmp = acc_cmp + (1.0f - fminf(acc_mask, 1.0f));
  const float vis = sr + (1.0f - sr) * cmp;
  float res = 1.0f + gate * (vis * vis - 1.0f);
  if (par[23] > 0.0f) res = res + __int_as_float(0x7fc00000);  // NaN
  out[i] = res;
}

extern "C" int vr_pcf_shadow(const float* par, const float* coef,
                             const int* order, const int* count,
                             const float* sph, const float* atlas, int w,
                             int h, int d, int h_glob, int s2, int nc,
                             float* out, cudaStream_t stream) {
  const long n = (long)d * h * w;
  const int block = 128;
  pcf_shadow_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                      stream>>>(par, coef, order, count, sph, atlas, w, h, d,
                                h_glob, s2, nc, out);
  return (int)cudaGetLastError();
}

// K13 ssr_march: the quarter-res screen-space reflection march.
//
// Replaces volumetricrenderer_tpu/ops/pallas/ssr.py `_kernel` /
// `ssr_march_pallas` (:35, :100). The TPU kernel holds the eight input
// planes in VMEM as edge-padded copies (PAD >= the largest march radius,
// lanes aligned to 128) so that every tap is a static slice, and walks ALL
// direction bins over the whole plane, masking each bin's accumulators by
// sel = (bin == b) * valid. Both are layout devices. Here one thread owns one
// quarter-res pixel, reads its own bin and valid flag, and walks only its
// bin's taps, which are direct loads at (y + oy, x + ox) with the index
// clamped into the plane; the same onscreen mask as the TPU kernel zeroes a
// tap that leaves the screen (the clamped value never counts, as the pad's
// never did). Every other bin adds 0 * a finite value to the TPU kernel's
// sums, so this is the same function; with FMA contraction off and IEEE
// division (1 / max(invz, 1e-4) as `invz > 1e-4 ? 1 / invz : 1e9`) it
// equals the plain-torch twin (ops/ssr.ssr_march_reference) bit for bit.
//
// The taps come from a small table the wrapper uploads once per config:
// per bin, rows (t_prev, t, t / max_px, oy, ox) in float32, as the twin
// rounds them, and the bin's tap count.
//
// Bound on the H100: bytes. At 1080p with ssr_downsample=4 the planes are
// 270x480: 8 in, 5 out, 13 x 129,600 x 4 B = 6.7 MB, 2 us at 3.35 TB/s; the
// work, <= 12 taps x ~25 flops a pixel (~39 MFLOP), is below that. The
// taps of neighbouring pixels overlap, so the four planes a tap reads come
// from L1/L2; the kernel is launch- and latency-bound at this size.
#include <cuda_runtime.h>

__global__ void ssr_march_kernel(
    const float* __restrict__ dq, const float* __restrict__ cr,
    const float* __restrict__ cg, const float* __restrict__ cb,
    const float* __restrict__ invz0, const float* __restrict__ g,
    const float* __restrict__ bin_idx, const float* __restrict__ valid,
    const float* __restrict__ taps, const int* __restrict__ n_taps,
    int n_bins, int max_taps, int hq, int wq, float thickness,
    float* __restrict__ rr, float* __restrict__ rg, float* __restrict__ rb,
    float* __restrict__ hit_w, float* __restrict__ hit_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hq * wq) return;
  const int y = i / wq, x = i % wq;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, aw = 0.0f, at = 0.0f;
  const float bf = __ldg(bin_idx + i);
  const int b = (int)bf;
  // a pixel whose bin is no bin of the table takes no bin's sums
  if (bf >= 0.0f && b < n_bins && (float)b == bf) {
    const float z0 = __ldg(invz0 + i);
    const float gi = __ldg(g + i);
    float not_hit = 1.0f;
    const float* row = taps + (long)b * max_taps * 5;
    const int nt = __ldg(n_taps + b);
    for (int k = 0; k < nt; ++k) {
      const float t_prev = __ldg(row + 5 * k);
      const float t = __ldg(row + 5 * k + 1);
      const float tf = __ldg(row + 5 * k + 2);
      const int oy = (int)__ldg(row + 5 * k + 3);
      const int ox = (int)__ldg(row + 5 * k + 4);
      const int sy = y + oy, sx = x + ox;
      const float onscreen =
          (sy >= 0 && sy < hq && sx >= 0 && sx < wq) ? 1.0f : 0.0f;
      const int j = min(max(sy, 0), hq - 1) * wq + min(max(sx, 0), wq - 1);
      const float zs = __ldg(dq + j);
      const float invz = z0 + gi * t;
      const float z_ray = invz > 1e-4f ? 1.0f / invz : 1e9f;
      const float invz_p = z0 + gi * t_prev;
      const float z_prev = invz_p > 1e-4f ? 1.0f / invz_p : 1e9f;
      const float hit =
          ((z_ray >= zs) && (z_prev <= zs + thickness) ? 1.0f : 0.0f) *
          onscreen;
      const float wgt = not_hit * hit;
      acc_r = acc_r + wgt * __ldg(cr + j);
      acc_g = acc_g + wgt * __ldg(cg + j);
      acc_b = acc_b + wgt * __ldg(cb + j);
      aw = aw + wgt;
      at = at + wgt * tf;
      not_hit = not_hit * (1.0f - hit);
    }
  }
  // the twin's sum over bins: +0, then sel * this bin's sums, then the
  // other bins' +-0, which leave it as it is
  const float sel = valid[i];
  rr[i] = 0.0f + sel * acc_r;
  rg[i] = 0.0f + sel * acc_g;
  rb[i] = 0.0f + sel * acc_b;
  hit_w[i] = 0.0f + sel * aw;
  hit_t[i] = 0.0f + sel * at;
}

extern "C" int vr_ssr_march(const float* dq, const float* cr, const float* cg,
                            const float* cb, const float* invz0,
                            const float* g, const float* bin_idx,
                            const float* valid, const float* taps,
                            const int* n_taps, int n_bins, int max_taps,
                            int hq, int wq, float thickness, float* rr,
                            float* rg, float* rb, float* hit_w, float* hit_t,
                            cudaStream_t stream) {
  if (hq < 1 || wq < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const int n = hq * wq;
  const int block = 128;
  ssr_march_kernel<<<(n + block - 1) / block, block, 0, stream>>>(
      dq, cr, cg, cb, invz0, g, bin_idx, valid, taps, n_taps, n_bins,
      max_taps, hq, wq, thickness, rr, rg, rb, hit_w, hit_t);
  return (int)cudaGetLastError();
}

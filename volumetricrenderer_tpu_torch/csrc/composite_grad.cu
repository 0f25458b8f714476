// K14 composite_grad: the adjoint of K4's composite, image gradient ->
// accumulation gradient.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA
// composites (ops/tent_composite.py composite_tentmm, rowmm_composite.py
// composite_rowmm and composite_anyres) and jax.grad refuses its Pallas
// composites. It was added so that a training step (inverse.py) on the
// card runs K4 forward and a hand-written kernel backward: the torch
// autograd.Function around K4 (ops/zg_composite.py) launches it.
//
// K4 computes per pixel, with the z taps z0, z1 = min(z0 + 1, d - 1) and
// lerp weight f of the pixel's depth (composite_taps.cuh, the helper K4
// uses) and the xy taps and weights of the same host tables K4 reads
// (zg_composite.cell_taps in the cells form, pixel_taps in the per-pixel
// form):
//   v[c] = (1 - f) sum_t wt acc[c, z0, t] + f sum_t wt acc[c, z1, t]
//   rgb = scene * v[3] + v[0:3],  a = v[3].
// For the upstream gradient G = (g_r, g_g, g_b, g_a) at a pixel with scene
// colour S, the gradient of v is (g_r, g_g, g_b, g_T) with
// g_T = g_r S_r + g_g S_g + g_b S_b + g_a, and each tap t adds
// (g_v[c] (1 - f)) wt to grad_acc[c, z0, t] and (g_v[c] f) wt to
// grad_acc[c, z1, t] -- the products in autograd's order. At the far clamp
// z0 = z1 = d - 1 and both terms go to the same slice, which is the exact
// adjoint of the forward's two reads of that slice. A tap of zero weight is
// skipped, as K4 skips it. The scene's own gradient, g_rgb * T, needs no
// kernel: the wrapper takes it from the saved image's alpha (= T).
//
// One thread per pixel, its 2 x 4 x 4 = 32 adds into a zeroed [4, D, H, W]
// buffer by atomicAdd: neighbouring pixels share froxels (64 pixels a
// froxel column at 8x8 cells), so the adds contend, and their order -- and
// so the last bits of the sum -- changes from run to run. A deterministic
// gather form (each froxel sums its pixels) is a later PR's.
//
// Bound on the H100: bytes. The function reads the image gradient (16 B a
// pixel), the depth (4 B) and the scene (12 B) and writes the gradient
// volume once (16 B a froxel): at 1280x720 on 160x88x64 29.5 MB + 14.4 MB
// = 43.9 MB, ~13 us at 3.35 TB/s; at 1920x1080 on 240x135x128 66.4 MB +
// 66.4 MB = 133 MB, ~40 us. This design also zeroes the volume first (a
// second 16 B a froxel, which a gather form would not need), and its
// atomics resolve in L2, so K14 is expected to sit far from that bound:
// its times, memset included, are in PERF.md.
#include <cuda_runtime.h>

#include "composite_taps.cuh"

// The gradient of v (g_r, g_g, g_b, g_T) at pixel idx.
__device__ __forceinline__ void pixel_grad(const float* __restrict__ grad,
                                           const float* __restrict__ scene,
                                           long idx, float* gv) {
  const long o = idx * 4, so = idx * 3;
  gv[0] = __ldg(grad + o);
  gv[1] = __ldg(grad + o + 1);
  gv[2] = __ldg(grad + o + 2);
  gv[3] = gv[0] * __ldg(scene + so) + gv[1] * __ldg(scene + so + 1)
          + gv[2] * __ldg(scene + so + 2) + __ldg(grad + o + 3);
}

// Adds the tap (yy, xx) of weight wt to the gradient at slices z0 and z1.
__device__ __forceinline__ void add_grad(float* __restrict__ gacc, long n,
                                         int h, int w, int z0, int z1,
                                         int yy, int xx, float wt,
                                         const float* g0, const float* g1) {
  const long o0 = ((long)z0 * h + yy) * w + xx;
  const long o1 = ((long)z1 * h + yy) * w + xx;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    atomicAdd(gacc + c * n + o0, g0[c] * wt);
    atomicAdd(gacc + c * n + o1, g1[c] * wt);
  }
}

// The cells form: in-cell position's first tap and 2x2 weights from the
// tables of vr_composite; PY, PX as there.
template <int PY, int PX>
__global__ void composite_grad_kernel(const float* __restrict__ grad,
                                      const float* __restrict__ scene,
                                      const float* __restrict__ depth,
                                      const int2* __restrict__ first,
                                      const float4* __restrict__ wts,
                                      const float* __restrict__ fp, int w,
                                      int h, int d, int ih, int iw,
                                      float* __restrict__ gacc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ih || j >= iw) return;
  const int py = PY ? PY : ih / h, px = PX ? PX : iw / w;
  const int cy = i / py, cx = j / px;
  const int cell = (i - cy * py) * px + (j - cx * px);
  const long idx = (long)i * iw + j;
  int z0, z1;
  float f;
  depth_taps(__ldg(depth + idx), fp, d, z0, z1, f);
  float gv[4], g0[4], g1[4];
  pixel_grad(grad, scene, idx, gv);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g0[c] = gv[c] * (1.0f - f);
    g1[c] = gv[c] * f;
  }
  const int2 t0 = __ldg(first + cell);
  const float4 q = __ldg(wts + cell);
  const float wq[4] = {q.x, q.y, q.z, q.w};
  const long n = (long)d * h * w;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int yy = min(max(cy + t0.x + a - 1, 0), h - 1);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wt = wq[2 * a + b];
      if (wt == 0.0f) continue;  // K4 reads nothing there
      const int xx = min(max(cx + t0.y + b - 1, 0), w - 1);
      add_grad(gacc, n, h, w, z0, z1, yy, xx, wt, g0, g1);
    }
  }
}

// The per-pixel form: row i's taps yk[i], yk[i] + 1 with weights
// (yw[i], yw[IH + i]), column j's likewise, as vr_composite_pixels.
__global__ void composite_grad_pixels_kernel(
    const float* __restrict__ grad, const float* __restrict__ scene,
    const float* __restrict__ depth, const int* __restrict__ yk,
    const float* __restrict__ yw, const int* __restrict__ xk,
    const float* __restrict__ xw, const float* __restrict__ fp, int w, int h,
    int d, int ih, int iw, float* __restrict__ gacc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ih * iw) return;
  const int j = idx % iw;
  const int i = idx / iw;
  int z0, z1;
  float f;
  depth_taps(__ldg(depth + idx), fp, d, z0, z1, f);
  float gv[4], g0[4], g1[4];
  pixel_grad(grad, scene, idx, gv);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g0[c] = gv[c] * (1.0f - f);
    g1[c] = gv[c] * f;
  }
  const long n = (long)d * h * w;
  const int ky = __ldg(yk + i), kx = __ldg(xk + j);
  for (int a = 0; a < 2; ++a) {
    const float wy = __ldg(yw + a * ih + i);
    const int yy = min(max(ky + a, 0), h - 1);
    for (int b = 0; b < 2; ++b) {
      const float wt = wy * __ldg(xw + b * iw + j);
      if (wt == 0.0f) continue;  // K4 reads nothing there
      const int xx = min(max(kx + b, 0), w - 1);
      add_grad(gacc, n, h, w, z0, z1, yy, xx, wt, g0, g1);
    }
  }
}

// gacc must be zeroed by the caller: the kernel adds into it.
extern "C" int vr_composite_grad(const float* grad, const float* scene,
                                 const float* depth, const int* first,
                                 const float* wts, const float* fp, int w,
                                 int h, int d, int ih, int iw, float* gacc,
                                 cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((iw + block.x - 1) / block.x, (ih + block.y - 1) / block.y);
  const int py = ih / h, px = iw / w;
  auto kernel = composite_grad_kernel<0, 0>;
  if (py == 8 && px == 8) kernel = composite_grad_kernel<8, 8>;
  kernel<<<grid, block, 0, stream>>>(
      grad, scene, depth, reinterpret_cast<const int2*>(first),
      reinterpret_cast<const float4*>(wts), fp, w, h, d, ih, iw, gacc);
  return (int)cudaGetLastError();
}

extern "C" int vr_composite_grad_pixels(const float* grad, const float* scene,
                                        const float* depth, const int* yk,
                                        const float* yw, const int* xk,
                                        const float* xw, const float* fp,
                                        int w, int h, int d, int ih, int iw,
                                        float* gacc, cudaStream_t stream) {
  const int n = ih * iw;
  const int block = 256;
  composite_grad_pixels_kernel<<<(n + block - 1) / block, block, 0, stream>>>(
      grad, scene, depth, yk, yw, xk, xw, fp, w, h, d, ih, iw, gacc);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the cells kernel at 8x8 and at any cell, and of
// the per-pixel kernel, as vr_composite_attrs.
extern "C" int vr_composite_grad_attrs(int* out) {
  const void* fns[3] = {(const void*)composite_grad_kernel<8, 8>,
                        (const void*)composite_grad_kernel<0, 0>,
                        (const void*)composite_grad_pixels_kernel};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return (int)err;
    out[4 * k] = a.numRegs;
    out[4 * k + 1] = (int)a.sharedSizeBytes;
    out[4 * k + 2] = (int)a.localSizeBytes;
    out[4 * k + 3] = a.maxThreadsPerBlock;
  }
  return 0;
}

// K4 composite: the exact-f32 trilinear composite of the accumulation over
// the scene colour.
//
// Replaces volumetricrenderer_tpu/ops/pallas/zg_composite.py `_kernel` and
// `_kernel_multisub` (composite_zgather_planes / composite_zgather, :83,
// :126, :191, :461). The TPU form transposed row blocks so froxel cells
// became sublane rows, gathered both z taps of 64 pixels with one 128-lane
// take_along_axis, baked the edge clamps into padded planes, split cells
// larger than 8x8 into 8x8 sub-images that keep the parent cell's weights
// (_kernel_multisub), and unshuffled the cell-blocked output; all of that is
// a layout workaround. On the GPU each pixel gathers its taps directly, at
// any cell size.
//
// One thread per pixel (i, j): fz = depth_to_froxel_z(depth) - 0.5, clipped
// to [0, d-1], z1 = min(z0 + 1, d - 1); the xy taps are the 3x3 cell
// neighbours weighted by the static per-pixel-in-cell bilinear weights w9
// [9, py*px] (zg_composite.cell_weights; clamp-to-edge), of which at most
// 2x2 are non-zero: the host gives each in-cell position its first tap
// (dy0, dx0) and those four weights, copied bit for bit from w9
// (zg_composite.cell_taps); then rgb = scene * T + L, a = T, packed
// [IH, IW, 4].
// With no scene colour (scene null) the kernel writes the four sampled
// planes (L_r, L_g, L_b, T) [4, IH, IW] instead, as
// composite_zgather_planes returns them: the co-sited fractional-resolution
// composite samples them at the low resolution with the co-sited weights
// (composite_zgather_planes' w9_override) and upsamples them outside.
//
// A slab of an H-sharded frame (parallel/shard_render.py) composites its
// band of the image over h cell rows from its halo-extended accumulation
// of h_acc rows: cell row cy reads accumulation rows cy + row_off + dy - 1
// (row_off = the halo >= 1), which are the neighbouring shards' real rows
// where the whole grid (row_off 0, h_acc = h) clamps to its edge -- the
// TPU kernel's halo_rows slice and its prepadded row_off window, which
// differ only in layout. The clamp to [0, h_acc - 1] binds only at row_off
// 0.
//
// The per-pixel form (vr_composite_pixels) serves every other pixel/froxel
// ratio: the JAX package's composite_rowmm (a non-integer IH/H, 720 rows on
// 88 at the demo grid), composite_anyres (a non-integer IW/W) and the
// per-pixel gather of composite_impl="xla" -- XLA composites, not Pallas
// kernels, all the same clamped trilinear in other TPU layouts (selection
// matmuls, edge-padded rows). Per output row i and column j the host gives
// the first tap and the two weights of f = (i + 0.5) * H / IH - 0.5, worked
// out in float64 as rowmm does (zg_composite.pixel_taps); the taps are
// clamped to the volume, which is the edge padding's value. A slab's band
// takes the same form with the taps of its rows in the global mapping,
// offset by the halo into its extended volume (JAX's slab composite_rowmm
// fy), where the clamp never binds.
//
// Bound on the H100: bytes. Per 1080p frame read depth (8.3 MB) + scene
// colour (24.9 MB) + the accumulation (66 MB), write the image (33 MB):
// ~132 MB, ~40 us at 3.35 TB/s; at 3840x2160, 99.5 MB of scene, 33 MB of
// depth and 133 MB of image: ~0.099 ms. The planes form at 1920x1080 reads
// no scene and writes 33 MB. Neighbouring pixels share cells, so the 8 taps
// per channel come from L1/L2; the planes are read about once from memory.
// What the design does about it: a 2D block of 32x8 pixels (a warp is 32
// pixels of one row: coalesced depth, scene and image) with no division by
// the image width, the cell sizes of the 1080p, 4K and co-sited frames
// (8x8, 16x16, 8x16) as template parameters so that the cell and in-cell
// indices cost shifts; each thread reads its position's 2x2 entry once and
// gathers exactly four xy taps in (dy, dx) order, skipping zero weights as
// the 3x3 loop did -- the same adds in the same order, so the result is
// bit for bit the 3x3 loop's. The first form looped over all nine taps with
// a table load and a data-dependent skip each, in 1D blocks that divided
// by the image width; on a slab's 360x1920 band it lost to grid_sample. On
// the H100 the 2x2 taps and the 2D block took 26-29% off each cells form,
// the template 12-15% more (tools/k3_k4_against.py; PERF.md).
#include <cuda_runtime.h>

// froxel.depth_to_froxel_z - 0.5 of the pixel's depth, clipped to the
// volume: the two z taps and the lerp weight.
__device__ __forceinline__ void depth_taps(float depth, const float* fp,
                                           int d, int& z0, int& z1,
                                           float& f) {
  const float fpz = fp[0], fpw = fp[1], near_ = fp[2];
  float fz = (float)d * logf(fmaxf((depth - near_) / fpw + 1.0f, 1e-8f))
             / logf(fpz);
  fz = fz - 0.5f;
  fz = fminf(fmaxf(fz, 0.0f), (float)d - 1.0f);
  const float z0f = floorf(fz);
  f = fz - z0f;
  z0 = min(max((int)z0f, 0), d - 1);
  z1 = min(z0 + 1, d - 1);
}

// Adds wt x the (L_r, L_g, L_b, T) of froxel column (yy, xx) at slices z0
// and z1 to s0 and s1.
__device__ __forceinline__ void add_tap(const float* __restrict__ acc,
                                        long n, int h, int w, int z0, int z1,
                                        int yy, int xx, float wt, float* s0,
                                        float* s1) {
  const long o0 = ((long)z0 * h + yy) * w + xx;
  const long o1 = ((long)z1 * h + yy) * w + xx;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s0[c] = s0[c] + __ldg(acc + c * n + o0) * wt;
    s1[c] = s1[c] + __ldg(acc + c * n + o1) * wt;
  }
}

// The z lerp, then rgb = scene * T + L, a = T packed [IH, IW, 4], or with
// no scene the four planes [4, IH, IW].
__device__ __forceinline__ void write_pixel(const float* s0, const float* s1,
                                           float f,
                                           const float* __restrict__ scene,
                                           long idx, long np,
                                           float* __restrict__ out) {
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = s0[c] * (1.0f - f) + s1[c] * f;
  if (scene == nullptr) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * np + idx] = v[c];
    return;
  }
  const long o = idx * 4;
  const long so = idx * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[o + c] = __ldg(scene + so + c) * v[3] + v[c];
  out[o + 3] = v[3];
}

// PY, PX: the cell's pixel rows and columns where the launcher knows them
// (8x8, 16x16, 8x16), so that the cell and in-cell indices cost shifts;
// 0 takes them from the shapes.
template <int PY, int PX>
__global__ void composite_kernel(const float* __restrict__ acc,
                                 const float* __restrict__ scene,
                                 const float* __restrict__ depth,
                                 const int2* __restrict__ first,
                                 const float4* __restrict__ wts,
                                 const float* __restrict__ fp, int w, int h,
                                 int d, int ih, int iw, int h_acc,
                                 int row_off, float* __restrict__ out) {
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

  const int2 t0 = __ldg(first + cell);
  const float4 q = __ldg(wts + cell);
  const float wq[4] = {q.x, q.y, q.z, q.w};
  const long n = (long)d * h_acc * w;
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int yy = min(max(cy + row_off + t0.x + a - 1, 0), h_acc - 1);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wt = wq[2 * a + b];
      if (wt == 0.0f) continue;  // adds exactly 0 in the reference
      const int xx = min(max(cx + t0.y + b - 1, 0), w - 1);
      add_tap(acc, n, h_acc, w, z0, z1, yy, xx, wt, s0, s1);
    }
  }
  write_pixel(s0, s1, f, scene, idx, (long)ih * iw, out);
}

// The per-pixel form: row i's taps yk[i], yk[i] + 1 with weights
// (yw[i], yw[IH + i]), column j's likewise from xk, xw; y outer, x inner.
__global__ void composite_pixels_kernel(
    const float* __restrict__ acc, const float* __restrict__ scene,
    const float* __restrict__ depth, const int* __restrict__ yk,
    const float* __restrict__ yw, const int* __restrict__ xk,
    const float* __restrict__ xw, const float* __restrict__ fp, int w, int h,
    int d, int ih, int iw, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ih * iw) return;
  const int j = idx % iw;
  const int i = idx / iw;
  int z0, z1;
  float f;
  depth_taps(__ldg(depth + idx), fp, d, z0, z1, f);

  const long n = (long)d * h * w;
  const int ky = __ldg(yk + i), kx = __ldg(xk + j);
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int a = 0; a < 2; ++a) {
    const float wy = __ldg(yw + a * ih + i);
    const int yy = min(max(ky + a, 0), h - 1);
    for (int b = 0; b < 2; ++b) {
      const float wt = wy * __ldg(xw + b * iw + j);
      if (wt == 0.0f) continue;  // adds exactly 0 in the reference
      const int xx = min(max(kx + b, 0), w - 1);
      add_tap(acc, n, h, w, z0, z1, yy, xx, wt, s0, s1);
    }
  }
  write_pixel(s0, s1, f, scene, idx, (long)ih * iw, out);
}

extern "C" int vr_composite(const float* acc, const float* scene,
                            const float* depth, const int* first,
                            const float* wts, const float* fp, int w, int h,
                            int d, int ih, int iw, int h_acc, int row_off,
                            float* out, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((iw + block.x - 1) / block.x, (ih + block.y - 1) / block.y);
  const int py = ih / h, px = iw / w;
  auto kernel = composite_kernel<0, 0>;
  if (py == 8 && px == 8) kernel = composite_kernel<8, 8>;
  if (py == 16 && px == 16) kernel = composite_kernel<16, 16>;
  if (py == 8 && px == 16) kernel = composite_kernel<8, 16>;
  kernel<<<grid, block, 0, stream>>>(
      acc, scene, depth, reinterpret_cast<const int2*>(first),
      reinterpret_cast<const float4*>(wts), fp, w, h, d, ih, iw, h_acc,
      row_off, out);
  return (int)cudaGetLastError();
}

extern "C" int vr_composite_pixels(const float* acc, const float* scene,
                                   const float* depth, const int* yk,
                                   const float* yw, const int* xk,
                                   const float* xw, const float* fp, int w,
                                   int h, int d, int ih, int iw, float* out,
                                   cudaStream_t stream) {
  const int n = ih * iw;
  const int block = 256;
  composite_pixels_kernel<<<(n + block - 1) / block, block, 0, stream>>>(
      acc, scene, depth, yk, yw, xk, xw, fp, w, h, d, ih, iw, out);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the cells kernel at 8x8 and at any cell, and of
// the per-pixel kernel: per kernel its registers per thread, static shared
// bytes per block, local bytes per thread and largest block, four ints each
// into out; returns the error.
extern "C" int vr_composite_attrs(int* out) {
  const void* fns[3] = {(const void*)composite_kernel<8, 8>,
                        (const void*)composite_kernel<0, 0>,
                        (const void*)composite_pixels_kernel};
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

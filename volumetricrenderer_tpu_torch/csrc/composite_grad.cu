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
// A gather: every froxel is written once, by one thread, from a sum in one
// fixed order. Pixel (i, j)'s taps are rows clamp(ky[i] + a) and columns
// clamp(kx[j] + b), a, b in (0, 1), both forms (host tables,
// zg_composite.grad_footprint); ky and kx are monotone, so the pixels whose
// tap a reaches froxel row y are one range of rows [lo_a[y], hi_a[y]), and
// likewise for the columns, zero-weight and edge-clamped taps included (at
// the grid's edge both taps of a pixel land on the edge froxel). THE
// ORDER: each froxel's terms are added, starting from +0, for the pixel
// rows in order, for each row its taps a in order, for each the pixel
// columns in order, for each its taps b in order, and for each tap the z0
// term before the z1 term: key (i, a, j, b, z0/z1). The twin
// (zg_composite.composite_grad_plain) adds the same terms in the same
// order, so with --fmad=false the two are equal bit for bit; and every
// launch gives the same bits.
//
// A block owns a tile of K14Tile::X x K14Tile::Y froxel columns, a thread a
// (column, channel) of it, channel fastest. Each thread keeps its column's
// d sums for its channel in shared memory, [d][THREADS] with the thread
// fastest, so that a warp's adds never share a bank. The block stages its
// tile's footprint (the union of its columns' pixel ranges) K14_ROWS pixel
// rows at a time: per pixel z0, f and the four g_v (24 B; the g_v planes
// an odd number of floats apart, so that a warp's four channels read four
// banks apart), and once per footprint column its two weights (per pixel)
// or its in-cell column (cells). Between two barriers each thread walks its
// own rows of the chunk: for each of a row's taps that reaches its row,
// the columns of its range, adding the tap b = 0 and b = 1 terms where the
// column is in that tap's range (away from the grid's edge a pixel is in
// one of them). A chunk of rows keeps a block's shared memory small enough
// for 7 blocks an SM at 64 slices, 4 at 128. Then each thread stores its d
// sums (the output is torch.empty: every element, zeros included, is
// written here).
//
// Any slice count (the chunked form, CHUNKED): where a block's d sums and
// its footprint pass the 227 KB a block may take, the launcher splits the
// slices into the fewest chunks that fit, ceil(d / chunks) slices each
// (the last the rest), one chunk a grid z index (mirrored by
// ops/zg_composite.k14_chunks). A chunk's block stages the same footprint
// and walks the same terms in the same order, adding only those whose
// slice lies in its chunk: a froxel lies in one chunk and sums its terms in
// the key order above, so the chunked form is the twin bit for bit, and
// the one-launch form bit for bit wherever both can run. Each launch is
// counted under its form (vr_composite_grad_forms).
//
// Bound on the H100: bytes. The function reads the image gradient (16 B a
// pixel), the depth (4 B) and the scene (12 B) and writes the gradient
// volume once (16 B a froxel): at 1280x720 on 160x88x64 29.5 MB + 14.4 MB
// = 43.9 MB, ~13 us at 3.35 TB/s; at 1920x1080 on 240x135x128 66.4 MB +
// 66.4 MB = 133 MB, ~40 us. A block reads its footprint's pixels once
// (~1.7x the tile's own at 8x8 cells, from L2 where neighbouring blocks
// share them); the shared-memory adds, two a (pixel, column, channel),
// and the staged loads before them are the work. Measured (PERF.md): the
// kernel takes about one block's latency per wave of blocks, so the
// blocks an SM set its time; a first form that staged the whole footprint
// at once (3 blocks an SM) and tested all four taps of every pixel took
// 1.8x as long, and a block's shared memory grown by 16 KB 1.2-1.7x.
#include <cuda_runtime.h>

#include "composite_taps.cuh"

// A block's tile of froxel columns, a thread a (column, channel); the
// pixel rows staged at a time (mirrored by ops/zg_composite.K14_TILE,
// K14_ROWS).
struct K14Tile {
  static constexpr int X = 8, Y = 2, THREADS = 4 * X * Y, ROWS = 8;
};

// A block's dynamic shared bytes for d slices and footprints at most fw
// pixel columns wide (mirrored by ops/zg_composite.k14_shared_bytes): the
// sums, z0 and f of a chunk's pixels, its four g_v planes of
// (ROWS fw | 1) floats, 8 B a footprint column.
static long k14_shared_bytes(int d, int fw) {
  const long cap = (long)K14Tile::ROWS * fw;
  return 4L * d * K14Tile::THREADS + 8L * cap + 16L * (cap | 1) + 8L * fw;
}

constexpr long K14_MAX_SHARED = 232448;  // the H100's opt-in block limit

// The gradient of v (g_r, g_g, g_b, g_T) at pixel idx.
__device__ __forceinline__ void pixel_grad(const float* __restrict__ grad,
                                           const float* __restrict__ scene,
                                           long idx, float* gv) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(grad) + idx);
  const long so = idx * 3;
  gv[0] = g.x;
  gv[1] = g.y;
  gv[2] = g.z;
  gv[3] = g.x * __ldg(scene + so) + g.y * __ldg(scene + so + 1)
          + g.z * __ldg(scene + so + 2) + g.w;
}

// Adds t0 to the sum of slice z0 and then t1 to that of z1 (my: the
// thread's column of the [d][THREADS] sums); at the far clamp z0 = z1 and
// the sum takes t0, then t1. CHUNKED: z0 and z1 relative to the chunk's
// first slice, a term whose slice is not in [0, nz) left out (z0 >= -1 and
// z1 <= nz: the caller skips a pixel with neither in the chunk).
template <bool CHUNKED = false>
__device__ __forceinline__ void add_terms(float* my, int z0, int z1, int nz,
                                          float t0, float t1) {
  constexpr int NT = K14Tile::THREADS;
  float* p0 = my + z0 * NT;
  float* p1 = my + z1 * NT;
  if constexpr (CHUNKED) {
    float a0 = 0.0f;
    if (z0 >= 0) {
      a0 = *p0 + t0;
      *p0 = a0;
    }
    if (z1 < nz) *p1 = (z1 == z0 ? a0 : *p1) + t1;
  } else {
    const float a0 = *p0 + t0;
    const float a1 = (z1 == z0 ? a0 : *p1) + t1;
    *p0 = a0;
    *p1 = a1;
  }
}

// ranges: per froxel row y lo_0, hi_0, lo_1, hi_1 ([4][h]: the pixel rows
// whose tap 0, tap 1 reaches y), then per froxel column the same ([4][w]).
// CELLS: wa the cell table's four weights per in-cell position
// ([ih/h * iw/w][4], vr_composite's), wb unused; else wa = yw [2, ih] and
// wb = xw [2, iw] (vr_composite_pixels'). CHUNKED: the block's chunk of
// slices starts at blockIdx.z * zc and takes at most zc of them.
template <bool CELLS, bool CHUNKED = false>
__global__ void __launch_bounds__(K14Tile::THREADS)
composite_grad_kernel(const float* __restrict__ grad,
                      const float* __restrict__ scene,
                      const float* __restrict__ depth,
                      const int* __restrict__ ranges,
                      const float* __restrict__ wa,
                      const float* __restrict__ wb,
                      const float* __restrict__ fp, int w, int h, int d,
                      int ih, int iw, int fw, float* __restrict__ gacc,
                      int zc) {
  constexpr int NT = K14Tile::THREADS, ROWS = K14Tile::ROWS;
  extern __shared__ float smem[];
  const int cap = ROWS * fw, gs = cap | 1;
  float* s_acc = smem;                              // [d (CHUNKED: zc)][NT]
  int* s_z = reinterpret_cast<int*>(smem + (long)(CHUNKED ? zc : d) * NT);
  float* s_f = reinterpret_cast<float*>(s_z + cap);            // [cap]
  float* s_g = s_f + cap;                                      // [4][gs]
  float* s_w0 = s_g + 4 * gs;                                  // [fw]
  float* s_w1 = s_w0 + fw;                                     // [fw]
  int* s_cs = reinterpret_cast<int*>(s_w0);  // CELLS: 4 (j % px)

  const int tid = threadIdx.x;
  const int c = tid & 3, col = tid >> 2;
  const int x0 = blockIdx.x * K14Tile::X, y0 = blockIdx.y * K14Tile::Y;
  const int x = x0 + col % K14Tile::X, y = y0 + col / K14Tile::X;
  const int xl = min(x0 + K14Tile::X, w) - 1, yl = min(y0 + K14Tile::Y, h) - 1;
  const int* ry = ranges;          // [4][h]
  const int* rx = ranges + 4 * h;  // [4][w]
  // the tile's footprint: the union of its rows' and columns' ranges
  const int fy0 = min(__ldg(ry + y0), __ldg(ry + 2 * h + y0));
  const int fy1 = max(__ldg(ry + h + yl), __ldg(ry + 3 * h + yl));
  const int fx0 = min(__ldg(rx + x0), __ldg(rx + 2 * w + x0));
  const int nfw = max(__ldg(rx + w + xl), __ldg(rx + 3 * w + xl)) - fx0;
  const int py = ih / h, px = iw / w;
  for (int k = tid; k < nfw; k += NT) {
    const int j = fx0 + k;
    if (CELLS) {
      s_cs[k] = 4 * (j % px);
    } else {
      s_w0[k] = __ldg(wb + j);
      s_w1[k] = __ldg(wb + iw + j);
    }
  }
  float* my = s_acc + tid;
  const int z_lo = CHUNKED ? (int)blockIdx.z * zc : 0;
  const int nz = CHUNKED ? min(zc, d - z_lo) : d;
  for (int z = 0; z < nz; ++z) my[z * NT] = 0.0f;

  const bool active = x < w && y < h;
  int i_lo[2] = {0, 0}, i_hi[2] = {0, 0}, j_lo[2] = {0, 0}, j_hi[2] = {0, 0};
  if (active) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      i_lo[t] = __ldg(ry + 2 * t * h + y);
      i_hi[t] = __ldg(ry + (2 * t + 1) * h + y);
      j_lo[t] = __ldg(rx + 2 * t * w + x) - fx0;
      j_hi[t] = __ldg(rx + (2 * t + 1) * w + x) - fx0;
    }
  }
  const int jlo = min(j_lo[0], j_lo[1]), jhi = max(j_hi[0], j_hi[1]);
  const float* sg = s_g + c * gs;
  for (int r0 = fy0; r0 < fy1; r0 += ROWS) {
    const int n_rows = min(ROWS, fy1 - r0), np = n_rows * nfw;
    __syncthreads();  // the last chunk is read, the columns are staged
    for (int k = tid; k < np; k += NT) {
      const int r = k / nfw;
      const long idx = (long)(r0 + r) * iw + fx0 + (k - r * nfw);
      int z0, z1;
      float f, gv[4];
      depth_taps(__ldg(depth + idx), fp, d, z0, z1, f);
      pixel_grad(grad, scene, idx, gv);
      s_z[k] = z0;
      s_f[k] = f;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) s_g[ch * gs + k] = gv[ch];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = r0; i < r0 + n_rows; ++i) {
      const int rbase = (i - r0) * nfw;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (i < i_lo[a] || i >= i_hi[a]) continue;
        // the row's weight (per pixel) or its cell-table row (cells)
        const float wy = CELLS ? 0.0f : __ldg(wa + a * ih + i);
        const float* wrow = wa + ((i % py) * px) * 4 + 2 * a;
        for (int jj = jlo; jj < jhi; ++jj) {
          const int z0 = s_z[rbase + jj];
          const float f = s_f[rbase + jj], g = sg[rbase + jj];
          const float g0 = g * (1.0f - f), g1 = g * f;
          const int z1 = min(z0 + 1, d - 1);
          if (CHUNKED && (z1 < z_lo || z0 >= z_lo + nz)) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (jj < j_lo[b] || jj >= j_hi[b]) continue;
            const float wt = CELLS ? __ldg(wrow + s_cs[jj] + b)
                                   : wy * (b ? s_w1[jj] : s_w0[jj]);
            if (wt == 0.0f) continue;  // K4 reads nothing there
            add_terms<CHUNKED>(my, z0 - z_lo, z1 - z_lo, nz, g0 * wt,
                               g1 * wt);
          }
        }
      }
    }
  }
  if (!active) return;
  const long n = (long)d * h * w, hw = (long)h * w;
  float* out = gacc + c * n + (CHUNKED ? z_lo * hw : 0) + (long)y * w + x;
  for (int z = 0; z < nz; ++z) out[z * hw] = my[z * NT];
}

using K14Kernel = decltype(&composite_grad_kernel<true>);

// The kernel of a form, opted in (once per device, form and size: the call
// is not asynchronous) to `smem` bytes above 48 KB and to the largest
// shared-memory carveout, so that as many blocks as fit run on an SM.
static cudaError_t k14_kernel(int cells, bool chunked, long smem,
                              K14Kernel* out) {
  *out = cells ? (chunked ? composite_grad_kernel<true, true>
                          : composite_grad_kernel<true>)
               : (chunked ? composite_grad_kernel<false, true>
                          : composite_grad_kernel<false>);
  static long opted[16][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidValue;
  long& done = opted[dev][2 * chunked + (cells != 0)];
  if (smem <= done) return cudaSuccess;
  err = cudaFuncSetAttribute(*out,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        *out, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done = smem;
  return err;
}

// The chunk plan (mirrored by ops/zg_composite.k14_chunks): the slices a
// chunk takes, zc, and the chunks, ceil(d / zc). zc <= 0: the size rule's,
// all d slices in one launch where they fit, else the fewest chunks that
// fit, their slices spread evenly; 0 chunks where not one slice fits.
static void k14_plan(int d, int fw, int zc_in, int* n, int* zc) {
  *n = 0;
  *zc = zc_in;
  if (zc_in <= 0) {
    const long fit =
        (K14_MAX_SHARED - k14_shared_bytes(0, fw)) / (4L * K14Tile::THREADS);
    if (fit < 1) return;
    const long chunks = (d + fit - 1) / fit;
    *zc = (int)((d + chunks - 1) / chunks);
  }
  *n = (d + *zc - 1) / *zc;
}

// Launches of the one-launch (0) and the chunked (1) form since the
// library was loaded (vr_composite_grad_forms).
static long g_forms[2];

static int k14_launch(const float* grad, const float* scene,
                      const float* depth, const int* ranges, const float* wa,
                      const float* wb, const float* fp, int w, int h, int d,
                      int ih, int iw, int fw, int cells, int zc_in,
                      float* gacc, cudaStream_t stream) {
  if (w < 1 || h < 1 || d < 1 || fw < 0) return (int)cudaErrorInvalidValue;
  int n, zc;
  k14_plan(d, fw, zc_in, &n, &zc);
  const bool chunked = n > 1;
  const long smem = k14_shared_bytes(chunked ? zc : d, fw);
  const dim3 grid((w + K14Tile::X - 1) / K14Tile::X,
                  (h + K14Tile::Y - 1) / K14Tile::Y, n);
  if (n < 1 || n > 65535 || smem > K14_MAX_SHARED || grid.y > 65535
      || reinterpret_cast<size_t>(grad) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  K14Kernel kernel;
  cudaError_t err = k14_kernel(cells, chunked, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, K14Tile::THREADS, smem, stream>>>(
      grad, scene, depth, ranges, wa, wb, fp, w, h, d, ih, iw, fw, gacc, zc);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_forms[chunked];
  return (int)err;
}

// K14's one entry point. cells != 0: the cells form (wa the cell table, wb
// unused), else the per-pixel form (wa = yw, wb = xw); fw: the widest tile
// footprint (zg_composite.grad_footprint); zc: the slices a chunk (zc >= d:
// one launch), or <= 0 for the size rule's plan (k14_plan). Writes every
// element of gacc [4, d, h, w]; refused where a chunk does not fit.
extern "C" int vr_composite_grad_chunks(const float* grad, const float* scene,
                                        const float* depth, const int* ranges,
                                        const float* wa, const float* wb,
                                        const float* fp, int w, int h, int d,
                                        int ih, int iw, int fw, int cells,
                                        int zc, float* gacc,
                                        cudaStream_t stream) {
  return k14_launch(grad, scene, depth, ranges, wa, wb, fp, w, h, d, ih, iw,
                    fw, cells, zc, gacc, stream);
}

// The size rule's plan at d slices and footprints fw columns wide: the
// chunks, the slices a chunk and a block's dynamic shared bytes, into
// out[0..2].
extern "C" int vr_composite_grad_plan(int d, int fw, int* out) {
  int n, zc;
  k14_plan(d, fw, 0, &n, &zc);
  out[0] = n;
  out[1] = zc;
  out[2] = (int)k14_shared_bytes(n > 1 ? zc : d, fw);
  return 0;
}

// The launches of the one-launch and the chunked form so far into
// out[0..1].
extern "C" int vr_composite_grad_forms(int* out) {
  out[0] = (int)g_forms[0];
  out[1] = (int)g_forms[1];
  return 0;
}

// The blocks of a form that run at once on an SM at d slices and footprints
// fw columns wide (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into
// out[0].
extern "C" int vr_composite_grad_occupancy(int cells, int d, int fw,
                                           int* out) {
  const long smem = k14_shared_bytes(d, fw);
  if (smem > K14_MAX_SHARED) return (int)cudaErrorInvalidValue;
  K14Kernel kernel;
  cudaError_t err = k14_kernel(cells, false, smem, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, K14Tile::THREADS, (size_t)smem);
  return (int)err;
}

// The tile (columns, rows), threads, pixel rows staged at a time and
// dynamic shared bytes of d slices and footprints fw columns wide into
// out[0..4].
extern "C" int vr_composite_grad_geometry(int d, int fw, int* out) {
  out[0] = K14Tile::X;
  out[1] = K14Tile::Y;
  out[2] = K14Tile::THREADS;
  out[3] = K14Tile::ROWS;
  out[4] = (int)k14_shared_bytes(d, fw);
  return 0;
}

// cudaFuncGetAttributes of the cells and the per-pixel kernel, then their
// chunked forms, as vr_composite_attrs.
extern "C" int vr_composite_grad_attrs(int* out) {
  const void* fns[4] = {(const void*)composite_grad_kernel<true>,
                        (const void*)composite_grad_kernel<false>,
                        (const void*)composite_grad_kernel<true, true>,
                        (const void*)composite_grad_kernel<false, true>};
  for (int k = 0; k < 4; ++k) {
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

// K15 ssr_march_grad: the SSR march's backward, the colour planes'
// gradient.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA march
// (volumetricrenderer_tpu/post.py `_ssr_p`, the loop at :599-638, with
// post.SSR_PALLAS = False) by jax.grad; its Pallas march (ops/pallas/ssr.py,
// K13's original) has no backward. The port marches on K13, so this kernel
// is that march's adjoint. In the march, hit, sel and valid come from
// comparisons: the outputs depend on the colour planes only through
// wgt * shift(colour, oy, ox), and wgt is 1 at the pixel's first hit in
// its own bin and 0 at every other tap; onscreen zeroes every tap that
// leaves the plane, so a tap of weight 1 reads an in-plane pixel. Each
// pixel p therefore sends its colour cotangent to at most one source pixel
// q = p + (oy, ox), the first hit K13's RECORD instance wrote into the hit
// record (its tap index in p's bin, -1 for none or valid = 0; valid is the
// geometry stage's 0/1 mask, so the weight there is exactly 1).
//
// A gather, not a scatter: one thread per source pixel q walks the bins b
// and their taps k in a fixed order, sets p = q - (oy, ox), and where p is
// in the plane, bin(p) == b and hit(p) == k, adds g_c[p] to out_c[q]. No
// atomics: the gradient is deterministic, and it equals its plain-torch
// twin (ops/ssr.ssr_march_grad_plain, which adds a zero-filled shift of the
// masked cotangent per (b, k) in the same order) bit for bit: both start
// at +0 and add the same terms in the same order, the twin's other terms
// being +0.
//
// The tap table is K13's (ops/ssr.tap_table: per bin max_taps float4 rows,
// the packed offsets in .w) and its counts; a block copies them into
// shared memory once.
//
// Bound on the H100: bytes. At 1080p with ssr_downsample=4 the planes are
// 270x480: 3 cotangents, the bin and the hit record in, 3 gradients out,
// 8 x 129,600 x 4 B = 4.1 MB, 1.2 us at 3.35 TB/s. The reads of bin and
// hit at p = q - offset overlap between neighbouring threads (the same
// offsets, neighbouring p) and come from L1/L2; each thread does ~96 tap
// tests of a few integer operations.
#include <cuda_runtime.h>

// A block's tile of quarter-res pixels, a thread a pixel (mirrored by
// ops/ssr.K15_TILE).
struct K15Tile {
  static constexpr int X = 32, Y = 4;
};

constexpr int K15_OFF = 2048;   // the offset bias of a packed row (K13's)

__global__ void __launch_bounds__(K15Tile::X * K15Tile::Y)
ssr_march_grad_kernel(const float* __restrict__ gr,
                      const float* __restrict__ gg,
                      const float* __restrict__ gb,
                      const float* __restrict__ bin_idx,
                      const int* __restrict__ hit_k,
                      const float4* __restrict__ taps,
                      const int* __restrict__ n_taps, int n_bins,
                      int max_taps, int hq, int wq, float* __restrict__ out_r,
                      float* __restrict__ out_g, float* __restrict__ out_b) {
  extern __shared__ float4 s_rows[];   // [n_bins * max_taps], then counts
  int* s_count = reinterpret_cast<int*>(s_rows + n_bins * max_taps);
  const int tid = threadIdx.y * K15Tile::X + threadIdx.x;
  constexpr int THREADS = K15Tile::X * K15Tile::Y;
  for (int r = tid; r < n_bins * max_taps; r += THREADS) s_rows[r] = taps[r];
  for (int b = tid; b < n_bins; b += THREADS) s_count[b] = n_taps[b];
  __syncthreads();
  const int x = blockIdx.x * K15Tile::X + threadIdx.x;
  const int y = blockIdx.y * K15Tile::Y + threadIdx.y;
  if (x >= wq || y >= hq) return;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const float4* row = s_rows + b * max_taps;
    const int nt = s_count[b];
    const float bf = (float)b;
    for (int k = 0; k < nt; ++k) {
      const int pk = __float_as_int(row[k].w);
      const int py = y - ((pk & 0xfff) - K15_OFF);
      const int px = x - (((pk >> 12) & 0xfff) - K15_OFF);
      if (py < 0 || py >= hq || px < 0 || px >= wq) continue;
      const int j = py * wq + px;
      if (__ldg(hit_k + j) == k && __ldg(bin_idx + j) == bf) {
        acc_r = acc_r + __ldg(gr + j);
        acc_g = acc_g + __ldg(gg + j);
        acc_b = acc_b + __ldg(gb + j);
      }
    }
  }
  const int i = y * wq + x;
  out_r[i] = acc_r;
  out_g[i] = acc_g;
  out_b[i] = acc_b;
}

// A block's dynamic shared bytes: the table's rows and counts (mirrored by
// ops/ssr.k13_shared_bytes, K13's table).
static long k15_shared_bytes(int n_bins, int max_taps) {
  return (long)n_bins * max_taps * sizeof(float4) + (long)n_bins * sizeof(int);
}

// g_*: the cotangents of the march's three colour outputs, hit_k K13's hit
// record, taps and n_taps K13's table; out_*: the colour planes' gradients,
// all [hq, wq].
extern "C" int vr_ssr_march_grad(const float* gr, const float* gg,
                                 const float* gb, const float* bin_idx,
                                 const int* hit_k, const float* taps,
                                 const int* n_taps, int n_bins, int max_taps,
                                 int hq, int wq, float* out_r, float* out_g,
                                 float* out_b, cudaStream_t stream) {
  if (hq < 1 || wq < 1 || n_bins < 1 || max_taps < 1
      || (long)hq * wq > 2147483647L)
    return (int)cudaErrorInvalidValue;
  const long smem = k15_shared_bytes(n_bins, max_taps);
  const dim3 grid((wq + K15Tile::X - 1) / K15Tile::X,
                  (hq + K15Tile::Y - 1) / K15Tile::Y);
  if (smem > 48 * 1024 || grid.y > 65535
      || reinterpret_cast<size_t>(taps) % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(K15Tile::X, K15Tile::Y);
  ssr_march_grad_kernel<<<grid, block, smem, stream>>>(
      gr, gg, gb, bin_idx, hit_k, reinterpret_cast<const float4*>(taps),
      n_taps, n_bins, max_taps, hq, wq, out_r, out_g, out_b);
  return (int)cudaGetLastError();
}

// The tile (columns, rows) and the dynamic shared bytes of a table of
// n_bins x max_taps rows into out[0..2].
extern "C" int vr_ssr_march_grad_geometry(int n_bins, int max_taps,
                                          int* out) {
  out[0] = K15Tile::X;
  out[1] = K15Tile::Y;
  out[2] = (int)k15_shared_bytes(n_bins, max_taps);
  return 0;
}

// cudaFuncGetAttributes of the kernel: registers per thread, static shared
// bytes per block, local bytes per thread and largest block into out[0..3].
extern "C" int vr_ssr_march_grad_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)ssr_march_grad_kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return (int)err;
}

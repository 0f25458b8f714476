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
// A gather, not a scatter: source pixel q walks the bins b and their taps
// k in a fixed order, sets p = q - (oy, ox), and where p is in the plane,
// bin(p) == b and hit(p) == k, adds g_c[p] to out_c[q]. No atomics: the
// gradient is deterministic, and it equals its plain-torch twin
// (ops/ssr.ssr_march_grad_plain, which adds a zero-filled shift of the
// masked cotangent per (b, k) in the same order) bit for bit: both start
// at +0 and add the same terms in the same order, the twin's other terms
// being +0.
//
// Two launches on the stream. First a code plane: one int16 a pixel,
// bin(p) * max_taps + hit(p) where bin(p) is an integer in [0, n_bins) and
// hit(p) in [0, max_taps), else -1, on the plane grown by the table's
// offset extent (and the last tile's overhang) and -1 outside the plane, so
// that every tap of every thread reads inside it. Then the gather: a
// thread two source pixels of a K15Tile (rows ty and ty + Y / 2), the
// table's per-tap offsets in the code plane and in the colour planes in
// shared memory (unpacked once a block from K13's rows); a tap's test is
// one load from the code plane (L1: a block's tile and its halo, 36 KB at
// post_showcase's 56-pixel extent) and one integer compare, and the
// cotangents are read only on a hit. A first form staged each block's
// footprint of codes in shared memory: 36x its 512 pixels at that extent,
// it took longer than the tests (PERF.md).
//
// The tap table is K13's (ops/ssr.tap_table: per bin max_taps float4 rows,
// the packed offsets in .w) and its counts; the offset extent
// (oy_lo..oy_hi, ox_lo..ox_hi over every tap) and the code plane's scratch
// come from the wrapper (ops/ssr.tap_extent, k15_code_shape).
//
// Bound on the H100: bytes. At 1080p with ssr_downsample=4 the planes are
// 270x480: 3 cotangents, the bin and the hit record in, 3 gradients out,
// 8 x 129,600 x 4 B = 4.1 MB, 1.2 us at 3.35 TB/s. The code plane adds
// ~0.5 MB written and read from L2; each pixel makes ~96 tap tests of a few
// instructions.
#include <cuda_runtime.h>

// A block's tile of quarter-res source pixels (columns, rows), two rows a
// thread (mirrored by ops/ssr.K15_TILE); the code plane's blocks are
// X x Y / 2 pixels.
struct K15Tile {
  static constexpr int X = 32, Y = 16, THREADS = X * Y / 2;
};

constexpr int K15_OFF = 2048;   // the offset bias of a packed row (K13's)

// A block's dynamic shared bytes (mirrored by ops/ssr.k15_shared_bytes):
// two int32 offsets a tap and the counts.
static long k15_shared_bytes(int n_bins, int max_taps) {
  return 8L * n_bins * max_taps + 4L * n_bins;
}

// The code plane's rows and columns (mirrored by ops/ssr.k15_code_shape):
// the planes rounded up to whole tiles, grown by the offsets' span.
static void k15_code_shape(int hq, int wq, int span_y, int span_x, int* hc,
                           int* wc) {
  *hc = (hq + K15Tile::Y - 1) / K15Tile::Y * K15Tile::Y + span_y;
  *wc = (wq + K15Tile::X - 1) / K15Tile::X * K15Tile::X + span_x;
}

// codes[r, c] is pixel (r - oy_hi, c - ox_hi)'s code, -1 off the plane.
__global__ void __launch_bounds__(K15Tile::THREADS)
ssr_grad_codes_kernel(const float* __restrict__ bin_idx,
                      const int* __restrict__ hit_k, int n_bins,
                      int max_taps, int hq, int wq, int oy_hi, int ox_hi,
                      int hc, int wc, short* __restrict__ codes) {
  const int c = blockIdx.x * K15Tile::X + threadIdx.x;
  const int r = blockIdx.y * (K15Tile::Y / 2) + threadIdx.y;
  if (c >= wc || r >= hc) return;
  const int py = r - oy_hi, px = c - ox_hi;
  int code = -1;
  if (py >= 0 && py < hq && px >= 0 && px < wq) {
    const int j = py * wq + px;
    const int hit = __ldg(hit_k + j);
    const float bf = __ldg(bin_idx + j);
    if (hit >= 0 && hit < max_taps && bf >= 0.0f && bf < (float)n_bins
        && bf == floorf(bf))
      code = (int)bf * max_taps + hit;
  }
  codes[(long)r * wc + c] = (short)code;
}

__global__ void __launch_bounds__(K15Tile::THREADS)
ssr_march_grad_kernel(const float* __restrict__ gr,
                      const float* __restrict__ gg,
                      const float* __restrict__ gb,
                      const short* __restrict__ codes,
                      const float4* __restrict__ taps,
                      const int* __restrict__ n_taps, int n_bins,
                      int max_taps, int hq, int wq, int oy_hi, int ox_hi,
                      int wc, float* __restrict__ out_r,
                      float* __restrict__ out_g, float* __restrict__ out_b) {
  extern __shared__ int s_k15[];
  int* s_dc = s_k15;                          // [n_bins * max_taps]
  int* s_dp = s_dc + n_bins * max_taps;       // [n_bins * max_taps]
  int* s_count = s_dp + n_bins * max_taps;    // [n_bins]
  const int tid = threadIdx.y * K15Tile::X + threadIdx.x;
  for (int r = tid; r < n_bins * max_taps; r += K15Tile::THREADS) {
    const int pk = __float_as_int(taps[r].w);
    const int oy = (pk & 0xfff) - K15_OFF, ox = ((pk >> 12) & 0xfff) - K15_OFF;
    s_dc[r] = oy * wc + ox;   // a tap reads p = q - (oy, ox)
    s_dp[r] = oy * wq + ox;
  }
  for (int b = tid; b < n_bins; b += K15Tile::THREADS) s_count[b] = n_taps[b];
  __syncthreads();
  const int x = blockIdx.x * K15Tile::X + threadIdx.x;
  const int ya = blockIdx.y * K15Tile::Y + threadIdx.y;
  const int yb = ya + K15Tile::Y / 2;
  // past the plane's last row or column a thread still reads the code
  // plane (its overhang) and stores nothing
  const short* ca = codes + (long)(ya + oy_hi) * wc + x + ox_hi;
  const short* cb = ca + (long)(K15Tile::Y / 2) * wc;
  const int qa = ya * wq + x, qb = yb * wq + x;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, br = 0.0f, bg = 0.0f, bb = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const int nt = s_count[b];
    const int* dc = s_dc + b * max_taps;
    const int* dp = s_dp + b * max_taps;
    for (int k = 0; k < nt; ++k) {
      const int want = b * max_taps + k, d = dc[k];
      if (__ldg(ca - d) == want) {
        const int j = qa - dp[k];
        ar = ar + __ldg(gr + j);
        ag = ag + __ldg(gg + j);
        ab = ab + __ldg(gb + j);
      }
      if (__ldg(cb - d) == want) {
        const int j = qb - dp[k];
        br = br + __ldg(gr + j);
        bg = bg + __ldg(gg + j);
        bb = bb + __ldg(gb + j);
      }
    }
  }
  if (x >= wq) return;
  if (ya < hq) {
    out_r[qa] = ar;
    out_g[qa] = ag;
    out_b[qa] = ab;
  }
  if (yb < hq) {
    out_r[qb] = br;
    out_g[qb] = bg;
    out_b[qb] = bb;
  }
}

// g_*: the cotangents of the march's three colour outputs, hit_k K13's hit
// record, taps and n_taps K13's table, oy_lo..ox_hi its offset extent,
// codes the code plane's scratch (k15_code_shape int16); out_*: the colour
// planes' gradients, all [hq, wq].
extern "C" int vr_ssr_march_grad(const float* gr, const float* gg,
                                 const float* gb, const float* bin_idx,
                                 const int* hit_k, const float* taps,
                                 const int* n_taps, int n_bins, int max_taps,
                                 int hq, int wq, int oy_lo, int oy_hi,
                                 int ox_lo, int ox_hi, short* codes,
                                 float* out_r, float* out_g, float* out_b,
                                 cudaStream_t stream) {
  if (hq < 1 || wq < 1 || n_bins < 1 || max_taps < 1
      || (long)n_bins * max_taps > 32767 || oy_lo > oy_hi || ox_lo > ox_hi
      || (long)hq * wq > 2147483647L)
    return (int)cudaErrorInvalidValue;
  int hc, wc;
  k15_code_shape(hq, wq, oy_hi - oy_lo, ox_hi - ox_lo, &hc, &wc);
  const long smem = k15_shared_bytes(n_bins, max_taps);
  const dim3 grid((wq + K15Tile::X - 1) / K15Tile::X,
                  (hq + K15Tile::Y - 1) / K15Tile::Y);
  const dim3 grid_c((wc + K15Tile::X - 1) / K15Tile::X,
                    (hc + K15Tile::Y / 2 - 1) / (K15Tile::Y / 2));
  if (smem > 48 * 1024 || grid_c.y > 65535 || (long)hc * wc > 2147483647L
      || reinterpret_cast<size_t>(taps) % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(K15Tile::X, K15Tile::Y / 2);
  ssr_grad_codes_kernel<<<grid_c, block, 0, stream>>>(
      bin_idx, hit_k, n_bins, max_taps, hq, wq, oy_hi, ox_hi, hc, wc, codes);
  ssr_march_grad_kernel<<<grid, block, smem, stream>>>(
      gr, gg, gb, codes, reinterpret_cast<const float4*>(taps), n_taps,
      n_bins, max_taps, hq, wq, oy_hi, ox_hi, wc, out_r, out_g, out_b);
  return (int)cudaGetLastError();
}

// The tile (columns, rows), the dynamic shared bytes of a table of
// n_bins x max_taps rows and the code plane's rows and columns for
// [hq, wq] planes and offsets spanning span_y rows and span_x columns into
// out[0..4].
extern "C" int vr_ssr_march_grad_geometry(int n_bins, int max_taps, int hq,
                                          int wq, int span_y, int span_x,
                                          int* out) {
  out[0] = K15Tile::X;
  out[1] = K15Tile::Y;
  out[2] = (int)k15_shared_bytes(n_bins, max_taps);
  k15_code_shape(hq, wq, span_y, span_x, out + 3, out + 4);
  return 0;
}

// cudaFuncGetAttributes of the gather and the code kernel: registers per
// thread, static shared bytes per block, local bytes per thread and
// largest block into out[0..3] and out[4..7].
extern "C" int vr_ssr_march_grad_attrs(int* out) {
  const void* fns[2] = {(const void*)ssr_march_grad_kernel,
                        (const void*)ssr_grad_codes_kernel};
  for (int k = 0; k < 2; ++k) {
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

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
// Any table (the forms, chosen from the table's size, mirrored by
// ops/ssr.k15_form): the per-tap offsets in static shared memory up to
// 48 KB, in dynamic shared memory opted in (once per device) up to the
// 227 KB a block may take, and past that read from K13's rows in device
// memory through __ldg and unpacked per tap (GLOBAL); the code plane int16
// up to 32,767 bins x taps, int32 past them (CODE). A table of more bins x
// taps than int16 codes take is past the opt-in limit too (8 B a tap), so
// only the GLOBAL form has an int32 code plane. Every form walks the bins
// and taps in the same order: the twin bit for bit. Each launch is counted
// under its form (vr_ssr_march_grad_forms).
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

// codes[r, c] is pixel (r - oy_hi, c - ox_hi)'s code, -1 off the plane;
// CODE: short, or int past 32,767 bins x taps.
template <typename CODE>
__global__ void __launch_bounds__(K15Tile::THREADS)
ssr_grad_codes_kernel(const float* __restrict__ bin_idx,
                      const int* __restrict__ hit_k, int n_bins,
                      int max_taps, int hq, int wq, int oy_hi, int ox_hi,
                      int hc, int wc, CODE* __restrict__ codes) {
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
  codes[(long)r * wc + c] = (CODE)code;
}

// A packed row's offset (K13's bits 0-11 and 12-23).
__device__ __forceinline__ int k15_oy(int pk) { return (pk & 0xfff) - K15_OFF; }
__device__ __forceinline__ int k15_ox(int pk) {
  return ((pk >> 12) & 0xfff) - K15_OFF;
}

// GLOBAL: the offsets unpacked per tap from K13's rows in device memory,
// none in shared memory but the counts' place.
template <bool GLOBAL, typename CODE>
__global__ void __launch_bounds__(K15Tile::THREADS)
ssr_march_grad_kernel(const float* __restrict__ gr,
                      const float* __restrict__ gg,
                      const float* __restrict__ gb,
                      const CODE* __restrict__ codes,
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
  if constexpr (!GLOBAL) {
    for (int r = tid; r < n_bins * max_taps; r += K15Tile::THREADS) {
      const int pk = __float_as_int(taps[r].w);
      const int oy = k15_oy(pk), ox = k15_ox(pk);
      s_dc[r] = oy * wc + ox;   // a tap reads p = q - (oy, ox)
      s_dp[r] = oy * wq + ox;
    }
    for (int b = tid; b < n_bins; b += K15Tile::THREADS)
      s_count[b] = n_taps[b];
    __syncthreads();
  }
  const int x = blockIdx.x * K15Tile::X + threadIdx.x;
  const int ya = blockIdx.y * K15Tile::Y + threadIdx.y;
  const int yb = ya + K15Tile::Y / 2;
  // past the plane's last row or column a thread still reads the code
  // plane (its overhang) and stores nothing
  const CODE* ca = codes + (long)(ya + oy_hi) * wc + x + ox_hi;
  const CODE* cb = ca + (long)(K15Tile::Y / 2) * wc;
  const int qa = ya * wq + x, qb = yb * wq + x;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, br = 0.0f, bg = 0.0f, bb = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const int nt = GLOBAL ? __ldg(n_taps + b) : s_count[b];
    const int* dc = s_dc + b * max_taps;
    const int* dp = s_dp + b * max_taps;
    const float4* row = taps + b * max_taps;
    for (int k = 0; k < nt; ++k) {
      int d, pk = 0;
      if constexpr (GLOBAL) {
        pk = __float_as_int(__ldg(&row[k].w));
        d = k15_oy(pk) * wc + k15_ox(pk);
      } else {
        d = dc[k];
      }
      const int want = b * max_taps + k;
      if (__ldg(ca - d) == want) {
        const int j = qa - (GLOBAL ? k15_oy(pk) * wq + k15_ox(pk) : dp[k]);
        ar = ar + __ldg(gr + j);
        ag = ag + __ldg(gg + j);
        ab = ab + __ldg(gb + j);
      }
      if (__ldg(cb - d) == want) {
        const int j = qb - (GLOBAL ? k15_oy(pk) * wq + k15_ox(pk) : dp[k]);
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

// The forms (mirrored by ops/ssr.K15_FORMS): where the offsets lie
// (static shared memory, opted-in shared memory, device memory), the last
// also with the int32 code plane (_WIDE).
enum { K15_FIXED, K15_OPTIN, K15_GLOBAL, K15_GLOBAL_WIDE, K15_N_FORMS };
constexpr long K15_MAX_STATIC = 48 * 1024;
constexpr long K15_MAX_OPTIN = 232448;  // the H100's opt-in block limit
constexpr long K15_MAX_NARROW = 32767;  // bins x taps an int16 code takes

// Whether `form` can take a table of n_bins x max_taps rows: the offsets
// in static shared memory up to 48 KB, opted in up to K15_MAX_OPTIN, in
// device memory at any size; int16 codes up to K15_MAX_NARROW bins x taps.
static bool k15_form_fits(int form, int n_bins, int max_taps) {
  const long smem = k15_shared_bytes(n_bins, max_taps);
  const bool narrow = (long)n_bins * max_taps <= K15_MAX_NARROW;
  switch (form) {
    case K15_FIXED: return narrow && smem <= K15_MAX_STATIC;
    case K15_OPTIN: return narrow && smem <= K15_MAX_OPTIN;
    case K15_GLOBAL: return narrow;
    case K15_GLOBAL_WIDE: return true;
  }
  return false;
}

// The size rule (mirrored by ops/ssr.k15_form): the first form that fits.
static int k15_form(int n_bins, int max_taps) {
  int form = 0;
  while (!k15_form_fits(form, n_bins, max_taps)) ++form;
  return form;
}

// Launches of each form since the library was loaded
// (vr_ssr_march_grad_forms).
static long g_forms[K15_N_FORMS];

// Opts the gather with the offsets in shared memory in to K15_MAX_OPTIN
// bytes of dynamic shared memory, once per device (the call is not
// asynchronous).
static cudaError_t k15_opt_in() {
  static bool opted[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidValue;
  if (opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ssr_march_grad_kernel<false, short>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K15_MAX_OPTIN);
  if (err == cudaSuccess) opted[dev] = true;
  return err;
}

template <bool GLOBAL, typename CODE>
static void k15_run(const float* gr, const float* gg, const float* gb,
                    const float* bin_idx, const int* hit_k, const float* taps,
                    const int* n_taps, int n_bins, int max_taps, int hq,
                    int wq, int oy_hi, int ox_hi, int hc, int wc, void* codes,
                    long smem, float* out_r, float* out_g, float* out_b,
                    cudaStream_t stream) {
  const dim3 block(K15Tile::X, K15Tile::Y / 2);
  const dim3 grid((wq + K15Tile::X - 1) / K15Tile::X,
                  (hq + K15Tile::Y - 1) / K15Tile::Y);
  const dim3 grid_c((wc + K15Tile::X - 1) / K15Tile::X,
                    (hc + K15Tile::Y / 2 - 1) / (K15Tile::Y / 2));
  CODE* c = static_cast<CODE*>(codes);
  ssr_grad_codes_kernel<CODE><<<grid_c, block, 0, stream>>>(
      bin_idx, hit_k, n_bins, max_taps, hq, wq, oy_hi, ox_hi, hc, wc, c);
  ssr_march_grad_kernel<GLOBAL, CODE><<<grid, block, smem, stream>>>(
      gr, gg, gb, c, reinterpret_cast<const float4*>(taps), n_taps, n_bins,
      max_taps, hq, wq, oy_hi, ox_hi, wc, out_r, out_g, out_b);
}

static int k15_launch(const float* gr, const float* gg, const float* gb,
                      const float* bin_idx, const int* hit_k,
                      const float* taps, const int* n_taps, int n_bins,
                      int max_taps, int hq, int wq, int oy_lo, int oy_hi,
                      int ox_lo, int ox_hi, void* codes, int form,
                      float* out_r, float* out_g, float* out_b,
                      cudaStream_t stream) {
  if (form < 0) form = k15_form(n_bins, max_taps);
  if (hq < 1 || wq < 1 || n_bins < 1 || max_taps < 1 || oy_lo > oy_hi
      || ox_lo > ox_hi || (long)hq * wq > 2147483647L
      || (long)n_bins * max_taps > 2147483647L / (long)sizeof(float4)
      || !k15_form_fits(form, n_bins, max_taps))
    return (int)cudaErrorInvalidValue;
  int hc, wc;
  k15_code_shape(hq, wq, oy_hi - oy_lo, ox_hi - ox_lo, &hc, &wc);
  const long smem =
      form >= K15_GLOBAL ? 0 : k15_shared_bytes(n_bins, max_taps);
  if ((hc + K15Tile::Y / 2 - 1) / (K15Tile::Y / 2) > 65535
      || (long)hc * wc > 2147483647L
      || reinterpret_cast<size_t>(taps) % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  if (form == K15_OPTIN) {
    const cudaError_t err = k15_opt_in();
    if (err != cudaSuccess) return (int)err;
  }
  auto run = form == K15_GLOBAL_WIDE ? k15_run<true, int>
             : form == K15_GLOBAL    ? k15_run<true, short>
                                     : k15_run<false, short>;
  run(gr, gg, gb, bin_idx, hit_k, taps, n_taps, n_bins, max_taps, hq, wq,
      oy_hi, ox_hi, hc, wc, codes, smem, out_r, out_g, out_b, stream);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_forms[form];
  return (int)err;
}

// K15's one entry point. g_*: the cotangents of the march's three colour
// outputs, hit_k K13's hit record, taps and n_taps K13's table, oy_lo..ox_hi
// its offset extent, codes the code plane's scratch (k15_code_shape, int16,
// or int32 in the _WIDE form); out_*: the colour planes' gradients, all
// [hq, wq]. form: one of the forms, or -1 for the size rule's (k15_form),
// refused where it cannot take the table. The caller sizes the scratch for
// the form that runs: ops/ssr.ssr_march_grad passes the form it mirrors.
extern "C" int vr_ssr_march_grad_form(
    const float* gr, const float* gg, const float* gb, const float* bin_idx,
    const int* hit_k, const float* taps, const int* n_taps, int n_bins,
    int max_taps, int hq, int wq, int oy_lo, int oy_hi, int ox_lo,
    int ox_hi, void* codes, int form, float* out_r, float* out_g,
    float* out_b, cudaStream_t stream) {
  return k15_launch(gr, gg, gb, bin_idx, hit_k, taps, n_taps, n_bins,
                    max_taps, hq, wq, oy_lo, oy_hi, ox_lo, ox_hi, codes,
                    form, out_r, out_g, out_b, stream);
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

// The size rule's form for a table of n_bins x max_taps rows into out[0].
extern "C" int vr_ssr_march_grad_form_of(int n_bins, int max_taps,
                                         int* out) {
  out[0] = k15_form(n_bins, max_taps);
  return 0;
}

// The launches of each form so far into out[0..K15_N_FORMS).
extern "C" int vr_ssr_march_grad_forms(int* out) {
  for (int f = 0; f < K15_N_FORMS; ++f) out[f] = (int)g_forms[f];
  return 0;
}

// cudaFuncGetAttributes of the gather and the code kernel, then the GLOBAL
// gathers with int16 and int32 codes and the int32 code kernel: registers
// per thread, static shared bytes per block, local bytes per thread and
// largest block into out[4 k .. 4 k + 3].
extern "C" int vr_ssr_march_grad_attrs(int* out) {
  const void* fns[5] = {(const void*)ssr_march_grad_kernel<false, short>,
                        (const void*)ssr_grad_codes_kernel<short>,
                        (const void*)ssr_march_grad_kernel<true, short>,
                        (const void*)ssr_march_grad_kernel<true, int>,
                        (const void*)ssr_grad_codes_kernel<int>};
  for (int k = 0; k < 5; ++k) {
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

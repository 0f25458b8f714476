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
// never did).
//
// The same function as the plain-torch twin (ops/ssr.ssr_march_reference),
// bit for bit, for finite planes: with FMA contraction off and IEEE division
// (1 / max(invz, 1e-4) as `invz > 1e-4 ? 1 / invz : 1e9`), and because every
// term this kernel skips adds +-0 to a sum that is never -0. A sum starts at
// +0 and, rounding to nearest, a sum is -0 only when both terms are: so
//   - every other bin's sel * sum (sel = 0) leaves the twin's sums as they
//     are;
//   - a tap whose weight is 0 (no hit, or after the first hit) adds 0 * c;
//     the march stops at the first hit and reads the colours only there,
//     where the twin adds 1 * c to +0;
//   - a tap whose t_prev is the last tap's t (flagged by the host) reuses
//     that tap's 1/z: the same division of the same operands.
// A non-finite colour or depth at a tap the kernel skips would make the
// twin's sum NaN; chip_smoke.compare refuses a non-finite output.
//
// The taps come from a table the wrapper uploads once per config: per bin
// max_taps float4 rows (t_prev, t, t / max_px, packed) in float32, as the
// twin rounds them; packed holds oy + 2048 in bits 0-11, ox + 2048 in bits
// 12-23 and the reuse flag in bit 24. And per bin its tap count. A block
// copies the whole table (8 bins x 12 taps: 1.5 KB) into shared memory
// once.
//
// Bound on the H100: bytes. At 1080p with ssr_downsample=4 the planes are
// 270x480: 8 in, 5 out, 13 x 129,600 x 4 B = 6.7 MB, 2 us at 3.35 TB/s; the
// work, <= 12 taps x ~25 flops a pixel (~39 MFLOP), is below that. The
// taps of neighbouring pixels overlap, so the depth plane a tap reads comes
// from L1/L2; what is left is latency: a thread issues its bin's depth
// loads K13_CHUNK taps at a time (the tap count a template bound, the loops
// unrolled) and walks each chunk, one division a tap, to the first hit.
// 2-D tiles of 32 x K13Tile::Y pixels keep neighbouring rows' taps in one
// SM's L1.
//
// Any tap count and table size (the forms, chosen by the launcher from the
// table's size, mirrored by ops/ssr.k13_form): up to 32 taps a bin the
// MAX_TAPS 16 and 32 instances unroll a bin's chunks; past that the GEN
// instance (MAX_TAPS 0) walks them in a runtime loop, with the same depth
// loads, division, first hit and reuse, so that every instance is the twin
// bit for bit. The table lies in static shared memory up to 48 KB and past
// that in device memory, its rows read through __ldg by the GEN instance's
// GLOBAL form: on the H100 that form beat a copy in opted-in shared memory
// at every table past 48 KB (PERF.md), since a block's copy of a large
// table costs more than the few rows a pixel reads. Each launch is counted
// under its form (vr_ssr_march_forms).
//
// The RECORD instances (a hit_k plane given to vr_ssr_march_form) also
// write the hit
// record that K15 (csrc/ssr_march_grad.cu), the march's backward, reads: an
// int32 plane holding, per pixel, the index in its bin's tap list of the
// first hit, or -1 where it finds none or its valid flag is 0. The march's
// outputs depend on the colour planes only through that tap's read, with
// weight sel = valid (1). Without RECORD the code is the instance the
// forward frame launches, as it was before the record existed.
#include <cuda_runtime.h>

// A block's tile of quarter-res pixels, a thread a pixel (mirrored by
// ops/ssr.K13_TILE).
struct K13Tile {
  static constexpr int X = 32, Y = 4;
};

constexpr int K13_OFF = 2048;   // the offset bias of a packed row
constexpr int K13_CHUNK = 4;    // taps whose depth loads issue together

constexpr int K13_GEN = 0;     // MAX_TAPS of the runtime-loop instance

__device__ __forceinline__ float k13_depth(float invz) {
  return invz > 1e-4f ? 1.0f / invz : 1e9f;
}

// MAX_TAPS: the taps a bin unrolled (16, 32), or K13_GEN; GLOBAL: the table
// read from device memory (GEN only), not copied into shared memory.
template <int MAX_TAPS, bool RECORD, bool GLOBAL = false>
__global__ void __launch_bounds__(K13Tile::X * K13Tile::Y)
ssr_march_kernel(const float* __restrict__ dq, const float* __restrict__ cr,
                 const float* __restrict__ cg, const float* __restrict__ cb,
                 const float* __restrict__ invz0,
                 const float* __restrict__ g,
                 const float* __restrict__ bin_idx,
                 const float* __restrict__ valid,
                 const float4* __restrict__ taps,
                 const int* __restrict__ n_taps, int n_bins, int max_taps,
                 int hq, int wq, float thickness, float* __restrict__ rr,
                 float* __restrict__ rg, float* __restrict__ rb,
                 float* __restrict__ hit_w, float* __restrict__ hit_t,
                 int* __restrict__ hit_k) {
  extern __shared__ float4 s_rows[];   // [n_bins * max_taps], then counts
  int* s_count = reinterpret_cast<int*>(s_rows + n_bins * max_taps);
  const int tid = threadIdx.y * K13Tile::X + threadIdx.x;
  constexpr int THREADS = K13Tile::X * K13Tile::Y;
  if constexpr (!GLOBAL) {
    for (int r = tid; r < n_bins * max_taps; r += THREADS)
      s_rows[r] = taps[r];
    for (int b = tid; b < n_bins; b += THREADS) s_count[b] = n_taps[b];
    __syncthreads();
  }
  const int x = blockIdx.x * K13Tile::X + threadIdx.x;
  const int y = blockIdx.y * K13Tile::Y + threadIdx.y;
  if (x >= wq || y >= hq) return;
  const int i = y * wq + x;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, aw = 0.0f, at = 0.0f;
  int first = -1;   // the tap index of the first hit (RECORD)
  const float bf = __ldg(bin_idx + i);
  const int b = (int)bf;
  // a pixel whose bin is no bin of the table takes no bin's sums
  if (bf >= 0.0f && b < n_bins && (float)b == bf) {
    const float z0 = __ldg(invz0 + i);
    const float gi = __ldg(g + i);
    const float4* row;
    int nt;
    if constexpr (GLOBAL) {
      row = taps + b * max_taps;
      nt = __ldg(n_taps + b);
    } else {
      row = s_rows + b * max_taps;
      nt = s_count[b];
    }
    float z_last = 0.0f;
    bool hit = false;
    // unrolled in full by the fixed instances; GEN's trip count is nt's
#pragma unroll
    for (int k0 = 0; k0 < (MAX_TAPS > 0 ? MAX_TAPS : nt);
         k0 += K13_CHUNK) {
      if (hit || k0 >= nt) break;
      // the chunk's depths, its loads in flight at once
      float zs[K13_CHUNK];
#pragma unroll
      for (int c = 0; c < K13_CHUNK; ++c) {
        if (k0 + c < nt) {
          const int p = __float_as_int(GLOBAL ? __ldg(&row[k0 + c].w)
                                              : row[k0 + c].w);
          const int sy = y + (p & 0xfff) - K13_OFF;
          const int sx = x + ((p >> 12) & 0xfff) - K13_OFF;
          zs[c] = __ldg(dq + min(max(sy, 0), hq - 1) * wq
                        + min(max(sx, 0), wq - 1));
        }
      }
#pragma unroll
      for (int c = 0; c < K13_CHUNK; ++c) {
        if (k0 + c >= nt) break;
        const float4 t = GLOBAL ? __ldg(row + k0 + c) : row[k0 + c];
        const int p = __float_as_int(t.w);
        const int sy = y + (p & 0xfff) - K13_OFF;
        const int sx = x + ((p >> 12) & 0xfff) - K13_OFF;
        const float z_ray = k13_depth(z0 + gi * t.y);
        const float z_prev =
            (p >> 24) & 1 ? z_last : k13_depth(z0 + gi * t.x);
        z_last = z_ray;
        if (sy >= 0 && sy < hq && sx >= 0 && sx < wq && z_ray >= zs[c]
            && z_prev <= zs[c] + thickness) {
          // the twin's first hit: weight 1, added to +0
          const int j = sy * wq + sx;
          acc_r = 0.0f + __ldg(cr + j);
          acc_g = 0.0f + __ldg(cg + j);
          acc_b = 0.0f + __ldg(cb + j);
          aw = 1.0f;
          at = 0.0f + t.z;
          if (RECORD) first = k0 + c;
          hit = true;
          break;
        }
      }
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
  if (RECORD) hit_k[i] = sel != 0.0f ? first : -1;
}

// The tap count a kernel instance unrolls for a table of max_taps rows a
// bin; 0: the GEN instance's runtime loop (mirrored by ops/ssr.k13_unroll).
static int k13_unroll(int max_taps) {
  return max_taps <= 16 ? 16 : max_taps <= 32 ? 32 : 0;
}

// A block's dynamic shared bytes: the table's rows and counts (mirrored by
// ops/ssr.k13_shared_bytes).
static long k13_shared_bytes(int n_bins, int max_taps) {
  return (long)n_bins * max_taps * sizeof(float4) + (long)n_bins * sizeof(int);
}

// The forms (mirrored by ops/ssr.K13_FORMS): the instance, fixed (16 or 32
// taps unrolled) or GEN, and where its table lies.
enum { K13_FIXED, K13_GEN_STATIC, K13_GEN_GLOBAL, K13_N_FORMS };
constexpr long K13_MAX_STATIC = 48 * 1024;

// Whether `form` can take a table of n_bins x max_taps rows: the fixed
// instances up to 32 taps a bin; the table in static shared memory up to
// 48 KB, in device memory at any size.
static bool k13_form_fits(int form, int n_bins, int max_taps) {
  const bool shared = k13_shared_bytes(n_bins, max_taps) <= K13_MAX_STATIC;
  switch (form) {
    case K13_FIXED: return k13_unroll(max_taps) != 0 && shared;
    case K13_GEN_STATIC: return shared;
    case K13_GEN_GLOBAL: return true;
  }
  return false;
}

// The size rule (mirrored by ops/ssr.k13_form): the first form that fits.
static int k13_form(int n_bins, int max_taps) {
  int form = 0;
  while (!k13_form_fits(form, n_bins, max_taps)) ++form;
  return form;
}

using K13Kernel = decltype(&ssr_march_kernel<16, false>);

template <bool RECORD>
static K13Kernel k13_kernel(int form, int max_taps) {
  if (form == K13_GEN_GLOBAL) return ssr_march_kernel<K13_GEN, RECORD, true>;
  if (form == K13_GEN_STATIC) return ssr_march_kernel<K13_GEN, RECORD>;
  return k13_unroll(max_taps) == 16 ? ssr_march_kernel<16, RECORD>
                                    : ssr_march_kernel<32, RECORD>;
}

// Launches of each form since the library was loaded, without and with
// RECORD (vr_ssr_march_forms).
static long g_forms[2][K13_N_FORMS];

// form < 0: the size rule's (k13_form); else that form, refused where it
// cannot take the table.
template <bool RECORD>
static int k13_launch(const float* dq, const float* cr, const float* cg,
                      const float* cb, const float* invz0, const float* g,
                      const float* bin_idx, const float* valid,
                      const float* taps, const int* n_taps, int n_bins,
                      int max_taps, int hq, int wq, float thickness,
                      float* rr, float* rg, float* rb, float* hit_w,
                      float* hit_t, int* hit_k, int form,
                      cudaStream_t stream) {
  if (hq < 1 || wq < 1 || n_bins < 1 || max_taps < 1
      || (long)hq * wq > 2147483647L
      || (long)n_bins * max_taps > 2147483647L / (long)sizeof(float4))
    return (int)cudaErrorInvalidValue;
  if (form < 0) form = k13_form(n_bins, max_taps);
  const dim3 grid((wq + K13Tile::X - 1) / K13Tile::X,
                  (hq + K13Tile::Y - 1) / K13Tile::Y);
  if (form >= K13_N_FORMS || !k13_form_fits(form, n_bins, max_taps)
      || grid.y > 65535
      || reinterpret_cast<size_t>(taps) % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  const long smem =
      form == K13_GEN_GLOBAL ? 0 : k13_shared_bytes(n_bins, max_taps);
  const K13Kernel kernel = k13_kernel<RECORD>(form, max_taps);
  const dim3 block(K13Tile::X, K13Tile::Y);
  kernel<<<grid, block, smem, stream>>>(
      dq, cr, cg, cb, invz0, g, bin_idx, valid,
      reinterpret_cast<const float4*>(taps), n_taps, n_bins, max_taps, hq,
      wq, thickness, rr, rg, rb, hit_w, hit_t, hit_k);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_forms[RECORD][form];
  return (int)err;
}

// K13's one entry point. taps: [n_bins, max_taps] float4 rows (16-byte
// aligned), n_taps [n_bins]; the march's five outputs rr .. hit_t and, where
// hit_k [hq, wq] (int32) is not null, the hit record (the RECORD instance);
// form: one of the forms, or -1 for the size rule's (k13_form).
extern "C" int vr_ssr_march_form(
    const float* dq, const float* cr, const float* cg, const float* cb,
    const float* invz0, const float* g, const float* bin_idx,
    const float* valid, const float* taps, const int* n_taps, int n_bins,
    int max_taps, int hq, int wq, float thickness, float* rr, float* rg,
    float* rb, float* hit_w, float* hit_t, int* hit_k, int form,
    cudaStream_t stream) {
  if (hit_k == nullptr)
    return k13_launch<false>(dq, cr, cg, cb, invz0, g, bin_idx, valid, taps,
                             n_taps, n_bins, max_taps, hq, wq, thickness, rr,
                             rg, rb, hit_w, hit_t, nullptr, form, stream);
  return k13_launch<true>(dq, cr, cg, cb, invz0, g, bin_idx, valid, taps,
                          n_taps, n_bins, max_taps, hq, wq, thickness, rr,
                          rg, rb, hit_w, hit_t, hit_k, form, stream);
}

// The tile (columns, rows), the dynamic shared bytes and the unrolled tap
// count of a table of n_bins x max_taps rows into out[0..3].
extern "C" int vr_ssr_march_geometry(int n_bins, int max_taps, int* out) {
  out[0] = K13Tile::X;
  out[1] = K13Tile::Y;
  out[2] = (int)k13_shared_bytes(n_bins, max_taps);
  out[3] = k13_unroll(max_taps);
  return 0;
}

// The size rule's form for a table of n_bins x max_taps rows into out[0].
extern "C" int vr_ssr_march_form_of(int n_bins, int max_taps, int* out) {
  out[0] = k13_form(n_bins, max_taps);
  return 0;
}

// The launches of each form so far, K13_N_FORMS without RECORD, then as
// many with it, into out.
extern "C" int vr_ssr_march_forms(int* out) {
  for (int r = 0; r < 2; ++r)
    for (int f = 0; f < K13_N_FORMS; ++f)
      out[r * K13_N_FORMS + f] = (int)g_forms[r][f];
  return 0;
}

// cudaFuncGetAttributes of the eight instances (16, then 32 taps; then the
// same with RECORD; then GEN, GEN with RECORD, and the same in the GLOBAL
// form): registers per thread, static shared bytes per block, local bytes
// per thread and largest block, four ints each, into out; returns the
// first error.
extern "C" int vr_ssr_march_attrs(int* out) {
  const void* kernels[8] = {
      (const void*)ssr_march_kernel<16, false>,
      (const void*)ssr_march_kernel<32, false>,
      (const void*)ssr_march_kernel<16, true>,
      (const void*)ssr_march_kernel<32, true>,
      (const void*)ssr_march_kernel<K13_GEN, false>,
      (const void*)ssr_march_kernel<K13_GEN, true>,
      (const void*)ssr_march_kernel<K13_GEN, false, true>,
      (const void*)ssr_march_kernel<K13_GEN, true, true>};
  cudaError_t first = cudaSuccess;
  for (int k = 0; k < 8; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernels[k]);
    if (first == cudaSuccess) first = err;
    out[4 * k] = a.numRegs;
    out[4 * k + 1] = (int)a.sharedSizeBytes;
    out[4 * k + 2] = (int)a.localSizeBytes;
    out[4 * k + 3] = a.maxThreadsPerBlock;
  }
  return (int)first;
}

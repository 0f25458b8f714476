// K8 integrate: jittered sample of the scatter planes -> front-to-back
// integration, no temporal blend.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/integrate.py
// `_kernel` / `accumulate_fused_pallas`, which walked z in d + 1 sequential
// grid steps with the xy-blended previous plane and the (L, T) carry in VMEM
// scratch. The frame runs it when temporal_blend_accumulation is off; with
// the blend on, integrate_blend.cu integrates the same way and blends in the
// same pass.
//
// Per slice z of a (y, x) column:
//   xyb(z)   = 3-tap clamped xy tent of the 4 scatter planes at the jitter
//              offset (ox, oy); the top slice's upper tap is xyb(d-1) itself;
//   sampled  = xyb(z) + oz * (xyb(z+1) - xyb(z));
//   the per-slice integral (expm1 form, Taylor below od = 1e-2) advances
//   the (L, T) carry, which is the stored value.
//
// Only the carry is sequential: a slice's transmittance t and factor depend
// on its sample alone. So a block owns a tile of 16 x 2 columns (K8Tile:
// X consecutive columns in Y consecutive rows; integrate_blend.cu's tile
// without the warp and the blend) and takes their d slices K8Tile::ZC at a
// time in three phases:
//   1. parallel over (slice, column): xy_blend4 into shared memory, each
//      slice's slice_dz once a block; then each slice's sample, t and
//      factor (slice_terms) into a terms buffer;
//   2. the carry, one thread a column in warp 0: L_c += (T * s_c) * factor,
//      then T *= t, in the twin's order, each carry written back over its
//      terms; the carry stays in registers from one chunk to the next;
//   3. the chunk's 4 x ZC x 32 carries stored, a half warp on a tile row.
// The terms are double-buffered: while warp 0 carries chunk c, warps 1-7
// store chunk c - 1 and run phase 1 of chunk c + 1 into the other buffer
// (their own barrier between its two steps), so the serial chain runs
// behind the next chunk's loads and one block barrier a chunk remains. A
// thread per column, the first form, marched all d slices alone in
// 64-thread blocks (32,400 columns: ~12% of the card's thread slots),
// computed slice_dz's two exps and divisions for every column, and each
// slice waited on its own 36 loads. Every per-froxel float operation is that
// form's, in its order, so the result is bit for bit that form's and its
// twin's (ops/integrate.accumulate_plain, within CHECKS).
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/integrate.k8_form):
// the narrow form indexes the [4, D, H, W] planes in 32 bits and takes
// every table whose planes hold under 2^31 floats (k8_narrow_fits). Past
// that the wide form, the same kernel on int64_t indices (the plane
// strides and every froxel offset of xy_blend4 and chunk_store). The tiles
// run along a 1-D grid and the slices are a loop of each block, so neither
// form has a slice limit and the wide form is one launch; it gives the
// narrow one's values bit for bit.
//
// Bound on the H100: bytes. Read the scatter planes and write the
// accumulation, 2 x 66 MB at 240x135x128, ~40 us at 3.35 TB/s; the work is
// ~100 flops per froxel, ~6 us. What is left is the xy blend's 36 loads a
// froxel through L1 (each scatter value read 9 times; two rows a tile
// share half of their taps' rows, which one row a tile did not), about a
// quarter of the time, and the latency between the barriers. A tile of
// one row, 32 columns, 8-slice chunks in 128-thread blocks, staging the
// rows with cp.async, more blocks an SM (spills) and the phases in turn
// without the double buffer each ran slower on the whole grid or at the
// demo grid (PERF.md §6).
#include <climits>

#include "common.cuh"

// The tile and its chunks: a block of THREADS threads owns the X x Y
// columns (x, y) of X consecutive columns in Y consecutive rows, C of them
// (C divides 32), and takes their slices ZC at a time, MIN_BLOCKS blocks
// an SM (the launch bounds); warp 0 carries, the other warps (PRODUCERS
// threads) store and compute the terms. Mirrored by
// ops/integrate.k8_geometry.
struct K8Tile {
  static constexpr int X = 16, Y = 2, ZC = 16, THREADS = 256,
                       MIN_BLOCKS = 4;
  static constexpr int C = X * Y, PRODUCERS = THREADS - 32;
  static constexpr int TERMS = 5 * ZC * C;  // s_r, s_g, s_b, factor, t
};

// Dynamic shared memory, floats: two terms buffers [5][ZC][C] (the sample's
// r, g, b, then the factor and t; the carry writes L_r, L_g, L_b over the
// sample and T over t), the xy blend [4][ZC + 1][C] and slice_dz [ZC].
__host__ __device__ __forceinline__ int k8_shared_floats() {
  return 2 * K8Tile::TERMS + 4 * (K8Tile::ZC + 1) * K8Tile::C + K8Tile::ZC;
}

// The barrier of warps 1-7 alone (named barrier 1): warp 0 carries
// meanwhile.
__device__ __forceinline__ void producers_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(K8Tile::PRODUCERS) : "memory");
}

// Phase 1 of the chunk of nz slices from z0, by NP threads (p the thread's
// rank among them; its tile column p % C at row y, column xs): the xy
// blend of slices z0 .. z0 + nz (past the top: slice d - 1 itself) into
// xyb, each slice's thickness into dz_s; bar(), the barrier of the NP
// threads; then each slice's sample and its terms into tb.
template <int NP, class Bar, class I>
__device__ __forceinline__ void chunk_terms(
    const VrTables& T, const float* __restrict__ sc, I n, int y, int xs,
    int p, int z0, int nz, float* xyb, float* dz_s, float* tb,
    const Bar& bar) {
  constexpr int C = K8Tile::C, ZC = K8Tile::ZC, PASS = NP / C;
  const int w = T.w, h = T.h, d = T.d, lc = p % C;
  const float* ap = T.abpar;
  float wts[6];
  xy_blend_weights(ap[24], ap[25], wts);
  for (int k = p / C; k <= nz; k += PASS) {
    float v[4];
    xy_blend4(sc, n, min(z0 + k, d - 1), y, xs, w, h, wts, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) xyb[(c * (ZC + 1) + k) * C + lc] = v[c];
  }
  if (p < nz) dz_s[p] = slice_dz(logf(ap[14]), ap[15], ap[16], z0 + p, d);
  bar();
  const float oz = ap[26];
  for (int k = p / C; k < nz; k += PASS) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float lo = xyb[(c * (ZC + 1) + k) * C + lc];
      s[c] = lo + oz * (xyb[(c * (ZC + 1) + k + 1) * C + lc] - lo);
    }
    slice_terms(dz_s[k], s[3], tb[(4 * ZC + k) * C + lc],
                tb[(3 * ZC + k) * C + lc]);
#pragma unroll
    for (int c = 0; c < 3; ++c) tb[(c * ZC + k) * C + lc] = s[c];
  }
}

// Phase 3: the carries (L_r, L_g, L_b, T) of the chunk of nz slices from
// z0 in tb, stored by NP threads from rank p, a row of X columns at a time,
// of the tile at (xt, yt); I the index type of the planes (n floats each).
template <class I>
__device__ __forceinline__ void chunk_store(const float* tb,
                                            float* __restrict__ out, I n,
                                            int w, int h, int xt, int yt,
                                            int z0, int nz, int p, int np) {
  constexpr int X = K8Tile::X, C = K8Tile::C, ZC = K8Tile::ZC;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* src = tb + (c == 3 ? 4 : c) * ZC * C;
    for (int r = p; r < nz * C; r += np) {
      const int k = r / C, lc = r - k * C;
      const int x = xt + lc % X, y = yt + lc / X;
      if (x < w && y < h)
        out[c * n + ((I)(z0 + k) * h + y) * w + x] = src[r];
    }
  }
}

template <class I = int>
__global__ void __launch_bounds__(K8Tile::THREADS, K8Tile::MIN_BLOCKS)
integrate_kernel(VrTables T, const float* __restrict__ sc,
                 float* __restrict__ out_acc) {
  constexpr int X = K8Tile::X, Y = K8Tile::Y, C = K8Tile::C;
  constexpr int ZC = K8Tile::ZC, NT = K8Tile::THREADS;
  constexpr int TERMS = K8Tile::TERMS;
  extern __shared__ float dyn_s[];  // k8_shared_floats
  float* const terms = dyn_s;                  // [2][TERMS]
  float* const xyb = dyn_s + 2 * TERMS;        // [4][ZC + 1][C]
  float* const dz_s = xyb + 4 * (ZC + 1) * C;  // [ZC]
  const int w = T.w, h = T.h, d = T.d;
  const int tiles = (w + X - 1) / X;  // a row of tiles
  const int by = blockIdx.x / tiles;
  const int xt = (blockIdx.x - by * tiles) * X, yt = by * Y;
  const int tid = threadIdx.x, lc = tid % C;
  // past the grid's edge: a copy of its last column or row
  const int xs = min(xt + lc % X, w - 1), y = min(yt + lc / X, h - 1);
  const I n = (I)d * h * w;
  const int chunks = (d + ZC - 1) / ZC;

  // chunk 0's terms, by every thread
  chunk_terms<NT>(T, sc, n, y, xs, tid, 0, min(ZC, d), xyb, dz_s, terms,
                  [] { __syncthreads(); });
  __syncthreads();
  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f, Tc = 1.0f;  // the carry
  for (int c = 0; c < chunks; ++c) {
    const int z0 = c * ZC, nz = min(ZC, d - z0);
    float* const tb = terms + (c & 1) * TERMS;
    if (tid < 32) {
      // 2. chunk c's carry
      if (tid < C) {
        for (int k = 0; k < nz; ++k) {
          float* const e = tb + k * C + lc;
          const float tc = Tc;
          const float f = e[3 * ZC * C];
          Lr = Lr + tc * e[0] * f;
          Lg = Lg + tc * e[ZC * C] * f;
          Lb = Lb + tc * e[2 * ZC * C] * f;
          e[0] = Lr;
          e[ZC * C] = Lg;
          e[2 * ZC * C] = Lb;
          Tc = tc * e[4 * ZC * C];
          e[4 * ZC * C] = Tc;
        }
      }
    } else {
      // 3. chunk c - 1's carries out of the other buffer, then 1. chunk
      // c + 1's terms into it (chunk_terms' barrier orders the two)
      float* const ob = terms + ((c + 1) & 1) * TERMS;
      const int p = tid - 32;
      if (c > 0)
        chunk_store(ob, out_acc, n, w, h, xt, yt, z0 - ZC, ZC, p,
                    K8Tile::PRODUCERS);
      if (c + 1 < chunks)
        chunk_terms<K8Tile::PRODUCERS>(T, sc, n, y, xs, p, z0 + ZC,
                                       min(ZC, d - z0 - ZC), xyb, dz_s, ob,
                                       [] { producers_barrier(); });
    }
    __syncthreads();
  }
  // 3. the last chunk's carries, by every thread
  const int z0 = (chunks - 1) * ZC;
  chunk_store(terms + ((chunks - 1) & 1) * TERMS, out_acc, n, w, h, xt, yt,
              z0, d - z0, tid, NT);
}

// Launches of the narrow (0) and wide (1) forms since the library was
// loaded (vr_integrate_index_forms).
static long g_index_forms[2];

// The tiles of the 1-D launch grid.
static long k8_blocks(const VrTables& T) {
  return (long)((T.w + K8Tile::X - 1) / K8Tile::X)
         * ((T.h + K8Tile::Y - 1) / K8Tile::Y);
}

// Whether the wide form takes the table (mirrored by
// ops/integrate.k8_form): a launch grid of at most 2^31 - 1 tiles.
static bool k8_wide_fits(const VrTables& T) {
  return k8_blocks(T) <= INT_MAX;
}

// Whether the narrow form takes it: the [4, D, H, W] planes under 2^31
// floats (and so the grid too).
static bool k8_narrow_fits(const VrTables& T) {
  return !past_int(4, (long)T.w * T.h * T.d) && k8_wide_fits(T);
}

static int k8_form(const VrTables& T) {
  if (k8_narrow_fits(T)) return VR_FORM_NARROW;
  return k8_wide_fits(T) ? VR_FORM_WIDE : -1;
}

template <class I>
static int launch_form(const VrTables* T, const float* sc, float* out_acc,
                       cudaStream_t stream) {
  const auto kernel = integrate_kernel<I>;
  const int shared = k8_shared_floats() * (int)sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)k8_blocks(*T), K8Tile::THREADS, shared, stream>>>(
      *T, sc, out_acc);
  ++g_index_forms[sizeof(I) > sizeof(int)];
  return 0;
}

// form: VR_FORM_RULE (the size rule's, k8_form), or the narrow or the wide
// form, refused where it does not take the table.
extern "C" int vr_integrate_form(const VrTables* T, const float* sc,
                                 float* out_acc, int form,
                                 cudaStream_t stream) {
  if (form == VR_FORM_RULE) form = k8_form(*T);
  const bool fits = form == VR_FORM_NARROW ? k8_narrow_fits(*T)
                    : form == VR_FORM_WIDE ? k8_wide_fits(*T)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  const int err = form == VR_FORM_WIDE
                      ? launch_form<int64_t>(T, sc, out_acc, stream)
                      : launch_form<int>(T, sc, out_acc, stream);
  return err ? err : (int)cudaGetLastError();
}

// The size rule's form for the table into out[0] (-1: past the wide form
// too) and its launch's parts into out[1] (one: a 1-D grid).
extern "C" int vr_integrate_form_of(const VrTables* T, int* out) {
  out[0] = k8_form(*T);
  out[1] = 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_integrate_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The tile's columns and rows, slices per chunk, threads and dynamic
// shared bytes into out[0..4].
extern "C" int vr_integrate_geometry(int* out) {
  out[0] = K8Tile::X;
  out[1] = K8Tile::Y;
  out[2] = K8Tile::ZC;
  out[3] = K8Tile::THREADS;
  out[4] = k8_shared_floats() * (int)sizeof(float);
  return 0;
}

// cudaFuncGetAttributes of the narrow then the wide kernel: registers per
// thread, static shared bytes per block, local bytes per thread and
// largest block into out[4 i .. 4 i + 3]; returns the error.
template <class I>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)integrate_kernel<I>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_integrate_attrs(int* out) {
  const cudaError_t errs[2] = {attrs_of<int>(out),
                               attrs_of<int64_t>(out + 4)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

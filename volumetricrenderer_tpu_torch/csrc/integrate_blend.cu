// K3 integrate_blend: jittered xy sample -> front-to-back integration ->
// accumulation temporal blend.
//
// Replaces the integrate and accumulation-blend stages of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 281-324 and 365-388, with integrate.make_xy_blend and
// temporal._reproj_offsets/_tent_pass inlined), and the standalone TPU
// kernel that computes the same four planes for the staged frame
// (volumetricrenderer_tpu/ops/pallas/integrate_blend.py `_kernel` /
// `integrate_blend_fused`). The TPU carried (L, T) from one sequential grid
// step to the next in VMEM scratch.
//
// Per slice z of a (y, x) column:
//   xyb(z)   = 3-tap clamped xy tent of the 4 scatter planes at the jitter
//              offset (ox, oy); the top slice's upper tap is xyb(d-1) itself;
//   sampled  = xyb(z) + oz * (xyb(z+1) - xyb(z));
//   the per-slice integral (expm1 form, Taylor below od = 1e-2) advances
//   the (L, T) carry; then the alpha-mode blend against the previous
//   accumulation (8-tap warp, offsets unjittered with eps = 0, weight
//   alpha * (warped T != 0)) gives the stored value. The carry continues
//   with the un-blended values.
//
// Only the carry is sequential: a slice's transmittance t and factor depend
// on its sample alone, and the warp and the blend need the carry only at
// the final lerp. So a block owns a tile of K3_TX consecutive columns of
// one row and takes its d slices K3_ZC at a time in three phases:
//   1. parallel over (slice, column): xy_blend4 into shared memory, then
//      each slice's sample, t and factor (slice_terms, the first form's
//      operations in its order);
//   2. serial over the chunk's slices, one thread per column, half a warp:
//      L_c += (T * s_c) * factor, T *= t, from shared memory, each
//      un-blended carry written back per slice; the carry stays in the
//      thread's registers from one chunk to the next. The other seven warps
//      meanwhile compute the reprojection offsets the warp reads, each
//      once: per slice and column cx of the tile and the k + 1 beyond each
//      side, the offsets at (z, y, cx) and the z offsets at the two rows
//      the y taps of cx read -- where the first form recomputed 7
//      reprojections per froxel, 3 of 25/16 columns' worth here, with
//      reproj_vy of the rows once per slice;
//   3. parallel over (slice, column): warp8_by<4> from those offsets and
//      the alpha blend, written to out_acc (a half warp writes a tile row).
// Every per-froxel float operation is the one-thread-per-column form's,
// in its order, so the result is bit for bit that form's and its twin's
// (ops/frame_fused.integrate_blend_plain, within CHECKS).
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/frame_fused.k3_form):
// the narrow form indexes the [4, D, H, W] planes in 32 bits and puts a
// row on each launch-grid y index (k3_narrow_fits: the planes under 2^31
// floats, at most VR_MAX_GRID_Z rows). Past that the wide form, the same
// kernel on int64_t indices, launched in parts of at most VR_MAX_GRID_Z
// rows (the block's row is blockIdx.y + y0). A column's outputs depend on
// the scatter and the history, which K3 only reads, so the parts are
// independent, and the wide form gives the narrow one's values bit for
// bit. The slices are a loop of each block: their count limits neither.
//
// Bound on the H100: bytes. Read the scatter planes (66 MB) and the previous
// accumulation (66 MB), write the new accumulation (66 MB) at FULL: ~200 MB,
// ~60 us at 3.35 TB/s. The first form gave each column one thread that
// marched all 128 slices in 64-thread blocks: ~12% of the card's thread
// slots at the full grid, each slice waiting on its 36 scatter loads and
// its 7 reprojections, so a slab's 13,680 columns took as long as the
// whole grid's 32,400. This one is bound by latency between its barriers
// at 64 registers a thread (4 blocks an SM): on the H100, with the warp,
// the offsets and the xy blend cut out, the same phases still take ~1.7x
// the bound (tools/k3_k4_against.py; PERF.md).
//
// Region forms (common.cuh VR_REGION_*; mirrored by
// ops/frame_fused.k3_window_form): a chunk's offsets (k3_shared) no longer
// fit a block's shared memory beside the static arrays from a window of
// k = 159. Past that the launcher takes the region_global instantiation
// (OG, wide index form only): common.cuh fill_region_plane first writes
// the offsets of every froxel into a [4, D, H, W] plane on the
// accumulation's blend table (unjittered), and phase 3's warp reads them
// there at its taps: the x and y offsets at (z, y, cx) and the z offset at
// (z, cy, cx), where the shared form stages the same values per chunk
// (phase 2's offsets are reproj_view at those cells, from the same device
// functions). Phases 1-3, K3_ZC and the static arrays stay; phase 2's
// warps 1-7 then have no offsets to compute.
#include "common.cuh"

#define K3_TX 16                        // columns of a tile (one row)
#define K3_ZC 32                        // slices per chunk
#define K3_THREADS 256
#define K3_ZP (K3_THREADS / K3_TX)      // slices per pass of phases 1 and 3

// The columns whose reprojection offsets a tile's warp reads: its own and
// the k + 1 beyond each side (its taps reach x - k .. x + k + 1); the rows
// whose view-space y the offsets read: y - k .. y + k + 1.
__host__ __device__ __forceinline__ int k3_nx(int k) {
  return K3_TX + 2 * k + 1;
}

__host__ __device__ __forceinline__ int k3_ny(int k) { return 2 * k + 2; }

// Dynamic shared memory, floats: per slice of a chunk the x, y and the two
// z offsets of each of the k3_nx columns, then reproj_vy of the k3_ny rows.
__host__ __device__ __forceinline__ int k3_shared(int k) {
  return K3_ZC * (4 * k3_nx(k) + k3_ny(k));
}

// The kernel's static shared bytes: xyb, lrgb, fac, tr, tcar, vzc_s and
// dz_s (mirrored by ops/frame_fused.K3_STATIC_SHARED).
#define K3_STATIC_BYTES \
  (4 * (4 * (K3_ZC + 1) * K3_TX + 6 * K3_ZC * K3_TX + 2 * K3_ZC))

// OG: the region_global form, the offsets read from off_g [4, D, H, W]
// (common.cuh fill_region_plane on abpar).
template <class I = int, bool OG = false>
__global__ void __launch_bounds__(K3_THREADS, 4)
integrate_blend_kernel(VrTables T, const float* __restrict__ sc,
                       const float* __restrict__ prev_acc,
                       float* __restrict__ out_acc, int y_part,
                       const float* __restrict__ off_g) {
  // xyb row k is slice z0 + k; row 0 is the previous chunk's row K3_ZC
  __shared__ float xyb[4][K3_ZC + 1][K3_TX];
  __shared__ float lrgb[3][K3_ZC][K3_TX];  // sampled r, g, b, then L
  __shared__ float fac[K3_ZC][K3_TX];      // the slice's factor
  __shared__ float tr[K3_ZC][K3_TX];       // the slice's transmittance
  __shared__ float tcar[K3_ZC][K3_TX];     // T after the slice
  __shared__ float vzc_s[K3_ZC];           // view_z of the slice's centre
  __shared__ float dz_s[K3_ZC];            // slice_dz
  extern __shared__ float dyn_s[];         // k3_shared

  const int w = T.w, h = T.h, d = T.d, kw = T.k;
  const int nx = k3_nx(kw), ny = k3_ny(kw), plane = K3_ZC * nx;
  float* off_s = dyn_s;               // [4][K3_ZC][nx]: ox, oy, oz b=0, 1
  float* vy_s = dyn_s + 4 * plane;    // [K3_ZC][ny]
  const int lx = threadIdx.x % K3_TX, lz = threadIdx.x / K3_TX;
  // the narrow form's row is blockIdx.y; the wide form's part starts at
  // y_part
  const int y0 = sizeof(I) > sizeof(int) ? y_part : 0;
  const int xt = blockIdx.x * K3_TX, y = blockIdx.y + y0;
  const int x = xt + lx;
  const int xs = min(x, w - 1);  // past the row's end: a copy of its last
  const I n = (I)d * h * w;
  const float* ap = T.abpar;  // scalars are read where used: fewer live
  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f, Tc = 1.0f;  // phase 2's carry

  for (int z0 = 0; z0 < d; z0 += K3_ZC) {
    const int nz = min(K3_ZC, d - z0);
    // 1. the xy blend of slices z0 + 1 .. z0 + nz (past the top: slice
    // d - 1 itself; slice 0 too in the first chunk) and each slice's
    // depths; then each slice's sample and terms, and the view-space y of
    // the rows the offsets read
    float wts[6];
    xy_blend_weights(ap[24], ap[25], wts);
    for (int k = lz + (z0 > 0); k <= nz; k += K3_ZP) {
      float v[4];
      xy_blend4(sc, n, min(z0 + k, d - 1), y, xs, w, h, wts, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) xyb[c][k][lx] = v[c];
    }
    if (threadIdx.x < nz) {
      const int z = z0 + threadIdx.x;
      vzc_s[threadIdx.x] = view_z(ap, (float)z + 0.5f, d);
      dz_s[threadIdx.x] = slice_dz(logf(ap[14]), ap[15], ap[16], z, d);
    }
    __syncthreads();
    const float oz = ap[26];
    for (int k = lz; k < nz; k += K3_ZP) {
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[c] = xyb[c][k][lx] + oz * (xyb[c][k + 1][lx] - xyb[c][k][lx]);
      slice_terms(dz_s[k], s[3], tr[k][lx], fac[k][lx]);
#pragma unroll
      for (int c = 0; c < 3; ++c) lrgb[c][k][lx] = s[c];
    }
    if constexpr (!OG) {
      for (int i = threadIdx.x; i < nz * ny; i += K3_THREADS) {
        const int k = i / ny, j = i - k * ny;
        vy_s[i] = reproj_vy(ap, clampi(y - kw + j, 0, h - 1), vzc_s[k],
                            T.h_glob);
      }
    }
    __syncthreads();
    // 2. the carry, L_c += (T * s_c) * factor, T *= t, one thread a column in
    // warp 0, whose other half moves the chunk's last xy blend to row 0 for
    // the next chunk's lerp; warps 1-7 compute the offsets the warp reads,
    // each once where the warp of a froxel recomputed its own seven: per
    // slice and column cx those at (z, y, cx), then the z offsets at both
    // rows cy that the y taps of cx read
    if (threadIdx.x < 32) {
      if (lz == 0) {
        for (int k = 0; k < nz; ++k) {
          const float tc = Tc;
          const float f = fac[k][lx];
          Lr = Lr + tc * lrgb[0][k][lx] * f;
          Lg = Lg + tc * lrgb[1][k][lx] * f;
          Lb = Lb + tc * lrgb[2][k][lx] * f;
          lrgb[0][k][lx] = Lr;
          lrgb[1][k][lx] = Lg;
          lrgb[2][k][lx] = Lb;
          Tc = tc * tr[k][lx];
          tcar[k][lx] = Tc;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) xyb[c][0][lx] = xyb[c][nz][lx];
      }
    } else if constexpr (!OG) {
#pragma unroll 2
      for (int i = threadIdx.x - 32; i < nz * nx; i += K3_THREADS - 32) {
        const int k = i / nx, j = i - k * nx;
        const int z = z0 + k, cx = clampi(xt - kw + j, 0, w - 1);
        const float vzc = vzc_s[k];
        const float vx = reproj_vx(ap, cx, vzc, w);
        const float* vyk = vy_s + k * ny;
        const Reproj r = reproj_view(ap, z, y, cx, vx, vyk[kw], vzc, w, h, d,
                                     T.h_glob, kw, false);
        off_s[i] = r.ox;
        off_s[plane + i] = r.oy;
        const int y0 = (int)floorf(r.oy);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int cy = clampi(y + y0 + b, 0, h - 1);
          off_s[(2 + b) * plane + i] =
              reproj_view(ap, z, cy, cx, vx, vyk[cy - y + kw], vzc, w, h, d,
                          T.h_glob, kw, false).oz;
        }
      }
    }
    __syncthreads();
    // 3. the accumulation blend (alpha mode: success = warped T != 0), the
    // warp's offsets from phase 2 (OG: from off_g)
    if constexpr (OG) {
#pragma unroll 2
      for (int k = lz; k < nz && x < w; k += K3_ZP) {
        const int z = z0 + k;
        const I row = ((I)z * h + y) * w;  // + cx: column cx of row y
        const auto oy_at = [&](int cx) {
          return __ldg(off_g + (n + row + cx));
        };
        const auto oz_at = [&](int, int cy, int cx) {
          return __ldg(off_g + (2 * n + ((I)z * h + cy) * w + cx));
        };
        float warped[4];
        warp8_by<4>(prev_acc, n, z, y, x, w, h, d, __ldg(off_g + (row + x)),
                    oy_at, oz_at, warped);
        const float wgt = ap[20] * (warped[3] != 0.0f ? 1.0f : 0.0f);
        const float carry[4] = {lrgb[0][k][lx], lrgb[1][k][lx],
                                lrgb[2][k][lx], tcar[k][lx]};
        const I o = row + x;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out_acc[c * n + o] = carry[c] + wgt * (warped[c] - carry[c]);
      }
    } else {
#pragma unroll 2
      for (int k = lz; k < nz && x < w; k += K3_ZP) {
        const int z = z0 + k;
        const int ib = k * nx - (xt - kw);  // + cx: column cx of slice k
        const auto oy_at = [&](int cx) { return off_s[plane + ib + cx]; };
        const auto oz_at = [&](int b, int, int cx) {
          return off_s[(2 + b) * plane + ib + cx];
        };
        float warped[4];
        warp8_by<4>(prev_acc, n, z, y, x, w, h, d, off_s[ib + x], oy_at,
                    oz_at, warped);
        const float wgt = ap[20] * (warped[3] != 0.0f ? 1.0f : 0.0f);
        const float carry[4] = {lrgb[0][k][lx], lrgb[1][k][lx],
                                lrgb[2][k][lx], tcar[k][lx]};
        const I o = ((I)z * h + y) * w + x;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out_acc[c * n + o] = carry[c] + wgt * (warped[c] - carry[c]);
      }
    }
    __syncthreads();
  }
}

// Launches of the narrow (0) and wide (1) forms, and of the region_shared
// (0) and region_global (1) forms and the latter's pre-pass (2), since the
// library was loaded (vr_integrate_blend_index_forms,
// vr_integrate_blend_region_forms). A region_global launch is also a wide
// one.
static long g_index_forms[2];
static long g_region_forms[3];

// The region form a launch at reprojection window k takes (VR_REGION_*):
// region_shared where a chunk's offsets fit beside the static arrays.
static int k3_region_form(int k) {
  return region_form_of(k3_shared(k) * (long)sizeof(float),
                        K3_STATIC_BYTES);
}

// Whether the wide form takes the table (mirrored by
// ops/frame_fused.k3_form): a launch grid of at most 2^31 - 1 column tiles.
static bool k3_wide_fits(const VrTables& T) {
  return (T.w + K3_TX - 1) / K3_TX <= 2147483647L;
}

// Whether the narrow form takes it: the [4, D, H, W] planes under 2^31
// floats, on at most VR_MAX_GRID_Z rows.
static bool k3_narrow_fits(const VrTables& T) {
  return !past_int(4, (long)T.w * T.h * T.d) && T.h <= VR_MAX_GRID_Z;
}

static int k3_form(const VrTables& T) {
  if (k3_narrow_fits(T)) return VR_FORM_NARROW;
  return k3_wide_fits(T) ? VR_FORM_WIDE : -1;
}

template <class I, bool OG = false>
static int launch_form(const VrTables* T, const float* sc,
                       const float* prev_acc, float* out_acc,
                       cudaStream_t stream, const float* off_g = nullptr) {
  const auto kernel = integrate_blend_kernel<I, OG>;
  const int shared = OG ? 0 : k3_shared(T->k) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(  // any reprojection window
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T->w + K3_TX - 1) / K3_TX, T->h);
  if (sizeof(I) == sizeof(int)) {
    kernel<<<grid, K3_THREADS, shared, stream>>>(*T, sc, prev_acc, out_acc,
                                                 0, off_g);
  } else {  // the rows in parts of at most VR_MAX_GRID_Z
    for (int y0 = 0; y0 < T->h; y0 += VR_MAX_GRID_Z) {
      grid.y = min(VR_MAX_GRID_Z, T->h - y0);
      kernel<<<grid, K3_THREADS, shared, stream>>>(*T, sc, prev_acc,
                                                   out_acc, y0, off_g);
    }
  }
  ++g_index_forms[sizeof(I) > sizeof(int)];
  ++g_region_forms[OG];
  return 0;
}

// form: VR_FORM_RULE (the size rule's, k3_form), or the narrow or the wide
// form, refused where it does not take the table.
extern "C" int vr_integrate_blend_form(const VrTables* T, const float* sc,
                                       const float* prev_acc, float* out_acc,
                                       int form, cudaStream_t stream) {
  if (form == VR_FORM_RULE) form = k3_form(*T);
  const bool fits = form == VR_FORM_NARROW ? k3_narrow_fits(*T)
                    : form == VR_FORM_WIDE ? k3_wide_fits(*T)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  const int err =
      form == VR_FORM_WIDE
          ? launch_form<int64_t>(T, sc, prev_acc, out_acc, stream)
          : launch_form<int>(T, sc, prev_acc, out_acc, stream);
  return err ? err : (int)cudaGetLastError();
}

// The region_global form, any reprojection window, in the wide index
// form: the offsets of every froxel into off_g [4, D, H, W] (device
// memory), then the kernel reading them there.
extern "C" int vr_integrate_blend_region(const VrTables* T, const float* sc,
                                         const float* prev_acc,
                                         float* out_acc, float* off_g,
                                         cudaStream_t stream) {
  if (!k3_wide_fits(*T)) return (int)cudaErrorInvalidValue;
  int err = fill_region_plane(T->abpar, false, T->w, T->h, T->d, T->h_glob,
                              T->k, off_g, stream);
  if (err) return err;
  ++g_region_forms[2];
  err = launch_form<int64_t, true>(T, sc, prev_acc, out_acc, stream, off_g);
  return err ? err : (int)cudaGetLastError();
}

// The region form a launch at reprojection window k takes into out[0]
// (VR_REGION_*).
extern "C" int vr_integrate_blend_region_form_of(int k, int* out) {
  out[0] = k3_region_form(k);
  return 0;
}

// The launches of the region_shared and the region_global form and of the
// latter's pre-pass so far into out[0..2].
extern "C" int vr_integrate_blend_region_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_region_forms[f];
  return 0;
}

// The size rule's form for the table into out[0] (-1: past the wide form
// too) and its launch's row parts into out[1].
extern "C" int vr_integrate_blend_form_of(const VrTables* T, int* out) {
  out[0] = k3_form(*T);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(T->h) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_integrate_blend_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// cudaFuncGetAttributes of the narrow, the wide and the region_global
// kernel: registers per thread, static shared bytes per block, local bytes
// per thread and largest block into out[4 i .. 4 i + 3]; returns the
// error.
template <class I, bool OG = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)integrate_blend_kernel<I, OG>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_integrate_blend_attrs(int* out) {
  const cudaError_t errs[3] = {attrs_of<int>(out),
                               attrs_of<int64_t>(out + 4),
                               attrs_of<int64_t, true>(out + 8)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

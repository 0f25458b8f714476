// K10 temporal_blend: reproject, warp the history and blend, in one pass.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/temporal.py
// `_kernel` / `fused_temporal_blend`, which walked z sequentially with the
// history slices in a (2k+2)-deep VMEM ring and ran the three tent passes
// on whole [H, W] planes.
//
// Per froxel (z, y, x) and channel c of NC:
//   out[c] = cur[c] + wgt * (warped prev[c] - cur[c])
//   WEIGHT ("weight", the shadow blend; offsets take the jitter):
//          wgt = alpha * success_xy
//   !WEIGHT ("alpha", the accumulation blend; no jitter):
//          wgt = alpha * (warped last channel != 0)
// bpar is a pack_blend_params table [24]. Writes a new buffer: the warp
// reads neighbours of the history.
//
// On the GPU a block owns a 16 x 16 tile of one slice (K10Tile), K5's tile
// (shadow_blend.cu) without the sun rays: the slice's view depth and
// log(fpz) once a block, then region_offsets (below; K5's common.cuh
// tile_region steps) computes reproj_vx / reproj_vy of the region's
// columns and rows and each reprojection offset of the region the warp's
// taps reach once, into shared memory (~2.4 reprojections a froxel, where
// a thread per froxel evaluated 7: its own and those at the 6 neighbour
// columns the passes read, each a log, an exp and several divisions).
// Each froxel then runs warp8_by<NC> from shared memory (the three passes
// collapsed to 8 taps, summed in the passes' order) and the blend. K5
// computes the same values on the same table, so K7 (dir_shadow.cu) then
// this kernel's weight mode gives K5's volume bit for bit; and
// integrate_blend.cu's warp reads the same reproj_view values, so K8
// (integrate.cu) then the alpha mode gives K3's. Every value is the
// thread-per-froxel form's, from the same operations in the same order.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/temporal.k10_form):
// the narrow form indexes in 32 bits and puts a slice on each launch-grid
// z index; it takes every launch whose [NC, D, H, W] volumes hold under
// 2^31 floats, on at most VR_MAX_GRID_Z slices. Past that the wide form
// (I = int64_t): every froxel and channel index in 64 bits, the slices
// launched in parts of at most VR_MAX_GRID_Z (the block's slice is
// blockIdx.z + z0). A froxel's output depends on its own inputs and on the
// history, which K10 only reads, so the parts are independent and the wide
// form gives the narrow one's values bit for bit. Either form takes at
// most VR_MAX_GRID_Z row tiles on the launch grid's y axis.
//
// Bound on the H100: bytes. Read prev and cur, write out: 3 NC planes of
// 16.6 MB at 240x135x128 -- 0.015 ms for one shadow channel, 0.059 ms for
// the four accumulation channels at 3.35 TB/s. Work: ~2.4 reprojections
// (each a log and 3 divisions, ~40 flops) and 14 multiply-adds a channel,
// ~130 flops a froxel at one channel, ~8 us at the fp32 rate. What holds
// it is the instruction rate of the region's IEEE divisions and logs,
// about 60% of its time (PERF.md §6).
//
// Region forms (common.cuh VR_REGION_*; mirrored by
// ops/temporal.region_form): K5's region no longer fits a block's shared
// memory from a window of k = 52. Past that the launcher takes the
// region_global instantiation (RG, wide index form only): the four offsets
// of every froxel in a [4, D, H, W] plane that common.cuh
// fill_region_plane writes first (once for all of a call's channel
// groups), read there by the warp at its taps; no shared memory, any
// window, every value the shared form's.
#include "common.cuh"

// The tile, columns x rows: a block of X * Y threads, MIN_BLOCKS of them an
// SM (the launch bounds; the tile mirrored by ops/temporal.K10_TILE).
struct K10Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 6;
};

// Steps 1b and 2 of K5's slice tile (common.cuh tile_region) on the blend
// table bp, a copy of that loop (see tile_region), with its slice scalars
// vz_b = view_z(bp, z + 0.5, d) and lfpz_b = logf(bp[14]) in shared memory,
// read there by every thread after a barrier. The block owns the TX x TY
// tile (blockIdx.x, blockIdx.y) of slice z on a grid of w x h x d
// (h_glob the global rows; a slab's y0 is bp[22], as reproj_vy reads it)
// and dyn_s its region_floats:
//   1b. reproj_vx of the region's columns and reproj_vy of its rows;
//   2.  the reprojection offsets, each once, at every (row, column) of the
//       region, into shared memory, and of each only the outputs the warp
//       reads: all four at the tile's own cells, oy and oz in the other
//       columns of its rows, oz alone in the other rows: ~2.4
//       reprojections a froxel where one froxel's own warp took 7.
// Each step ends with a barrier. Every value is the thread-per-froxel
// form's (reproj_view_l at each tap's column and row), from the same
// operations in the same order.
template <int TX, int TY>
__device__ __forceinline__ void region_offsets(
    const float* bp, bool with_jitter, const float& vz_b,
    const float& lfpz_b, int w, int h, int d, int h_glob, int k, int z,
    float* dyn_s) {
  constexpr int NT = TX * TY;
  const int nx = region_nx(TX, k), ny = region_ny(TY, k), nr = nx * ny;
  float* ox_s = dyn_s;
  float* oy_s = dyn_s + nr;
  float* oz_s = dyn_s + 2 * nr;
  float* ok_s = dyn_s + 3 * nr;
  float* rvx_s = dyn_s + 4 * nr;
  float* rvy_s = rvx_s + nx;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;

  // 1b. the region's column and row terms
  for (int j = tid; j < nx + ny; j += NT) {
    if (j < nx) {
      rvx_s[j] = reproj_vx(bp, clampi(xt - k + j, 0, w - 1), vz_b, w);
    } else {
      const int r = j - nx;
      rvy_s[r] = reproj_vy(bp, clampi(yt - k + r, 0, h - 1), vz_b, h_glob);
    }
  }
  __syncthreads();
  // 2. the reprojection at every (row r, column c) of the region, at
  // (clamp(yt - k + r), clamp(xt - k + c)), each output only where the
  // warp reads it
  {
    const int r = ty + k, c = tx + k, j = r * nx + c;
    const Reproj o = reproj_view_l(bp, z, min(yt + ty, h - 1),
                                   min(xt + tx, w - 1), rvx_s[c], rvy_s[r],
                                   vz_b, lfpz_b, w, h, d, h_glob, k,
                                   with_jitter);
    ox_s[j] = o.ox;
    oy_s[j] = o.oy;
    oz_s[j] = o.oz;
    ok_s[j] = o.success;
  }
  const int side = 2 * k + 1;       // the region's columns (rows) past the
  const int n_side = TY * side;     // tile's, k before and k + 1 after it
  for (int j = tid; j < n_side + side * nx; j += NT) {
    if (j < n_side) {
      const int r = j / side, e = j - r * side;
      const int c = e < k ? e : TX + e;
      const Reproj o = reproj_view_l(bp, z, min(yt + r, h - 1),
                                     clampi(xt - k + c, 0, w - 1), rvx_s[c],
                                     rvy_s[r + k], vz_b, lfpz_b, w, h, d,
                                     h_glob, k, with_jitter);
      oy_s[(r + k) * nx + c] = o.oy;
      oz_s[(r + k) * nx + c] = o.oz;
    } else {
      const int q = j - n_side, e = q / nx, c = q - e * nx;
      const int r = e < k ? e : TY + e;
      oz_s[r * nx + c] =
          reproj_view_l(bp, z, clampi(yt - k + r, 0, h - 1),
                        clampi(xt - k + c, 0, w - 1), rvx_s[c], rvy_s[r],
                        vz_b, lfpz_b, w, h, d, h_glob, k, with_jitter).oz;
    }
  }
  __syncthreads();
}

// RG: the region_global form, the offsets read from region_g [4, D, H, W]
// (common.cuh fill_region_plane on the same table).
template <int NC, bool WEIGHT, class I = int, bool RG = false>
__global__ void __launch_bounds__(K10Tile::X * K10Tile::Y,
                                  K10Tile::MIN_BLOCKS)
temporal_blend_kernel(const float* __restrict__ bpar,
                      const float* __restrict__ prev,
                      const float* __restrict__ cur, float* __restrict__ out,
                      int w, int h, int d, int h_glob, int k, int z_part,
                      const float* __restrict__ region_g) {
  constexpr int TX = K10Tile::X, TY = K10Tile::Y;
  __shared__ float vz_s, lfpz_s;    // the slice's scalars
  extern __shared__ float dyn_s[];  // region_floats
  const int tx = threadIdx.x, ty = threadIdx.y;
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  const int z = blockIdx.z + (sizeof(I) > sizeof(int) ? z_part : 0);
  if constexpr (RG) {  // step 3 alone, the offsets from region_g
    const int x = blockIdx.x * TX + tx, y = blockIdx.y * TY + ty;
    if (x >= w || y >= h) return;
    const I n = (I)d * h * w;
    const I i = ((I)z * h + y) * w + x;
    const I row = i - x;  // + cx: column cx of row y
    const auto oy_at = [&](int cx) {
      return __ldg(region_g + (n + row + cx));
    };
    const auto oz_at = [&](int, int cy, int cx) {
      return __ldg(region_g + (2 * n + ((I)z * h + cy) * w + cx));
    };
    float warped[NC];
    warp8_by<NC>(prev, n, z, y, x, w, h, d, __ldg(region_g + i), oy_at,
                 oz_at, warped);
    const float wgt = WEIGHT
        ? bpar[20] * __ldg(region_g + (3 * n + i))
        : bpar[20] * (warped[NC - 1] != 0.0f ? 1.0f : 0.0f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float v = __ldg(cur + c * n + i);
      out[c * n + i] = v + wgt * (warped[c] - v);
    }
    return;
  }
  // 1a. the slice's scalars, on the first lanes of two warps
  if (ty == 0 && tx == 0) vz_s = view_z(bpar, (float)z + 0.5f, d);
  if (ty == 2 && tx == 0) lfpz_s = logf(bpar[14]);
  __syncthreads();
  // 1b, 2. the region's terms and offsets
  region_offsets<TX, TY>(bpar, WEIGHT, vz_s, lfpz_s, w, h, d, h_glob, k, z,
                         dyn_s);
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  const int x = xt + tx, y = yt + ty;
  if (x >= w || y >= h) return;
  const I n = (I)d * h * w;
  const I i = ((I)z * h + y) * w + x;
  // 3. the warp, the offsets at (y, cx) and (cy, cx) from the region,
  // column cx at cx - (xt - k), row cy at cy - (yt - k); then the blend
  const int nx = region_nx(TX, k), nr = nx * region_ny(TY, k);
  const float* ox_s = dyn_s;
  const float* oy_s = dyn_s + nr;
  const float* oz_s = dyn_s + 2 * nr;
  const float* ok_s = dyn_s + 3 * nr;
  const int row_y = (ty + k) * nx + k - xt;
  const auto oy_at = [&](int cx) { return oy_s[row_y + cx]; };
  const auto oz_at = [&](int, int cy, int cx) {
    return oz_s[(cy - yt + k) * nx + k - xt + cx];
  };
  float warped[NC];
  warp8_by<NC>(prev, n, z, y, x, w, h, d, ox_s[row_y + x], oy_at, oz_at,
               warped);
  const float wgt = WEIGHT
      ? bpar[20] * ok_s[row_y + x]
      : bpar[20] * (warped[NC - 1] != 0.0f ? 1.0f : 0.0f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float v = __ldg(cur + c * n + i);
    out[c * n + i] = v + wgt * (warped[c] - v);
  }
}

// Launches of the narrow (0) and wide (1) index forms, and of the
// region_shared (0) and region_global (1) forms and the latter's pre-pass
// (2), since the library was loaded (vr_temporal_blend_index_forms,
// vr_temporal_blend_region_forms). A region_global launch is also a wide
// one.
static long g_index_forms[2];
static long g_region_forms[3];

// Whether the wide form takes a launch (mirrored by ops/temporal.k10_form):
// at most VR_MAX_GRID_Z row tiles on the launch grid's y axis.
static bool k10_wide_fits(int h) {
  return (h + K10Tile::Y - 1) / K10Tile::Y <= VR_MAX_GRID_Z;
}

// Whether the narrow form takes it: what the wide form takes, with the
// [n_ch, D, H, W] volumes under 2^31 floats on at most VR_MAX_GRID_Z slices.
static bool k10_narrow_fits(int n_ch, int w, int h, int d) {
  return k10_wide_fits(h) && !past_int(n_ch, (long)w * h * d)
         && d <= VR_MAX_GRID_Z;
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k10_form(int n_ch, int w, int h, int d) {
  if (k10_narrow_fits(n_ch, w, h, d)) return VR_FORM_NARROW;
  return k10_wide_fits(h) ? VR_FORM_WIDE : -1;
}

// The region form a launch at reprojection window k takes
// (VR_REGION_*): region_shared where its region fits beside the slice
// scalars (under VR_TILE_STATIC).
static int k10_region_form(int k) {
  return region_form_of(
      region_floats(K10Tile::X, K10Tile::Y, k) * (long)sizeof(float),
      VR_TILE_STATIC);
}

template <int NC, bool WEIGHT, class I, bool RG = false>
static int launch_tile(const float* bpar, const float* prev,
                       const float* cur, float* out, int w, int h, int d,
                       int h_glob, int k, cudaStream_t stream,
                       const float* region_g = nullptr) {
  constexpr int TX = K10Tile::X, TY = K10Tile::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel = temporal_blend_kernel<NC, WEIGHT, I, RG>;
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, d);
  const int shared =
      RG ? 0 : region_floats(TX, TY, k) * (int)sizeof(float);
  if (shared > 48 * 1024) {  // a wide reprojection window
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY), shared, stream>>>(bpar, prev, cur, out, w,
                                                   h, d, h_glob, k, 0,
                                                   region_g);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, d - z0);
      kernel<<<grid, dim3(TX, TY), shared, stream>>>(bpar, prev, cur, out,
                                                     w, h, d, h_glob, k, z0,
                                                     region_g);
    }
  }
  ++g_index_forms[WIDE];
  ++g_region_forms[RG];
  return 0;
}

// The blend of n_ch channels (1 to 4) in mode 0 "weight" or 1 "alpha"; RG:
// the region_global form, its offsets in region_g.
template <class I, bool RG = false>
static int launch_mode(const float* bpar, const float* prev,
                       const float* cur, float* out, int n_ch, int w, int h,
                       int d, int h_glob, int k, int mode,
                       cudaStream_t stream, const float* region_g = nullptr) {
  switch (2 * n_ch + mode) {
#define VR_BLEND(NC)                                                        \
    case 2 * NC:                                                            \
      return launch_tile<NC, true, I, RG>(bpar, prev, cur, out, w, h, d,    \
                                          h_glob, k, stream, region_g);     \
    case 2 * NC + 1:                                                        \
      return launch_tile<NC, false, I, RG>(bpar, prev, cur, out, w, h, d,   \
                                           h_glob, k, stream, region_g);
    VR_BLEND(1)
    VR_BLEND(2)
    VR_BLEND(3)
    VR_BLEND(4)
#undef VR_BLEND
  }
  return (int)cudaErrorInvalidValue;
}

// mode 0 "weight", 1 "alpha"; n_ch 1 to 4. form: VR_FORM_RULE (the size
// rule's, k10_form), or the narrow or the wide form, refused where it does
// not take the launch.
extern "C" int vr_temporal_blend_form(const float* bpar, const float* prev,
                                      const float* cur, float* out, int n_ch,
                                      int w, int h, int d, int h_glob, int k,
                                      int mode, int form,
                                      cudaStream_t stream) {
  if (n_ch < 1 || n_ch > 4 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  if (form == VR_FORM_RULE) form = k10_form(n_ch, w, h, d);
  const bool fits = form == VR_FORM_NARROW ? k10_narrow_fits(n_ch, w, h, d)
                    : form == VR_FORM_WIDE ? k10_wide_fits(h)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  const int err =
      form == VR_FORM_WIDE
          ? launch_mode<int64_t>(bpar, prev, cur, out, n_ch, w, h, d, h_glob,
                                 k, mode, stream)
          : launch_mode<int>(bpar, prev, cur, out, n_ch, w, h, d, h_glob, k,
                             mode, stream);
  return err ? err : (int)cudaGetLastError();
}

// The region_global form, any reprojection window, in the wide index
// form: with fill, first the four offsets of every froxel into region_g
// [4, D, H, W] (device memory; the weight mode's with the jitter), then
// the blend of n_ch channels reading them there. A call's channel groups
// share one plane: the first fills it.
extern "C" int vr_temporal_blend_region(const float* bpar, const float* prev,
                                        const float* cur, float* out,
                                        float* region_g, int fill, int n_ch,
                                        int w, int h, int d, int h_glob,
                                        int k, int mode,
                                        cudaStream_t stream) {
  if (n_ch < 1 || n_ch > 4 || mode < 0 || mode > 1 || !k10_wide_fits(h)
      || region_g == nullptr)
    return (int)cudaErrorInvalidValue;
  if (fill) {
    const int err = fill_region_plane(bpar, mode == 0, w, h, d, h_glob, k,
                                      region_g, stream);
    if (err) return err;
    ++g_region_forms[2];
  }
  const int err = launch_mode<int64_t, true>(bpar, prev, cur, out, n_ch, w,
                                             h, d, h_glob, k, mode, stream,
                                             region_g);
  return err ? err : (int)cudaGetLastError();
}

// The region form a launch at reprojection window k takes into out[0]
// (VR_REGION_*).
extern "C" int vr_temporal_blend_region_form_of(int k, int* out) {
  out[0] = k10_region_form(k);
  return 0;
}

// The launches of the region_shared and the region_global form and of the
// latter's pre-pass so far into out[0..2].
extern "C" int vr_temporal_blend_region_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_region_forms[f];
  return 0;
}

// The size rule's form for a launch of n_ch channels into out[0] (-1: past
// the wide form too) and its launch's slice parts into out[1].
extern "C" int vr_temporal_blend_form_of(int n_ch, int w, int h, int d,
                                         int* out) {
  out[0] = k10_form(n_ch, w, h, d);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_temporal_blend_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The tile (columns, rows) into out[0..1] and the dynamic shared bytes of a
// launch at reprojection window k into out[2].
extern "C" int vr_temporal_blend_geometry(int k, int* out) {
  out[0] = K10Tile::X;
  out[1] = K10Tile::Y;
  out[2] = region_floats(K10Tile::X, K10Tile::Y, k) * (int)sizeof(float);
  return 0;
}

// cudaFuncGetAttributes of the weight mode at one channel and the alpha
// mode at four (the shadow and the accumulation blends), narrow, then the
// same two wide, then the same two region_global: registers per thread,
// static shared bytes per block, local bytes per thread and largest block
// into out[4 i .. 4 i + 3]; returns the error.
template <int NC, bool WEIGHT, class I = int, bool RG = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)temporal_blend_kernel<NC, WEIGHT, I, RG>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_temporal_blend_attrs(int* out) {
  const cudaError_t errs[6] = {attrs_of<1, true>(out),
                               attrs_of<4, false>(out + 4),
                               attrs_of<1, true, int64_t>(out + 8),
                               attrs_of<4, false, int64_t>(out + 12),
                               attrs_of<1, true, int64_t, true>(out + 16),
                               attrs_of<4, false, int64_t, true>(out + 20)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

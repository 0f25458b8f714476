// K5 shadow_blend: raycast sun shadow + shadow temporal blend in one pass.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/shadow_blend.py
// `_kernel` / `dir_shadow_blend_fused`, which walked z sequentially with the
// current shadow slices in a (k+2)-deep and the history in a (2k+2)-deep
// VMEM ring so that the un-blended volume never reached HBM. On the GPU
// every froxel is independent and the un-blended value never leaves
// registers.
//
// Per froxel (z, y, x):
//   1. world position at the jittered froxel centre; for each sun an
//      any-hit ray towards it, visibility^2 gated by has_shadow;
//   2. weight-mode blend against the previous shadow history: weight
//      alpha * (global-uvw success), offsets with jitter and eps = 1e-4,
//      the separable tent warp as an 8-tap gather (common.cuh warp8_by).
// Writes a new buffer [Nd, D, H, W]: the warp reads neighbours of the
// history, so it cannot be updated in place.
//
// The kernel is the shadow half of K2's slice tile (shadow_scatter.cu),
// common.cuh tile_region and tile_blend: a block owns a 16 x 16 tile of one
// slice, computes the slice's scalars and each column's and row's
// view-space terms once, and each reprojection offset of the region its
// warp's taps reach once, into shared memory (~2.4 reprojections a froxel
// where a thread per froxel took 7, each a log and two divisions). K2 runs
// the same routines before its scatter half, so K2 equals K5 then K6 bit
// for bit by construction; and every value is the thread-per-froxel
// form's, from the same operations in the same order.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/shadow_blend.k5_form):
// the narrow form indexes in 32 bits and puts a slice on each launch-grid
// z index; it takes every table whose [max(4, Nd), D, H, W] planes hold
// under 2^31 floats, on at most VR_MAX_GRID_Z slices (common.cuh
// tile_planes_fit). Past that the wide form (I = int64_t): every index and
// every product of a plane by its stride in 64 bits, the slices launched in
// parts of at most VR_MAX_GRID_Z (the block's slice is blockIdx.z + z0). A
// froxel's output depends on its own inputs and on the history, which K5
// only reads, so the parts are independent, and the wide form gives the
// narrow one's values bit for bit.
//
// Bound on the H100: operations, barely. Bytes: read the history and write
// the new one, 2 x 16.6 MB at 240x135x128 and one sun, ~10 us at 3.35 TB/s.
// Work: per froxel one 7-primitive shadow ray and its share of the
// reprojections, ~300 flops, ~1.2 GFLOP, ~20 us at the fp32 rate. Every sun
// ray marches the terrain where the scene has one, as in dir_shadow.cu.
//
// The kernel keeps at most VR_MAX_DIR suns' shadows in registers and their
// inverse directions in TileTerms. More suns take its GEN instantiation
// (common.cuh general_suns), K2's general shadow half: the inverse
// directions in dynamic shared memory after the region, then each sun's
// ray, warp and blend in turn. Each sun's value is computed alone, so the
// general form gives the fixed form's values bit for bit; a frame with at
// most VR_MAX_DIR suns keeps the fixed form. Past the suns whose inverses
// fit beside the region (common.cuh sun_form_of: 18,436 and more at k = 4)
// the gen_global instantiation (SG) reads them from a device buffer
// [n_dir, 3] that the launcher fills first with the same device function
// (common.cuh fill_sun_inverses); its dynamic shared memory is the region
// alone, and every value is GEN's.
//
// Region forms (common.cuh VR_REGION_*; mirrored by
// ops/temporal.region_form): from a window of k = 52 the tile's region no
// longer fits a block's shared memory, and the launcher takes the
// region_global instantiation (RG), K2's shadow half in that form
// (shadow_scatter.cu): the four offsets of every froxel in a [4, D, H, W]
// plane that common.cuh fill_region_plane writes first, read there by the
// warp; gen_global's wide form otherwise, and every value the shared
// forms'.
#include "common.cuh"

// The tile, columns x rows: a block of X * Y threads, MIN_BLOCKS of them an
// SM (the launch bounds; mirrored by ops/shadow_blend.K5_TILE).
struct K5Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 6;
};

template <bool ARMS, bool GEN = false, class I = int, bool SG = false,
          bool RG = false>
__global__ void __launch_bounds__(K5Tile::X * K5Tile::Y, K5Tile::MIN_BLOCKS)
shadow_blend_kernel(VrTables T, const float* __restrict__ prev_sh,
                    float* __restrict__ out_sh, int z_part,
                    const float* __restrict__ sun_inv_g,
                    const float* __restrict__ region_g) {
  constexpr int TX = K5Tile::X, TY = K5Tile::Y;
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  const int z0 = sizeof(I) > sizeof(int) ? z_part : 0;
  __shared__ TileTerms<TX, TY, I> S;
  // region_floats (GEN: + sun_inv_floats, gen_global: in sun_inv_g;
  // region_global: none, the region in region_g)
  extern __shared__ float dyn_s[];
  tile_region<false, TX, TY, GEN, SG, RG>(T, S, dyn_s, z0);
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int z = blockIdx.z + z0;
  if (x >= T.w || y >= T.h) return;
  const I n = (I)T.d * T.h * T.w;
  const I i = ((I)z * T.h + y) * T.w + x;
  float wx, wy, wz;
  if constexpr (GEN) {
    tile_blend<ARMS, TX, TY, true, SG, RG>(T, prev_sh, out_sh, S, dyn_s, x,
                                           y, n, i, wx, wy, wz, nullptr, z0,
                                           sun_inv_g, region_g);
  } else {
    float blended[VR_MAX_DIR];
    tile_blend<ARMS>(T, prev_sh, out_sh, S, dyn_s, x, y, n, i, wx, wy, wz,
                     blended, z0);
  }
}

// Launches of the fixed (0), general (1) and gen_global (2) forms, of the
// narrow (0) and wide (1) index forms, and of the region_shared (0) and
// region_global (1) forms and the latter's pre-pass (2), since the library
// was loaded (vr_shadow_blend_forms, vr_shadow_blend_index_forms,
// vr_shadow_blend_region_forms). A region_global launch is also a
// gen_global and a wide one.
static long g_forms[3];
static long g_index_forms[2];
static long g_region_forms[3];

// The dynamic shared bytes of a launch at reprojection window k with n_dir
// suns: the region, and in the general form the suns' inverse directions.
static int k5_shared(int k, bool gen, int n_dir) {
  return (region_floats(K5Tile::X, K5Tile::Y, k)
          + (gen ? sun_inv_floats(n_dir) : 0)) * (int)sizeof(float);
}

// Whether the wide form takes the table (mirrored by
// ops/shadow_blend.k5_form): common.cuh tile_rows_fit.
static bool k5_wide_fits(const VrTables& T) {
  return tile_rows_fit(T, K5Tile::Y);
}

// Whether the narrow form takes it: what the wide form takes, with the
// planes and slices of common.cuh tile_planes_fit.
static bool k5_narrow_fits(const VrTables& T) {
  return k5_wide_fits(T) && tile_planes_fit(T);
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k5_form(const VrTables& T) {
  if (k5_narrow_fits(T)) return VR_FORM_NARROW;
  return k5_wide_fits(T) ? VR_FORM_WIDE : -1;
}

// The sun form the launch takes (common.cuh VR_SUNS_*; mirrored by
// ops/scatter.sun_form): the suns' inverses after the region where both
// fit, in device memory (gen_global) past that; -1: the region alone does
// not fit.
static int k5_sun_form(int k, int n_dir) {
  return sun_form_of(k5_shared(k, false, 0), n_dir > VR_MAX_DIR, n_dir);
}

// The region form a launch at reprojection window k takes
// (VR_REGION_*): region_shared where the fixed form's region fits.
static int k5_region_form(int k) {
  return region_form_of(k5_shared(k, false, 0), VR_TILE_STATIC);
}

// RG: the region_global form (GEN, SG and I = int64_t), its offsets in
// region_g.
template <bool ARMS, bool GEN, class I, bool SG = false, bool RG = false>
static int launch_tile(const VrTables* T, const float* prev_sh,
                       float* out_sh, cudaStream_t stream,
                       const float* sun_inv = nullptr,
                       const float* region_g = nullptr) {
  constexpr int TX = K5Tile::X, TY = K5Tile::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel = shadow_blend_kernel<ARMS, GEN, I, SG, RG>;
  const int shared = RG ? 0 : k5_shared(T->k, GEN && !SG, T->n_dir);
  if (shared > 48 * 1024) {  // a wide reprojection window, or many suns
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T->w + TX - 1) / TX, (T->h + TY - 1) / TY, T->d);
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, prev_sh, out_sh, 0,
                                                   sun_inv, region_g);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < T->d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, T->d - z0);
      kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, prev_sh, out_sh,
                                                     z0, sun_inv, region_g);
    }
  }
  ++g_forms[SG ? 2 : GEN];
  ++g_index_forms[WIDE];
  ++g_region_forms[RG];
  return 0;
}

template <bool ARMS, class I>
static int launch_form(const VrTables* T, const float* prev_sh,
                       float* out_sh, cudaStream_t stream) {
  return general_suns(*T)
             ? launch_tile<ARMS, true, I>(T, prev_sh, out_sh, stream)
             : launch_tile<ARMS, false, I>(T, prev_sh, out_sh, stream);
}

template <class I>
static int launch_arms(const VrTables* T, const float* prev_sh,
                       float* out_sh, cudaStream_t stream) {
  return needs_arms(*T) ? launch_form<true, I>(T, prev_sh, out_sh, stream)
                        : launch_form<false, I>(T, prev_sh, out_sh, stream);
}

// The index form to launch: form, or the size rule's for VR_FORM_RULE;
// -1 where it does not take the table.
static int k5_index_form(const VrTables& T, int form) {
  if (form == VR_FORM_RULE) form = k5_form(T);
  const bool fits = form == VR_FORM_NARROW ? k5_narrow_fits(T)
                    : form == VR_FORM_WIDE ? k5_wide_fits(T)
                                           : false;
  return fits ? form : -1;
}

// form: VR_FORM_RULE (the size rule's, k5_form), or the narrow or the wide
// form, refused where it does not take the table.
extern "C" int vr_shadow_blend_form(const VrTables* T, const float* prev_sh,
                                    float* out_sh, int form,
                                    cudaStream_t stream) {
  form = k5_index_form(*T, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  const int err =
      form == VR_FORM_WIDE
          ? launch_arms<int64_t>(T, prev_sh, out_sh, stream)
          : launch_arms<int>(T, prev_sh, out_sh, stream);
  return err ? err : (int)cudaGetLastError();
}

// The gen_global form, in index form `form` (as vr_shadow_blend_form): the
// suns' inverse directions into sun_inv [n_dir, 3] (device memory), then
// the kernel reading them there. Any sun count whose region fits.
extern "C" int vr_shadow_blend_global(const VrTables* T,
                                      const float* prev_sh, float* out_sh,
                                      float* sun_inv, int form,
                                      cudaStream_t stream) {
  form = k5_index_form(*T, form);
  if (form < 0 || k5_sun_form(T->k, 0) < 0)
    return (int)cudaErrorInvalidValue;
  int err = fill_sun_inverses(T, sun_inv, stream);
  if (err) return err;
  const bool arms = needs_arms(*T);
  if (form == VR_FORM_WIDE)
    err = arms ? launch_tile<true, true, int64_t, true>(T, prev_sh, out_sh,
                                                        stream, sun_inv)
               : launch_tile<false, true, int64_t, true>(T, prev_sh, out_sh,
                                                         stream, sun_inv);
  else
    err = arms ? launch_tile<true, true, int, true>(T, prev_sh, out_sh,
                                                    stream, sun_inv)
               : launch_tile<false, true, int, true>(T, prev_sh, out_sh,
                                                     stream, sun_inv);
  return err ? err : (int)cudaGetLastError();
}

// The region_global form, any reprojection window: the suns' inverse
// directions into sun_inv [n_dir, 3] and the four offsets of every froxel
// into region_g [4, D, H, W] (device memory), then the kernel reading
// both there, in the wide index form.
extern "C" int vr_shadow_blend_region(const VrTables* T,
                                      const float* prev_sh, float* out_sh,
                                      float* sun_inv, float* region_g,
                                      cudaStream_t stream) {
  if (k5_index_form(*T, VR_FORM_WIDE) < 0)
    return (int)cudaErrorInvalidValue;
  int err = fill_sun_inverses(T, sun_inv, stream);
  if (err) return err;
  err = fill_region_plane(T->sbpar, true, T->w, T->h, T->d, T->h_glob, T->k,
                          region_g, stream);
  if (err) return err;
  ++g_region_forms[2];
  err = needs_arms(*T)
            ? launch_tile<true, true, int64_t, true, true>(
                  T, prev_sh, out_sh, stream, sun_inv, region_g)
            : launch_tile<false, true, int64_t, true, true>(
                  T, prev_sh, out_sh, stream, sun_inv, region_g);
  return err ? err : (int)cudaGetLastError();
}

// The region form a launch at reprojection window k takes into out[0]
// (VR_REGION_*).
extern "C" int vr_shadow_blend_region_form_of(int k, int* out) {
  out[0] = k5_region_form(k);
  return 0;
}

// The launches of the region_shared and the region_global form and of the
// latter's pre-pass so far into out[0..2].
extern "C" int vr_shadow_blend_region_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_region_forms[f];
  return 0;
}

// The sun form a launch at reprojection window k with n_dir suns takes
// into out[0] (VR_SUNS_*; -1: the region does not fit).
extern "C" int vr_shadow_blend_sun_form_of(int k, int n_dir, int* out) {
  out[0] = k5_sun_form(k, n_dir);
  return 0;
}

// The size rule's form for the table into out[0] (-1: past the wide form
// too) and its launch's slice parts into out[1].
extern "C" int vr_shadow_blend_form_of(const VrTables* T, int* out) {
  out[0] = k5_form(*T);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(T->d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_shadow_blend_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The launches of the fixed, the general and the gen_global form so far
// into out[0..2].
extern "C" int vr_shadow_blend_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_forms[f];
  return 0;
}

// The dynamic shared bytes of a launch of the general form at reprojection
// window k with n_dir suns into out[0].
extern "C" int vr_shadow_blend_general_shared(int k, int n_dir, int* out) {
  out[0] = k5_shared(k, true, n_dir);
  return 0;
}

// The tile (columns, rows) into out[0..1] and the dynamic shared bytes of a
// launch of the fixed form at reprojection window k into out[2].
extern "C" int vr_shadow_blend_geometry(int k, int* out) {
  out[0] = K5Tile::X;
  out[1] = K5Tile::Y;
  out[2] = region_floats(K5Tile::X, K5Tile::Y, k) * (int)sizeof(float);
  return 0;
}

// cudaFuncGetAttributes of the fourteen kernels: the fixed forms then the
// general ones, ARMS false then true, narrow; then the same four wide; then
// the gen_global ones, ARMS false then true, narrow then wide; then the
// region_global ones, ARMS false then true: registers per thread, static
// shared bytes per block, local bytes per thread and largest block into
// out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS, bool GEN = false, class I = int, bool SG = false,
          bool RG = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)shadow_blend_kernel<ARMS, GEN, I, SG, RG>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_shadow_blend_attrs(int* out) {
  const cudaError_t errs[14] = {
      attrs_of<false>(out), attrs_of<true>(out + 4),
      attrs_of<false, true>(out + 8), attrs_of<true, true>(out + 12),
      attrs_of<false, false, int64_t>(out + 16),
      attrs_of<true, false, int64_t>(out + 20),
      attrs_of<false, true, int64_t>(out + 24),
      attrs_of<true, true, int64_t>(out + 28),
      attrs_of<false, true, int, true>(out + 32),
      attrs_of<true, true, int, true>(out + 36),
      attrs_of<false, true, int64_t, true>(out + 40),
      attrs_of<true, true, int64_t, true>(out + 44),
      attrs_of<false, true, int64_t, true, true>(out + 48),
      attrs_of<true, true, int64_t, true, true>(out + 52)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

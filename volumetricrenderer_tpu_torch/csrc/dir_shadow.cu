// K7 dir_shadow: the raycast sun shadow volume, no temporal blend.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/dir_shadow.py
// `_kernel` / `dir_shadow_pallas` (one z-slice per grid step). The frame
// runs it when temporal_blend_shadow is off; with the blend on,
// shadow_blend.cu computes the same value and blends it in the same pass.
//
// Per froxel (z, y, x): the world position at the jittered froxel centre,
// then for each sun an any-hit ray towards it against the planes, spheres,
// boxes and the terrain, visibility^2 gated by has_shadow (common.cuh
// sun_shadow). Writes [Nd, D, H, W].
//
// A block owns a 16 x 16 tile of one slice (K7Tile), K5's tile
// (shadow_blend.cu) without the reprojection region and the blend. Once a
// block: the slice's jittered view depth and each sun's inverse direction
// (a small scalar step of its own, one thread each on the first lanes of
// as many warps), then froxel_vx of each column and froxel_vy of each row
// (common.cuh tile_line, its jittered items), into shared memory. Per
// froxel: view_world, then sun_shadow<ARMS, true>, whose box tests read the
// inverses from shared memory and whose plane and sphere tests leave before
// a division or a root whose answer is known. A thread per froxel computed
// all of these itself: the depth mapping's log and exp, four divisions for
// the world position and three for each ray's inverse, with a 64-bit index
// split by division. Every value is that form's, from the same expressions
// in the same order, so the volume is bit for bit the same and K7 then
// K10's weight mode still gives K5's volume.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/dir_shadow.k7_form):
// the narrow form indexes in 32 bits and puts a slice on each launch-grid
// z index; it takes every table whose [max(4, Nd), D, H, W] planes hold
// under 2^31 floats, on at most VR_MAX_GRID_Z slices (common.cuh
// tile_planes_fit). Past that the wide form (I = int64_t): the index and
// every product of a plane by its stride in 64 bits, the slices launched in
// parts of at most VR_MAX_GRID_Z (the block's slice is blockIdx.z + z0).
// A froxel's output depends on its own position alone, so the parts are
// independent, and the wide form gives the narrow one's values bit for
// bit.
//
// Bound on the H100: operations. Bytes: one write of 16.6 MB at
// 240x135x128 and one sun, ~5 us at 3.35 TB/s. Work: a 7-primitive ray a
// froxel, ~13 us at the fp32 rate (chip_smoke.py's count). Every sun ray
// marches the procedural terrain where the scene has one (common.cuh
// heightfield_occluded: hf_steps fBm samples over the band [base, base +
// amp] the ray crosses, skipped where it crosses none or a primitive
// occludes first); that march, ~700 flops a sample at 2 octaves, is then
// most of the work of the froxels near the ground, and the tile takes out
// only the setup share of it. A block of several slices (each thread its
// froxel in 2-8 of them) ran a solid scene 5% faster and the terrain
// 6-60% slower, 8 blocks an SM and 32 x 8 tiles no faster (PERF.md §6).
//
// TileTerms holds at most VR_MAX_DIR suns' inverse directions. More suns
// take the kernel's GEN instantiation (common.cuh general_suns): the
// inverses in dynamic shared memory (sun_inv_floats), computed by the
// block's threads in turn (sun_inverses), the rest as above. Every value
// is the fixed form's; a frame with at most VR_MAX_DIR suns keeps that.
// Past the suns whose inverses fit a block's shared memory (common.cuh
// sun_form_of: 19,286 and more) the gen_global instantiation (SG) reads
// them from a device buffer [n_dir, 3] that the launcher fills first with
// the same device function (common.cuh fill_sun_inverses), every thread of
// a warp at the same address, and has no dynamic shared memory; the GEN
// code is otherwise the same, so the values are GEN's bit for bit.
#include "common.cuh"

// The tile, columns x rows: a block of X * Y threads, MIN_BLOCKS of them an
// SM (the launch bounds; the tile mirrored by ops/dir_shadow.K7_TILE).
struct K7Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 6;
};

template <bool ARMS, bool GEN = false, class I = int, bool SG = false>
__global__ void __launch_bounds__(K7Tile::X * K7Tile::Y, K7Tile::MIN_BLOCKS)
dir_shadow_kernel(VrTables T, float* __restrict__ out_sh, int z_part,
                  const float* __restrict__ sun_inv_g) {
  constexpr int TX = K7Tile::X, TY = K7Tile::Y, NT = TX * TY;
  __shared__ TileTerms<TX, TY> S;
  const float* sun_inv = nullptr;  // GEN: the suns' inverse directions
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  const int z0 = sizeof(I) > sizeof(int) ? z_part : 0;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY, z = blockIdx.z + z0;
  // 1. the slice's jittered view depth (item 0) and the inverse direction
  // of each sun's shadow ray (items 1 .. n_dir), as tile_scalars computes
  // them, on the first lanes of as many warps (GEN: item 0, then
  // sun_inverses)
  if constexpr (SG) {  // gen_global: the launcher's buffer
    if (tid == 0) S.vz_j = center_vz(T.spar, z, true, T.d);
    sun_inv = sun_inv_g;
  } else if constexpr (GEN) {
    extern __shared__ float sun_inv_s[];  // sun_inv_floats
    if (tid == 0) S.vz_j = center_vz(T.spar, z, true, T.d);
    sun_inverses(T, tid, NT, sun_inv_s);
    sun_inv = sun_inv_s;
  }
  for (int item = 0; !GEN && item <= T.n_dir; ++item) {
    if (tid != (item * 32) % NT + (item * 32) / NT) continue;
    if (item == 0) {
      S.vz_j = center_vz(T.spar, z, true, T.d);
    } else {
      const float* q = T.slights + 8 * (item - 1);
      float* inv = S.sun_inv[item - 1];
      inv[0] = inv_dir(-q[0]);
      inv[1] = inv_dir(-q[1]);
      inv[2] = inv_dir(-q[2]);
    }
  }
  __syncthreads();
  // 2. froxel_vx of each column (tile_line's items 0 .. TX - 1) and
  // froxel_vy of each row (its items 2 TX .. 2 TX + TY - 1)
  if (tid < TX + TY) tile_line(T, xt, yt, tid < TX ? tid : tid + TX, S);
  __syncthreads();
  const int x = xt + tx, y = yt + ty;
  if (x >= T.w || y >= T.h) return;
  // 3. dir_shadow_slice: the jittered world position, one ray per sun
  float wx, wy, wz;
  view_world(T.spar, S.vxj[tx], S.vyj[ty], S.vz_j, wx, wy, wz);
  const I n = (I)T.d * T.h * T.w;
  const I i = ((I)z * T.h + y) * T.w + x;
  for (int li = 0; li < T.n_dir; ++li)
    out_sh[li * n + i] = sun_shadow<ARMS, true>(
        T, li, wx, wy, wz, GEN ? sun_inv + 3 * li : S.sun_inv[li]);
}

// Launches of the fixed (0), general (1) and gen_global (2) forms, and of
// the narrow (0) and wide (1) index forms, since the library was loaded
// (vr_dir_shadow_forms, vr_dir_shadow_index_forms).
static long g_forms[3];
static long g_index_forms[2];

// The dynamic shared bytes of a launch with n_dir suns: none in the fixed
// form, the suns' inverse directions in the general one.
static int k7_shared(bool gen, int n_dir) {
  return gen ? sun_inv_floats(n_dir) * (int)sizeof(float) : 0;
}

// Whether the wide form takes the table (mirrored by
// ops/dir_shadow.k7_form): common.cuh tile_rows_fit.
static bool k7_wide_fits(const VrTables& T) {
  return tile_rows_fit(T, K7Tile::Y);
}

// Whether the narrow form takes it: what the wide form takes, with the
// planes and slices of common.cuh tile_planes_fit.
static bool k7_narrow_fits(const VrTables& T) {
  return k7_wide_fits(T) && tile_planes_fit(T);
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k7_form(const VrTables& T) {
  if (k7_narrow_fits(T)) return VR_FORM_NARROW;
  return k7_wide_fits(T) ? VR_FORM_WIDE : -1;
}

// The sun form the launch takes (common.cuh VR_SUNS_*; mirrored by
// ops/scatter.sun_form): the suns' inverses in shared memory where they
// fit, in device memory (gen_global) past that.
static int k7_sun_form(int n_dir) {
  return n_dir > VR_MAX_DIR ? sun_form_of(0, true, n_dir) : VR_SUNS_SHARED;
}

template <bool ARMS, bool GEN, class I, bool SG = false>
static int launch_tile(const VrTables* T, float* out_sh,
                       cudaStream_t stream, const float* sun_inv = nullptr) {
  constexpr int TX = K7Tile::X, TY = K7Tile::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel = dir_shadow_kernel<ARMS, GEN, I, SG>;
  const int shared = SG ? 0 : k7_shared(GEN, T->n_dir);
  if (shared > 48 * 1024) {  // many suns
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T->w + TX - 1) / TX, (T->h + TY - 1) / TY, T->d);
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, out_sh, 0, sun_inv);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < T->d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, T->d - z0);
      kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, out_sh, z0,
                                                     sun_inv);
    }
  }
  ++g_forms[SG ? 2 : GEN];
  ++g_index_forms[WIDE];
  return 0;
}

template <bool ARMS, class I>
static int launch_form(const VrTables* T, float* out_sh,
                       cudaStream_t stream) {
  return general_suns(*T) ? launch_tile<ARMS, true, I>(T, out_sh, stream)
                          : launch_tile<ARMS, false, I>(T, out_sh, stream);
}

template <class I>
static int launch_arms(const VrTables* T, float* out_sh,
                       cudaStream_t stream) {
  return needs_arms(*T) ? launch_form<true, I>(T, out_sh, stream)
                        : launch_form<false, I>(T, out_sh, stream);
}

// The index form to launch: form, or the size rule's for VR_FORM_RULE;
// -1 where it does not take the table.
static int k7_index_form(const VrTables& T, int form) {
  if (form == VR_FORM_RULE) form = k7_form(T);
  const bool fits = form == VR_FORM_NARROW ? k7_narrow_fits(T)
                    : form == VR_FORM_WIDE ? k7_wide_fits(T)
                                           : false;
  return fits ? form : -1;
}

// form: VR_FORM_RULE (the size rule's, k7_form), or the narrow or the wide
// form, refused where it does not take the table.
extern "C" int vr_dir_shadow_form(const VrTables* T, float* out_sh, int form,
                                  cudaStream_t stream) {
  form = k7_index_form(*T, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  const int err = form == VR_FORM_WIDE
                      ? launch_arms<int64_t>(T, out_sh, stream)
                      : launch_arms<int>(T, out_sh, stream);
  return err ? err : (int)cudaGetLastError();
}

// The gen_global form, in index form `form` (as vr_dir_shadow_form): the
// suns' inverse directions into sun_inv [n_dir, 3] (device memory), then
// the kernel reading them there. Any sun count.
extern "C" int vr_dir_shadow_global(const VrTables* T, float* out_sh,
                                    float* sun_inv, int form,
                                    cudaStream_t stream) {
  form = k7_index_form(*T, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  int err = fill_sun_inverses(T, sun_inv, stream);
  if (err) return err;
  const bool arms = needs_arms(*T);
  if (form == VR_FORM_WIDE)
    err = arms ? launch_tile<true, true, int64_t, true>(T, out_sh, stream,
                                                        sun_inv)
               : launch_tile<false, true, int64_t, true>(T, out_sh, stream,
                                                         sun_inv);
  else
    err = arms ? launch_tile<true, true, int, true>(T, out_sh, stream,
                                                    sun_inv)
               : launch_tile<false, true, int, true>(T, out_sh, stream,
                                                     sun_inv);
  return err ? err : (int)cudaGetLastError();
}

// The sun form a launch with n_dir suns takes into out[0] (VR_SUNS_*).
extern "C" int vr_dir_shadow_sun_form_of(int n_dir, int* out) {
  out[0] = k7_sun_form(n_dir);
  return 0;
}

// The size rule's form for the table into out[0] (-1: past the wide form
// too) and its launch's slice parts into out[1].
extern "C" int vr_dir_shadow_form_of(const VrTables* T, int* out) {
  out[0] = k7_form(*T);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(T->d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_dir_shadow_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The launches of the fixed, the general and the gen_global form so far
// into out[0..2].
extern "C" int vr_dir_shadow_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_forms[f];
  return 0;
}

// The dynamic shared bytes of a launch of the general form with n_dir suns
// into out[0].
extern "C" int vr_dir_shadow_general_shared(int n_dir, int* out) {
  out[0] = k7_shared(true, n_dir);
  return 0;
}

// The tile (columns, rows) into out[0..1].
extern "C" int vr_dir_shadow_geometry(int* out) {
  out[0] = K7Tile::X;
  out[1] = K7Tile::Y;
  return 0;
}

// cudaFuncGetAttributes of the twelve kernels: the fixed forms then the
// general ones, ARMS false then true, narrow; then the same four wide; then
// the gen_global ones, ARMS false then true, narrow then wide: registers
// per thread, static shared bytes per block, local bytes per thread and
// largest block into out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS, bool GEN = false, class I = int, bool SG = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)dir_shadow_kernel<ARMS, GEN, I, SG>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_dir_shadow_attrs(int* out) {
  const cudaError_t errs[12] = {
      attrs_of<false>(out), attrs_of<true>(out + 4),
      attrs_of<false, true>(out + 8), attrs_of<true, true>(out + 12),
      attrs_of<false, false, int64_t>(out + 16),
      attrs_of<true, false, int64_t>(out + 20),
      attrs_of<false, true, int64_t>(out + 24),
      attrs_of<true, true, int64_t>(out + 28),
      attrs_of<false, true, int, true>(out + 32),
      attrs_of<true, true, int, true>(out + 36),
      attrs_of<false, true, int64_t, true>(out + 40),
      attrs_of<true, true, int64_t, true>(out + 44)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

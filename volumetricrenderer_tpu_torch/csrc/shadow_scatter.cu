// K2 shadow_scatter: sun shadow -> shadow temporal blend -> scatter.
//
// Replaces stage 1, the shadow blend and the scatter of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 264-273 and 327-365, with dir_shadow.dir_shadow_slice,
// temporal._reproj_offsets/_tent_pass and scatter.scatter_slice inlined).
// The TPU grid carried the history in a VMEM ring and handed the blended
// shadow to the scatter in registers; here every froxel is independent, so
// one thread per froxel does the whole chain and the blended shadow never
// leaves registers on its way to the scatter, in blocks that each own a
// tile of one slice (below).
//
// Per froxel (z, y, x):
//   1. world position at the jittered froxel centre; for each sun an
//      any-hit ray towards it, visibility^2 gated by has_shadow;
//   2. weight-mode blend against the previous shadow history: the
//      separable tent warp as an 8-tap gather (common.cuh warp8_by), weight
//      alpha * (global-uvw success), offsets with jitter and eps = 1e-4;
//   3. material at the jittered position, the local lights from one of the
//      megakernel's three sources (the LOCAL template parameter):
//        radiance  the low-rate radiance bake (bake_radiance.cu) upsampled
//                  and times sigma_s, the fBm factor upsampled from its
//                  noise channels (the inline radiance bake, ss > 1);
//        ray       the slice's light schedule, one any-hit shadow ray per
//                  froxel and light (the per-light branch, ss = 1);
//        baked     the same loop, the shadow term upsampled from the
//                  low-rate per-light visibility (bake_visibility.cu: the
//                  inline visibility bake, frame_fused.py:482-527);
//      then each sun's colour x blended shadow x HG at the UNJITTERED
//      centre, and ext = luma(sigma_s) + sigma_a times the sun count.
// Writes the new shadow history [Nd, D, H, W] and the scatter planes
// [4, D, H, W] (L_r, L_g, L_b, ext); histories are never updated in place.
//
// The three steps are the device functions of common.cuh that the staged
// frame's kernels call one at a time (tile_region and tile_blend, which
// shadow_blend.cu runs alone; scatter_froxel, which scatter.cu calls): the
// fused frames equal the staged ones bit for bit.
//
// Bound on the H100: operations. Bytes: read the previous shadow (16.6 MB)
// and write shadow + scatter (83 MB) at FULL -- ~30 us at 3.35 TB/s. Work,
// radiance source: per froxel one 7-primitive shadow ray, 7 reprojection
// evaluations (each a log, 2 divides) and ~30 gathered low-volume taps,
// ~800 flops, ~0.035 ms at the fp32 peak. The two loops add, per scheduled
// (froxel, light) pair, ~60 flops of light_factor and a 7-primitive ray
// (ray) or 8 gathered taps (baked), and per froxel the Perlin fBm of the
// media (no baked noise channel): the bound of K5 plus that of K6 in the
// same mode. On a scene with the procedural terrain the sun rays march it
// (dir_shadow.cu), and the local rays too with heightfield_local_shadows;
// fractional boxes make every shadow term an occlusion amount. Both arms
// live in the kernel's ARMS instantiation (common.cuh any_hit), launched
// only for a scene that has them, so a scene without them keeps its
// registers and its time.
//
// The first form ran a thread per froxel on a 64-bit flat index and
// recomputed, per froxel, what is constant per slice (3 view depths, each a
// log and an exp), per column or row (the view-space terms) and per frame
// (log(fpz), the suns' inverse directions), and 7 reprojections, each some
// neighbour's own, at 13x its bound. Here a block owns a 16 x 16 tile of
// one slice (K2Tile; common.cuh TileTerms): steps 1 and 2 and the shadow
// half of step 3 are common.cuh tile_region and tile_blend (the slice's
// terms, each
// reprojection of the region the warp's taps reach once, ~9 divisions a
// froxel where there were ~70, the sun rays and the blend), which K5
// shadow_blend.cu runs alone; then the scatter half (common.cuh
// scatter_froxel: the upsample's taps once for every channel, the box
// mask's clamped divisions skipped).
// Every float value is the first form's, from the same operations in the
// same order, so the result is bit for bit that form's, and K5 then K6 give
// it too. The radiance form runs 5 blocks an SM (48 registers, a few
// spilled), the loops 4 (64): PERF.md §6 has the shapes, block counts and
// cuts measured.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/frame_fused.k2_form):
// the narrow form indexes in 32 bits and puts a slice on each launch-grid
// z index; it takes every table whose arrays K2 indexes (k2_narrow_fits:
// the [max(4, Nd), D, H, W] planes, the low channels its local source
// reads, the light schedule) hold under 2^31 floats, on at most
// VR_MAX_GRID_Z slices. Past that the wide form (I = int64_t): every index
// and every product of a plane or channel by its stride in 64 bits, the
// slices launched in parts of at most VR_MAX_GRID_Z (the block's slice is
// blockIdx.z + z0). A froxel's outputs depend on its own inputs and on
// the history and the low volume, which K2 only reads, so the parts are
// independent. The same code on wider indices: the wide form gives the
// narrow one's values bit for bit.
//
// Those forms keep at most VR_MAX_DIR suns' shadows in registers and
// VR_MAX_NOISE fBm channels in an array. A frame with more suns or more
// fBm channels (common.cuh needs_general) takes the GEN instantiation of
// the same kernel: the suns' inverse directions in dynamic shared memory
// after the region, each sun's ray, warp and blend in turn, its blended
// value stored to out_sh and read back from there by the same thread for
// the scatter's sun terms (in sun order, after the local lights, as the
// fixed form adds them), each fBm factor upsampled where the material
// reads it. Every value is the fixed form's, so the general form equals
// K5's then K6's general forms bit for bit as the fixed one equals theirs;
// a frame with at most VR_MAX_DIR suns and VR_MAX_NOISE channels keeps the
// fixed form, its registers and its time. Past the suns whose inverses fit
// beside the region (common.cuh sun_form_of: 18,436 and more at k = 4) the
// gen_global instantiation (SG) reads them from a device buffer [n_dir, 3]
// that the launcher fills first with the same device function (common.cuh
// fill_sun_inverses); its dynamic shared memory is the region alone, and
// every value is GEN's, in every local source and both index forms.
//
// Region forms (common.cuh VR_REGION_*; mirrored by
// ops/temporal.region_form): the region of a 16 x 16 tile, (16 + 2k + 1)^2
// cells of four offsets, no longer fits a block's shared memory from a
// window of k = 52. Past that the region_global instantiation (RG): the
// launcher first writes the four offsets of every froxel into a [4, D, H,
// W] plane in device memory (common.cuh fill_region_plane; the same device
// functions as step 2, so the same bits), and step 3's warp reads them
// there at its taps, through L1 and L2. It is gen_global's wide form with
// that plane: no dynamic shared memory, so any window; every value is the
// shared forms'. A window up to k = 51 keeps the region_shared forms, their
// code and their time.
#include "common.cuh"

// The tile of each local source, columns x rows: a block of X * Y threads,
// MIN_BLOCKS of them an SM (the launch bounds).
template <int LOCAL>
struct K2Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 4;
};

template <>
struct K2Tile<VR_LOCAL_RADIANCE> {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 5;
};

template <int LOCAL, bool ARMS, int TX, int TY, bool GEN = false,
          class I = int, bool SG = false, bool RG = false>
__global__ void __launch_bounds__(TX * TY, K2Tile<LOCAL>::MIN_BLOCKS)
shadow_scatter_kernel(VrTables T, const float* __restrict__ prev_sh,
                      const float* __restrict__ low,
                      float* __restrict__ out_sh,
                      float* __restrict__ out_sc, int z_part,
                      const float* __restrict__ sun_inv_g,
                      const float* __restrict__ region_g) {
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const int z0 = WIDE ? z_part : 0;
  __shared__ TileTerms<TX, TY, I> S;
  // region_floats (GEN: + sun_inv_floats, gen_global: in sun_inv_g;
  // region_global: none, the region in region_g)
  extern __shared__ float dyn_s[];
  tile_region<true, TX, TY, GEN, SG, RG>(T, S, dyn_s, z0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TX + tx, y = blockIdx.y * TY + ty;
  const int z = blockIdx.z + z0;
  if (x >= T.w || y >= T.h) return;
  const I n = (I)T.d * T.h * T.w;
  const I i = ((I)z * T.h + y) * T.w + x;
  float wx, wy, wz, cwx, cwy, cwz, sc[4];
  if constexpr (GEN) {
    tile_blend<ARMS, TX, TY, true, SG, RG>(T, prev_sh, out_sh, S, dyn_s, x,
                                           y, n, i, wx, wy, wz, nullptr, z0,
                                           sun_inv_g, region_g);
    // scatter_slice (material fused, dir lights folded), each sun's blended
    // shadow read back from this thread's own stores
    view_world(T.spar, S.vxc[tx], S.vyc[ty], S.vz_c, cwx, cwy, cwz);
    const auto sun_at = [&](int li) { return out_sh[li * n + i]; };
    scatter_froxel<LOCAL, false, ARMS, true>(T, S.low, low, z, y, x, i, n,
                                             wx, wy, wz, cwx, cwy, cwz,
                                             sun_at, sc);
  } else {
    float blended[VR_MAX_DIR];
    tile_blend<ARMS>(T, prev_sh, out_sh, S, dyn_s, x, y, n, i, wx, wy, wz,
                     blended, z0);
    // scatter_slice (material fused, dir lights folded)
    view_world(T.spar, S.vxc[tx], S.vyc[ty], S.vz_c, cwx, cwy, cwz);
    const auto sun_at = [&](int li) { return blended[li]; };
    scatter_froxel<LOCAL, false, ARMS>(T, S.low, low, z, y, x, i, n, wx, wy,
                                       wz, cwx, cwy, cwz, sun_at, sc);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out_sc[c * n + i] = sc[c];
}

// Launches of the fixed (0), general (1) and gen_global (2) forms, of the
// narrow (0) and wide (1) index forms, and of the region_shared (0) and
// region_global (1) forms and the latter's pre-pass (2), since the library
// was loaded (vr_shadow_scatter_forms, vr_shadow_scatter_index_forms,
// vr_shadow_scatter_region_forms). A region_global launch is also a
// gen_global and a wide one.
static long g_forms[3];
static long g_index_forms[2];
static long g_region_forms[3];

// The dynamic shared bytes of a launch at reprojection window k with n_dir
// suns: the region, and in the general form the suns' inverse directions.
static int k2_shared(int tx, int ty, int k, bool gen, int n_dir) {
  return (region_floats(tx, ty, k) + (gen ? sun_inv_floats(n_dir) : 0))
         * (int)sizeof(float);
}

// The low channels that local source `local` reads: the radiance (+ fBm),
// the visibility of every light, or none (the rays).
static long k2_low_channels(const VrTables& T, int local) {
  if (local == VR_LOCAL_RADIANCE) return 3 + T.n_noise;
  return local == VR_LOCAL_BAKED ? T.n_lights : 0;
}

// Whether the wide form takes the table (mirrored by
// ops/frame_fused.k2_form): at most VR_MAX_GRID_Z row tiles on the launch
// grid's y axis, and the suns' and lights' tables, which either form
// indexes in 32 bits, under 2^31 floats. Every tile has K2Tile's 16 rows.
static bool k2_wide_fits(const VrTables& T) {
  return (T.h + 15) / 16 <= VR_MAX_GRID_Z && !past_int(T.n_dir, 8)
         && !past_int(T.n_lights, 16);
}

// Whether the narrow form takes it: what the wide form takes, with the
// [max(4, Nd), D, H, W] planes, the low channels its local source reads and
// the light schedule [D, NL] (the per-light loops) under 2^31 floats, on at
// most VR_MAX_GRID_Z slices.
static bool k2_narrow_fits(const VrTables& T, int local) {
  const long n = (long)T.w * T.h * T.d;
  const long lplane = (long)T.wl * T.hl * T.dl;
  return k2_wide_fits(T) && !past_int(T.n_dir > 4 ? T.n_dir : 4, n)
         && !past_int(k2_low_channels(T, local), lplane)
         && !(local != VR_LOCAL_RADIANCE && past_int(T.d, T.n_lights))
         && T.d <= VR_MAX_GRID_Z;
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k2_form(const VrTables& T, int local) {
  if (k2_narrow_fits(T, local)) return VR_FORM_NARROW;
  return k2_wide_fits(T) ? VR_FORM_WIDE : -1;
}

// The sun form a launch at reprojection window k with n_dir suns and
// n_noise fBm channels takes (common.cuh VR_SUNS_*; mirrored by
// ops/scatter.sun_form): the general form's suns after the region where
// both fit, in device memory (gen_global) past that; -1: the region alone
// does not fit. Every local source has one tile.
static int k2_sun_form(int k, int n_dir, int n_noise) {
  constexpr int TX = K2Tile<VR_LOCAL_RADIANCE>::X;
  constexpr int TY = K2Tile<VR_LOCAL_RADIANCE>::Y;
  return sun_form_of(k2_shared(TX, TY, k, false, 0),
                     n_dir > VR_MAX_DIR || n_noise > VR_MAX_NOISE, n_dir);
}

// The region form a launch at reprojection window k takes
// (VR_REGION_*): region_shared where the fixed form's region fits.
static int k2_region_form(int k) {
  return region_form_of(k2_shared(K2Tile<VR_LOCAL_RADIANCE>::X,
                                  K2Tile<VR_LOCAL_RADIANCE>::Y, k, false, 0),
                        VR_TILE_STATIC);
}

// RG: the region_global form (GEN, SG and I = int64_t), its offsets in
// region_g.
template <int LOCAL, bool ARMS, bool GEN, class I, bool SG = false,
          bool RG = false>
static int launch_tile(const VrTables* T, const float* prev_sh,
                       const float* low, float* out_sh, float* out_sc,
                       cudaStream_t stream, const float* sun_inv = nullptr,
                       const float* region_g = nullptr) {
  constexpr int TX = K2Tile<LOCAL>::X, TY = K2Tile<LOCAL>::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel =
      shadow_scatter_kernel<LOCAL, ARMS, TX, TY, GEN, I, SG, RG>;
  const int shared =
      RG ? 0 : k2_shared(TX, TY, T->k, GEN && !SG, T->n_dir);
  if (shared > 48 * 1024) {  // a wide reprojection window, or many suns
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T->w + TX - 1) / TX, (T->h + TY - 1) / TY, T->d);
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, prev_sh, low, out_sh,
                                                   out_sc, 0, sun_inv,
                                                   region_g);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < T->d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, T->d - z0);
      kernel<<<grid, dim3(TX, TY), shared, stream>>>(*T, prev_sh, low,
                                                     out_sh, out_sc, z0,
                                                     sun_inv, region_g);
    }
  }
  ++g_forms[SG ? 2 : GEN];
  ++g_index_forms[WIDE];
  ++g_region_forms[RG];
  return 0;
}

// SG: the gen_global form, its suns' inverse directions in sun_inv; RG:
// the region_global form, its offsets in region_g.
template <int LOCAL, bool ARMS, class I, bool SG = false, bool RG = false>
static int launch_form(const VrTables* T, const float* prev_sh,
                       const float* low, float* out_sh, float* out_sc,
                       cudaStream_t stream, const float* sun_inv,
                       const float* region_g) {
  if constexpr (SG)
    return launch_tile<LOCAL, ARMS, true, I, true, RG>(
        T, prev_sh, low, out_sh, out_sc, stream, sun_inv, region_g);
  if (needs_general(*T))
    return launch_tile<LOCAL, ARMS, true, I>(T, prev_sh, low, out_sh, out_sc,
                                             stream);
  return launch_tile<LOCAL, ARMS, false, I>(T, prev_sh, low, out_sh, out_sc,
                                            stream);
}

template <int LOCAL, class I, bool SG, bool RG>
static int launch_shadow_scatter(const VrTables* T, const float* prev_sh,
                                 const float* low, float* out_sh,
                                 float* out_sc, cudaStream_t stream,
                                 const float* sun_inv,
                                 const float* region_g) {
  if (needs_arms(*T))
    return launch_form<LOCAL, true, I, SG, RG>(T, prev_sh, low, out_sh,
                                               out_sc, stream, sun_inv,
                                               region_g);
  return launch_form<LOCAL, false, I, SG, RG>(T, prev_sh, low, out_sh,
                                              out_sc, stream, sun_inv,
                                              region_g);
}

template <class I, bool SG = false, bool RG = false>
static int launch_local(const VrTables* T, const float* prev_sh,
                        const float* low, float* out_sh, float* out_sc,
                        int local, cudaStream_t stream,
                        const float* sun_inv = nullptr,
                        const float* region_g = nullptr) {
  switch (local) {
    case VR_LOCAL_RADIANCE:
      return launch_shadow_scatter<VR_LOCAL_RADIANCE, I, SG, RG>(
          T, prev_sh, low, out_sh, out_sc, stream, sun_inv, region_g);
    case VR_LOCAL_RAY:
      return launch_shadow_scatter<VR_LOCAL_RAY, I, SG, RG>(
          T, prev_sh, low, out_sh, out_sc, stream, sun_inv, region_g);
    case VR_LOCAL_BAKED:
      return launch_shadow_scatter<VR_LOCAL_BAKED, I, SG, RG>(
          T, prev_sh, low, out_sh, out_sc, stream, sun_inv, region_g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The index form to launch: form, or the size rule's for VR_FORM_RULE;
// -1 where it does not take the table.
static int k2_index_form(const VrTables& T, int local, int form) {
  if (form == VR_FORM_RULE) form = k2_form(T, local);
  const bool fits = form == VR_FORM_NARROW ? k2_narrow_fits(T, local)
                    : form == VR_FORM_WIDE ? k2_wide_fits(T)
                                           : false;
  return fits ? form : -1;
}

// local: VR_LOCAL_*; low: the radiance (+ fBm) volume [3 + n_noise, DL,
// HL, WL], the visibility volume [NL, DL, HL, WL], or null for
// VR_LOCAL_RAY. form: VR_FORM_RULE (the size rule's, k2_form), or the
// narrow or the wide form, refused where it does not take the table.
extern "C" int vr_shadow_scatter_form(const VrTables* T, const float* prev_sh,
                                      const float* low, float* out_sh,
                                      float* out_sc, int local, int form,
                                      cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || local < 0 || local > 2)
    return (int)cudaErrorInvalidValue;
  form = k2_index_form(*T, local, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  const int err =
      form == VR_FORM_WIDE
          ? launch_local<int64_t>(T, prev_sh, low, out_sh, out_sc, local,
                                  stream)
          : launch_local<int>(T, prev_sh, low, out_sh, out_sc, local,
                              stream);
  return err ? err : (int)cudaGetLastError();
}

// The gen_global form, in index form `form` (as vr_shadow_scatter_form):
// the suns' inverse directions into sun_inv [n_dir, 3] (device memory),
// then the kernel reading them there. Any sun count whose region fits.
extern "C" int vr_shadow_scatter_global(const VrTables* T,
                                        const float* prev_sh,
                                        const float* low, float* out_sh,
                                        float* out_sc, int local,
                                        float* sun_inv, int form,
                                        cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || local < 0 || local > 2)
    return (int)cudaErrorInvalidValue;
  form = k2_index_form(*T, local, form);
  if (form < 0 || k2_sun_form(T->k, 0, 0) < 0)
    return (int)cudaErrorInvalidValue;
  int err = fill_sun_inverses(T, sun_inv, stream);
  if (err) return err;
  err = form == VR_FORM_WIDE
            ? launch_local<int64_t, true>(T, prev_sh, low, out_sh, out_sc,
                                          local, stream, sun_inv)
            : launch_local<int, true>(T, prev_sh, low, out_sh, out_sc, local,
                                      stream, sun_inv);
  return err ? err : (int)cudaGetLastError();
}

// The region_global form, any reprojection window: the suns' inverse
// directions into sun_inv [n_dir, 3] and the four offsets of every froxel
// into region_g [4, D, H, W] (device memory), then the kernel reading
// both there, in the wide index form.
extern "C" int vr_shadow_scatter_region(const VrTables* T,
                                        const float* prev_sh,
                                        const float* low, float* out_sh,
                                        float* out_sc, int local,
                                        float* sun_inv, float* region_g,
                                        cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || local < 0 || local > 2)
    return (int)cudaErrorInvalidValue;
  if (k2_index_form(*T, local, VR_FORM_WIDE) < 0)
    return (int)cudaErrorInvalidValue;
  int err = fill_sun_inverses(T, sun_inv, stream);
  if (err) return err;
  err = fill_region_plane(T->sbpar, true, T->w, T->h, T->d, T->h_glob, T->k,
                          region_g, stream);
  if (err) return err;
  ++g_region_forms[2];
  err = launch_local<int64_t, true, true>(T, prev_sh, low, out_sh, out_sc,
                                          local, stream, sun_inv, region_g);
  return err ? err : (int)cudaGetLastError();
}

// The region form a launch at reprojection window k takes into out[0]
// (VR_REGION_*).
extern "C" int vr_shadow_scatter_region_form_of(int k, int* out) {
  out[0] = k2_region_form(k);
  return 0;
}

// The launches of the region_shared and the region_global form and of the
// latter's pre-pass so far into out[0..2].
extern "C" int vr_shadow_scatter_region_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_region_forms[f];
  return 0;
}

// The sun form a launch at reprojection window k with n_dir suns and
// n_noise fBm channels takes into out[0] (VR_SUNS_*; -1: the region does
// not fit).
extern "C" int vr_shadow_scatter_sun_form_of(int k, int n_dir, int n_noise,
                                             int* out) {
  out[0] = k2_sun_form(k, n_dir, n_noise);
  return 0;
}

// The size rule's form for the table and local source into out[0] (-1:
// past the wide form too) and its launch's slice parts into out[1].
extern "C" int vr_shadow_scatter_form_of(const VrTables* T, int local,
                                         int* out) {
  out[0] = k2_form(*T, local);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(T->d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_shadow_scatter_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The launches of the fixed, the general and the gen_global form so far
// into out[0..2].
extern "C" int vr_shadow_scatter_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_forms[f];
  return 0;
}

// The dynamic shared bytes of a launch of the general form at reprojection
// window k with n_dir suns into out[0] (every local source has one tile).
extern "C" int vr_shadow_scatter_general_shared(int k, int n_dir,
                                                int* out) {
  out[0] = k2_shared(K2Tile<VR_LOCAL_RADIANCE>::X,
                     K2Tile<VR_LOCAL_RADIANCE>::Y, k, true, n_dir);
  return 0;
}

// The tile (columns, rows) of local source `local` into out[0..1] and the
// dynamic shared bytes of a launch of the fixed form at reprojection window
// k into out[2].
extern "C" int vr_shadow_scatter_geometry(int local, int k, int* out) {
  switch (local) {
    case VR_LOCAL_RADIANCE:
      out[0] = K2Tile<VR_LOCAL_RADIANCE>::X;
      out[1] = K2Tile<VR_LOCAL_RADIANCE>::Y;
      break;
    case VR_LOCAL_RAY:
      out[0] = K2Tile<VR_LOCAL_RAY>::X;
      out[1] = K2Tile<VR_LOCAL_RAY>::Y;
      break;
    case VR_LOCAL_BAKED:
      out[0] = K2Tile<VR_LOCAL_BAKED>::X;
      out[1] = K2Tile<VR_LOCAL_BAKED>::Y;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  out[2] = region_floats(out[0], out[1], k) * (int)sizeof(float);
  return 0;
}

// cudaFuncGetAttributes of the forty-two kernels: the fixed forms then
// the general ones, each LOCAL (radiance, ray, baked) outer and ARMS
// (false, true) inner, narrow; then the same twelve wide; then the
// gen_global ones, narrow (LOCAL outer, ARMS inner) then wide; then the
// region_global ones (LOCAL outer, ARMS inner): registers per thread,
// static shared bytes per block, local bytes per thread and largest block
// into out[4 i .. 4 i + 3]; returns the error.
template <int LOCAL, bool ARMS, bool GEN = false, class I = int,
          bool SG = false, bool RG = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)shadow_scatter_kernel<LOCAL, ARMS, K2Tile<LOCAL>::X,
                                             K2Tile<LOCAL>::Y, GEN, I, SG,
                                             RG>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

template <class I>
static void attrs_of_index_form(int* out, cudaError_t* errs) {
  errs[0] = attrs_of<VR_LOCAL_RADIANCE, false, false, I>(out);
  errs[1] = attrs_of<VR_LOCAL_RADIANCE, true, false, I>(out + 4);
  errs[2] = attrs_of<VR_LOCAL_RAY, false, false, I>(out + 8);
  errs[3] = attrs_of<VR_LOCAL_RAY, true, false, I>(out + 12);
  errs[4] = attrs_of<VR_LOCAL_BAKED, false, false, I>(out + 16);
  errs[5] = attrs_of<VR_LOCAL_BAKED, true, false, I>(out + 20);
  errs[6] = attrs_of<VR_LOCAL_RADIANCE, false, true, I>(out + 24);
  errs[7] = attrs_of<VR_LOCAL_RADIANCE, true, true, I>(out + 28);
  errs[8] = attrs_of<VR_LOCAL_RAY, false, true, I>(out + 32);
  errs[9] = attrs_of<VR_LOCAL_RAY, true, true, I>(out + 36);
  errs[10] = attrs_of<VR_LOCAL_BAKED, false, true, I>(out + 40);
  errs[11] = attrs_of<VR_LOCAL_BAKED, true, true, I>(out + 44);
}

template <class I, bool RG = false>
static void attrs_of_global(int* out, cudaError_t* errs) {
  errs[0] = attrs_of<VR_LOCAL_RADIANCE, false, true, I, true, RG>(out);
  errs[1] = attrs_of<VR_LOCAL_RADIANCE, true, true, I, true, RG>(out + 4);
  errs[2] = attrs_of<VR_LOCAL_RAY, false, true, I, true, RG>(out + 8);
  errs[3] = attrs_of<VR_LOCAL_RAY, true, true, I, true, RG>(out + 12);
  errs[4] = attrs_of<VR_LOCAL_BAKED, false, true, I, true, RG>(out + 16);
  errs[5] = attrs_of<VR_LOCAL_BAKED, true, true, I, true, RG>(out + 20);
}

extern "C" int vr_shadow_scatter_attrs(int* out) {
  cudaError_t errs[42];
  attrs_of_index_form<int>(out, errs);
  attrs_of_index_form<int64_t>(out + 48, errs + 12);
  attrs_of_global<int>(out + 96, errs + 24);
  attrs_of_global<int64_t>(out + 120, errs + 30);
  attrs_of_global<int64_t, true>(out + 144, errs + 36);
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// K6 scatter: the per-froxel in-scatter of every light.
//
// Replaces the TPU kernel volumetricrenderer_tpu/ops/pallas/scatter.py
// `_kernel` / `scatter_local_pallas` in its modes. The local lights come
// from one of three sources:
//   radiance   they were baked at the low rate (bake_radiance.cu): three
//              tent upsamples x sigma_s, plus the baked fBm channels;
//   ray        no bake: a loop over the slice's light schedule
//              (slice_light_order) with light_factor and one any-hit shadow
//              ray per froxel and light;
//   baked      the same loop, the shadow term read from the low-rate
//              per-light visibility volume (bake_visibility.cu): z-lerp,
//              x tent, y tent at the light's channel;
// and the material from one of two:
//   fused      the media table evaluated per froxel (in the two loops with
//              its fBm); the extinction plane comes out as a 4th plane;
//   planes     sigma_s rgb and phase g read from material volumes; three
//              planes out, the caller adds the extinction.
//
// The TPU kernel took one z-slice per grid step with the tables in SMEM and
// a fori_loop over the slice's lights, whole [H, W] planes at a time, and
// upsampled a light's visibility plane with two small matmuls. Here a block
// owns froxels of one slice: a 16 x 8 tile (the baked loop) or a run of 128
// (radiance) or 256 (rays) consecutive froxels of its rows (K6Tile). It
// computes the slice's view depths and upsample terms once (common.cuh
// tile_scalars) and, in a tile, each column's and row's view-space terms
// (tile_line); a run's thread computes its own. Then each thread runs
// common.cuh scatter_froxel for its froxel -- the function
// shadow_scatter.cu calls with the blended shadow in registers; this kernel
// reads the blended shadow volume [Nd, D, H, W] from memory instead. The
// first form ran a thread per froxel on a 64-bit flat index and recomputed
// two view depths (a log and an exp each) and the upsample's taps for every
// channel per froxel; every float value is that form's, from the same
// operations in the same order, so the result is bit for bit its result.
// The source and the material are template parameters, so each of
// the six kernels carries only its own branch; the ray loop has a seventh
// and eighth form with the any-hit's terrain and fractional arms
// (common.cuh any_hit<ARMS>), launched only for a scene that has them. The
// sun term is unjittered unless jitter_dir. The per-light sum adds the
// slice's active lights in ascending index, as the TPU loop does; the
// schedule is per slice, so a block runs one loop length and a warp
// diverges only inside any_hit's early exits.
//
// The per-light rays march the terrain under heightfield_local_shadows and
// carry occlusion amounts with fractional boxes (common.cuh any_hit).
//
// Writes the scatter planes [4, D, H, W] (r, g, b, ext), or [3, D, H, W]
// with material volumes.
//
// Bound on the H100: operations in the fused modes, bytes with material
// volumes. Bytes: read the shadow (16.6 MB at 240x135x128, one sun), the
// low volume (1 MB radiance, 4 MB visibility for 16 lights) and, in planes
// mode, four material planes (66 MB); write 66 or 50 MB: ~25 us fused,
// ~40 us planes at 3.35 TB/s. Work, radiance mode: ~30 gathered low-volume
// taps and the material per froxel, ~300 flops, ~1.2 GFLOP, ~20 us at the
// fp32 rate. The loops: per froxel and active light ~60 flops of
// light_factor and a 7-primitive ray or 8 gathered taps, plus (fused) three
// Perlin octaves per noise medium (~1000 flops): several GFLOP.
//
// Each kernel loads at most VR_MAX_DIR suns' blended shadows into registers
// and upsamples at most VR_MAX_NOISE fBm channels into an array. A frame
// with more suns or more fBm channels (common.cuh needs_general) takes the
// GEN instantiation of the same kernel, which reads each sun's shadow from
// memory where its term is added (in sun order, after the local lights)
// and upsamples each fBm factor where the material reads it: the same
// values, so the general forms are bit for bit the fixed ones; a frame
// within the fixed counts keeps its fixed form.
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/scatter.k6_form): the
// narrow form indexes in 32 bits and puts a slice on each launch-grid z
// index; it takes every table whose [max(4, Nd), D, H, W] planes (the
// shadow volume, the scatter planes, the material volumes), the low
// channels its local source reads and, in the per-light loops, the light
// schedule [D, NL] hold under 2^31 floats, on at most VR_MAX_GRID_Z slices
// (k6_narrow_fits). Past that the wide form (I = int64_t): every index and
// every product of a plane or a low channel by its stride in 64 bits
// (common.cuh scatter_froxel, low_slice, low_taps), the slices launched in
// parts of at most VR_MAX_GRID_Z (the block's slice is blockIdx.z + z0). A
// froxel's outputs depend on its own inputs alone, so the parts are
// independent, and the wide form gives the narrow one's values bit for
// bit. The GEN forms take both index forms: 32 kernels.
#include "common.cuh"

// The block of each local source: a tile of X columns x Y rows, or (Y = 0)
// a run of X consecutive froxels of one slice's rows (PERF.md §6 has the
// shapes measured).
template <int LOCAL>
struct K6Tile {
  static constexpr int X = 16, Y = 8;
};

template <>
struct K6Tile<VR_LOCAL_RADIANCE> {
  static constexpr int X = 128, Y = 0;
};

template <>
struct K6Tile<VR_LOCAL_RAY> {
  static constexpr int X = 256, Y = 0;
};

template <int LOCAL, bool MAT_PLANES, bool ARMS, int TX, int TY,
          bool GEN = false, class I = int>
__global__ void __launch_bounds__(TY ? TX * TY : TX)
scatter_kernel(VrTables T, const float* __restrict__ shadow,
               const float* __restrict__ low,
               const float* __restrict__ mat_a,
               const float* __restrict__ mat_b, float* __restrict__ out_sc,
               int z_part) {
  constexpr int NT = TY ? TX * TY : TX;
  __shared__ TileTerms<TX, TY ? TY : 1, I> S;
  const int w = T.w, h = T.h, d = T.d;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  const int z = blockIdx.z + (sizeof(I) > sizeof(int) ? z_part : 0);
  tile_scalars<false, NT>(T, z, tid, S);
  __syncthreads();
  int x, y;
  float wx, wy, wz, cwx, cwy, cwz;
  if constexpr (TY > 0) {
    const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
    for (int j = tid; j < TileTerms<TX, TY>::LINES; j += NT)
      tile_line(T, xt, yt, j, S);
    __syncthreads();
    x = xt + threadIdx.x;
    y = yt + threadIdx.y;
    if (x >= w || y >= h) return;
    view_world(T.spar, S.vxj[threadIdx.x], S.vyj[threadIdx.y], S.vz_j, wx,
               wy, wz);
    view_world(T.spar, S.vxc[threadIdx.x], S.vyc[threadIdx.y], S.vz_c, cwx,
               cwy, cwz);
  } else {  // a row segment: each thread its own view-space terms
    const int f = blockIdx.x * TX + tid;
    if (f >= w * h) return;
    y = f / w;
    x = f - y * w;
    const float* p = T.spar;
    view_world(p, froxel_vx(p, center_fx(p, x, true), S.vz_j, w),
               froxel_vy(p, center_fy(p, y, true, T.h_glob), S.vz_j,
                         T.h_glob),
               S.vz_j, wx, wy, wz);
    view_world(p, froxel_vx(p, center_fx(p, x, false), S.vz_c, w),
               froxel_vy(p, center_fy(p, y, false, T.h_glob), S.vz_c,
                         T.h_glob),
               S.vz_c, cwx, cwy, cwz);
  }
  const I n = (I)d * h * w;
  const I i = ((I)z * h + y) * w + x;
  float sc[4];
  if constexpr (GEN) {
    const auto sun_at = [&](int li) { return __ldg(shadow + li * n + i); };
    scatter_froxel<LOCAL, MAT_PLANES, ARMS, true>(
        T, S.low, low, z, y, x, i, n, wx, wy, wz, cwx, cwy, cwz, sun_at, sc,
        mat_a, mat_b);
  } else {
    float blended[VR_MAX_DIR];
    for (int li = 0; li < T.n_dir; ++li)
      blended[li] = __ldg(shadow + li * n + i);
    const auto sun_at = [&](int li) { return blended[li]; };
    scatter_froxel<LOCAL, MAT_PLANES, ARMS>(T, S.low, low, z, y, x, i, n,
                                            wx, wy, wz, cwx, cwy, cwz,
                                            sun_at, sc, mat_a, mat_b);
  }
#pragma unroll
  for (int c = 0; c < (MAT_PLANES ? 3 : 4); ++c) out_sc[c * n + i] = sc[c];
}

// Launches of the fixed (0) and general (1) forms, and of the narrow (0)
// and wide (1) index forms, since the library was loaded (vr_scatter_forms,
// vr_scatter_index_forms).
static long g_forms[2];
static long g_index_forms[2];

// The launch grid's blocks of local source LOCAL: a tile's rows on its y
// axis, or a run's froxels (an int index: y * w + x) on its x axis.
template <int LOCAL>
static bool k6_grid_fits(const VrTables& T) {
  constexpr int TY = K6Tile<LOCAL>::Y;
  return TY ? (T.h + TY - 1) / TY <= VR_MAX_GRID_Z : !past_int(T.w, T.h);
}

// Whether the wide form takes the table (mirrored by ops/scatter.k6_form):
// the launch grid of the local source's block (k6_grid_fits), and the
// suns' and lights' tables, which either form indexes in 32 bits, under
// 2^31 floats.
static bool k6_wide_fits(const VrTables& T, int local) {
  const bool grid = local == VR_LOCAL_RADIANCE
                        ? k6_grid_fits<VR_LOCAL_RADIANCE>(T)
                    : local == VR_LOCAL_RAY ? k6_grid_fits<VR_LOCAL_RAY>(T)
                                            : k6_grid_fits<VR_LOCAL_BAKED>(T);
  return grid && !past_int(T.n_dir, 8) && !past_int(T.n_lights, 16);
}

// The low channels that local source `local` reads: the radiance (+ fBm),
// the visibility of every light, or none (the rays).
static long k6_low_channels(const VrTables& T, int local) {
  if (local == VR_LOCAL_RADIANCE) return 3 + T.n_noise;
  return local == VR_LOCAL_BAKED ? T.n_lights : 0;
}

// Whether the narrow form takes it: what the wide form takes, with the
// planes and slices of common.cuh tile_planes_fit, the low channels its
// local source reads and the light schedule [D, NL] (the per-light loops)
// under 2^31 floats.
static bool k6_narrow_fits(const VrTables& T, int local) {
  const long lplane = (long)T.wl * T.hl * T.dl;
  return k6_wide_fits(T, local) && tile_planes_fit(T)
         && !past_int(k6_low_channels(T, local), lplane)
         && !(local != VR_LOCAL_RADIANCE && past_int(T.d, T.n_lights));
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k6_form(const VrTables& T, int local) {
  if (k6_narrow_fits(T, local)) return VR_FORM_NARROW;
  return k6_wide_fits(T, local) ? VR_FORM_WIDE : -1;
}

template <int LOCAL, bool MAT_PLANES, bool ARMS, bool GEN, class I>
static void launch_form(const VrTables* T, const float* shadow,
                        const float* low, const float* mat_a,
                        const float* mat_b, float* out_sc,
                        cudaStream_t stream) {
  constexpr int TX = K6Tile<LOCAL>::X, TY = K6Tile<LOCAL>::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel = scatter_kernel<LOCAL, MAT_PLANES, ARMS, TX, TY, GEN, I>;
  dim3 grid(TY ? (T->w + TX - 1) / TX : (T->w * T->h + TX - 1) / TX,
            TY ? (T->h + TY - 1) / TY : 1, T->d);
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY ? TY : 1), 0, stream>>>(*T, shadow, low,
                                                       mat_a, mat_b, out_sc,
                                                       0);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < T->d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, T->d - z0);
      kernel<<<grid, dim3(TX, TY ? TY : 1), 0, stream>>>(
          *T, shadow, low, mat_a, mat_b, out_sc, z0);
    }
  }
  ++g_forms[GEN];
  ++g_index_forms[WIDE];
}

template <int LOCAL, bool MAT_PLANES, bool ARMS, class I>
static void launch_tile(const VrTables* T, const float* shadow,
                        const float* low, const float* mat_a,
                        const float* mat_b, float* out_sc,
                        cudaStream_t stream) {
  if (needs_general(*T))
    launch_form<LOCAL, MAT_PLANES, ARMS, true, I>(T, shadow, low, mat_a,
                                                  mat_b, out_sc, stream);
  else
    launch_form<LOCAL, MAT_PLANES, ARMS, false, I>(T, shadow, low, mat_a,
                                                   mat_b, out_sc, stream);
}

template <int LOCAL, bool MAT_PLANES, class I>
static void launch_scatter_kernel(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  // only the ray loop casts rays: the arms matter to it alone
  constexpr bool RAYS = LOCAL == VR_LOCAL_RAY;
  if (RAYS && needs_arms(*T))
    launch_tile<LOCAL, MAT_PLANES, RAYS, I>(T, shadow, low, mat_a, mat_b,
                                            out_sc, stream);
  else
    launch_tile<LOCAL, MAT_PLANES, false, I>(T, shadow, low, mat_a, mat_b,
                                             out_sc, stream);
}

template <int LOCAL, class I>
static void launch_scatter(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  if (mat_a)
    launch_scatter_kernel<LOCAL, true, I>(T, shadow, low, mat_a, mat_b,
                                          out_sc, stream);
  else
    launch_scatter_kernel<LOCAL, false, I>(T, shadow, low, mat_a, mat_b,
                                           out_sc, stream);
}

template <class I>
static void launch_local(const VrTables* T, const float* shadow,
                         const float* low, const float* mat_a,
                         const float* mat_b, float* out_sc, int local,
                         cudaStream_t stream) {
  switch (local) {
    case VR_LOCAL_RADIANCE:
      launch_scatter<VR_LOCAL_RADIANCE, I>(T, shadow, low, mat_a, mat_b,
                                           out_sc, stream);
      break;
    case VR_LOCAL_RAY:
      launch_scatter<VR_LOCAL_RAY, I>(T, shadow, low, mat_a, mat_b, out_sc,
                                      stream);
      break;
    default:
      launch_scatter<VR_LOCAL_BAKED, I>(T, shadow, low, mat_a, mat_b,
                                        out_sc, stream);
  }
}

// local: VR_LOCAL_*; low: the radiance or visibility volume (null for
// VR_LOCAL_RAY); mat_a null selects the fused material. form: VR_FORM_RULE
// (the size rule's, k6_form), or the narrow or the wide form, refused
// where it does not take the table.
extern "C" int vr_scatter_form(const VrTables* T, const float* shadow,
                               const float* low, const float* mat_a,
                               const float* mat_b, float* out_sc, int local,
                               int form, cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || (!mat_a != !mat_b)
      || local < 0 || local > 2)
    return (int)cudaErrorInvalidValue;
  if (form == VR_FORM_RULE) form = k6_form(*T, local);
  const bool fits = form == VR_FORM_NARROW ? k6_narrow_fits(*T, local)
                    : form == VR_FORM_WIDE ? k6_wide_fits(*T, local)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  if (form == VR_FORM_WIDE)
    launch_local<int64_t>(T, shadow, low, mat_a, mat_b, out_sc, local,
                          stream);
  else
    launch_local<int>(T, shadow, low, mat_a, mat_b, out_sc, local, stream);
  return (int)cudaGetLastError();
}

// The size rule's form for the table and local source into out[0] (-1:
// past the wide form too) and its launch's slice parts into out[1].
extern "C" int vr_scatter_form_of(const VrTables* T, int local, int* out) {
  out[0] = local < 0 || local > 2 ? -1 : k6_form(*T, local);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(T->d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_scatter_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The launches of the fixed and the general form so far into out[0..1].
extern "C" int vr_scatter_forms(int* out) {
  out[0] = (int)g_forms[0];
  out[1] = (int)g_forms[1];
  return 0;
}

// The tile (columns, rows) of local source `local` into out[0..1].
extern "C" int vr_scatter_geometry(int local, int* out) {
  switch (local) {
    case VR_LOCAL_RADIANCE:
      out[0] = K6Tile<VR_LOCAL_RADIANCE>::X;
      out[1] = K6Tile<VR_LOCAL_RADIANCE>::Y;
      break;
    case VR_LOCAL_RAY:
      out[0] = K6Tile<VR_LOCAL_RAY>::X;
      out[1] = K6Tile<VR_LOCAL_RAY>::Y;
      break;
    case VR_LOCAL_BAKED:
      out[0] = K6Tile<VR_LOCAL_BAKED>::X;
      out[1] = K6Tile<VR_LOCAL_BAKED>::Y;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// cudaFuncGetAttributes of the thirty-two kernels, in ops/cuda.py
// ATTR_KERNELS' order: the fixed forms, (LOCAL, MAT_PLANES) of radiance,
// ray, baked x fused, planes with ARMS false, then the ray loop's two ARMS
// forms; then the general forms in the same order; those sixteen narrow,
// then the same sixteen wide. Registers per thread, static shared bytes
// per block, local bytes per thread and largest block into
// out[4 i .. 4 i + 3]; returns the error.
template <int LOCAL, bool MAT_PLANES, bool ARMS, bool GEN = false,
          class I = int>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)scatter_kernel<LOCAL, MAT_PLANES, ARMS,
                                      K6Tile<LOCAL>::X, K6Tile<LOCAL>::Y,
                                      GEN, I>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

template <bool GEN, class I>
static void attrs_of_forms(int* out, cudaError_t* errs) {
  errs[0] = attrs_of<VR_LOCAL_RADIANCE, false, false, GEN, I>(out);
  errs[1] = attrs_of<VR_LOCAL_RADIANCE, true, false, GEN, I>(out + 4);
  errs[2] = attrs_of<VR_LOCAL_RAY, false, false, GEN, I>(out + 8);
  errs[3] = attrs_of<VR_LOCAL_RAY, true, false, GEN, I>(out + 12);
  errs[4] = attrs_of<VR_LOCAL_BAKED, false, false, GEN, I>(out + 16);
  errs[5] = attrs_of<VR_LOCAL_BAKED, true, false, GEN, I>(out + 20);
  errs[6] = attrs_of<VR_LOCAL_RAY, false, true, GEN, I>(out + 24);
  errs[7] = attrs_of<VR_LOCAL_RAY, true, true, GEN, I>(out + 28);
}

extern "C" int vr_scatter_attrs(int* out) {
  cudaError_t errs[32];
  attrs_of_forms<false, int>(out, errs);
  attrs_of_forms<true, int>(out + 32, errs + 8);
  attrs_of_forms<false, int64_t>(out + 64, errs + 16);
  attrs_of_forms<true, int64_t>(out + 96, errs + 24);
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

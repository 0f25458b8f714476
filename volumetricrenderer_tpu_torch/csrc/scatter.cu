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
          bool GEN = false>
__global__ void __launch_bounds__(TY ? TX * TY : TX)
scatter_kernel(VrTables T, const float* __restrict__ shadow,
               const float* __restrict__ low,
               const float* __restrict__ mat_a,
               const float* __restrict__ mat_b, float* __restrict__ out_sc) {
  constexpr int NT = TY ? TX * TY : TX;
  __shared__ TileTerms<TX, TY ? TY : 1> S;
  const int w = T.w, h = T.h, d = T.d;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int z = blockIdx.z;
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
  const int n = d * h * w;
  const int i = (z * h + y) * w + x;
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

// Launches of the fixed (0) and general (1) forms since the library was
// loaded (vr_scatter_forms).
static long g_forms[2];

template <int LOCAL, bool MAT_PLANES, bool ARMS, bool GEN>
static void launch_form(const VrTables* T, const float* shadow,
                        const float* low, const float* mat_a,
                        const float* mat_b, float* out_sc,
                        cudaStream_t stream) {
  constexpr int TX = K6Tile<LOCAL>::X, TY = K6Tile<LOCAL>::Y;
  const dim3 grid(TY ? (T->w + TX - 1) / TX : (T->w * T->h + TX - 1) / TX,
                  TY ? (T->h + TY - 1) / TY : 1, T->d);
  scatter_kernel<LOCAL, MAT_PLANES, ARMS, TX, TY, GEN>
      <<<grid, dim3(TX, TY ? TY : 1), 0, stream>>>(*T, shadow, low, mat_a,
                                                   mat_b, out_sc);
  ++g_forms[GEN];
}

template <int LOCAL, bool MAT_PLANES, bool ARMS>
static void launch_tile(const VrTables* T, const float* shadow,
                        const float* low, const float* mat_a,
                        const float* mat_b, float* out_sc,
                        cudaStream_t stream) {
  if (needs_general(*T))
    launch_form<LOCAL, MAT_PLANES, ARMS, true>(T, shadow, low, mat_a, mat_b,
                                               out_sc, stream);
  else
    launch_form<LOCAL, MAT_PLANES, ARMS, false>(T, shadow, low, mat_a,
                                                mat_b, out_sc, stream);
}

template <int LOCAL, bool MAT_PLANES>
static void launch_scatter_kernel(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  // only the ray loop casts rays: the arms matter to it alone
  constexpr bool RAYS = LOCAL == VR_LOCAL_RAY;
  if (RAYS && needs_arms(*T))
    launch_tile<LOCAL, MAT_PLANES, RAYS>(T, shadow, low, mat_a, mat_b,
                                         out_sc, stream);
  else
    launch_tile<LOCAL, MAT_PLANES, false>(T, shadow, low, mat_a, mat_b,
                                          out_sc, stream);
}

template <int LOCAL>
static void launch_scatter(const VrTables* T, const float* shadow,
                           const float* low, const float* mat_a,
                           const float* mat_b, float* out_sc,
                           cudaStream_t stream) {
  if (mat_a)
    launch_scatter_kernel<LOCAL, true>(T, shadow, low, mat_a, mat_b, out_sc,
                                       stream);
  else
    launch_scatter_kernel<LOCAL, false>(T, shadow, low, mat_a, mat_b,
                                        out_sc, stream);
}

// local: VR_LOCAL_*; low: the radiance or visibility volume (null for
// VR_LOCAL_RAY); mat_a null selects the fused material.
extern "C" int vr_scatter(const VrTables* T, const float* shadow,
                          const float* low, const float* mat_a,
                          const float* mat_b, float* out_sc, int local,
                          cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || (!mat_a != !mat_b)
      || past_int_index(*T))
    return (int)cudaErrorInvalidValue;
  switch (local) {
    case VR_LOCAL_RADIANCE:
      launch_scatter<VR_LOCAL_RADIANCE>(T, shadow, low, mat_a, mat_b, out_sc,
                                        stream);
      break;
    case VR_LOCAL_RAY:
      launch_scatter<VR_LOCAL_RAY>(T, shadow, low, mat_a, mat_b, out_sc,
                                   stream);
      break;
    case VR_LOCAL_BAKED:
      launch_scatter<VR_LOCAL_BAKED>(T, shadow, low, mat_a, mat_b, out_sc,
                                     stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// cudaFuncGetAttributes of the sixteen kernels, in ops/cuda.py
// ATTR_KERNELS' order: the fixed forms, (LOCAL, MAT_PLANES) of radiance,
// ray, baked x fused, planes with ARMS false, then the ray loop's two ARMS
// forms; then the general forms in the same order. Registers per thread,
// static shared bytes per block, local bytes per thread and largest block
// into out[4 i .. 4 i + 3]; returns the error.
template <int LOCAL, bool MAT_PLANES, bool ARMS, bool GEN = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)scatter_kernel<LOCAL, MAT_PLANES, ARMS,
                                      K6Tile<LOCAL>::X, K6Tile<LOCAL>::Y,
                                      GEN>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

template <bool GEN>
static void attrs_of_forms(int* out, cudaError_t* errs) {
  errs[0] = attrs_of<VR_LOCAL_RADIANCE, false, false, GEN>(out);
  errs[1] = attrs_of<VR_LOCAL_RADIANCE, true, false, GEN>(out + 4);
  errs[2] = attrs_of<VR_LOCAL_RAY, false, false, GEN>(out + 8);
  errs[3] = attrs_of<VR_LOCAL_RAY, true, false, GEN>(out + 12);
  errs[4] = attrs_of<VR_LOCAL_BAKED, false, false, GEN>(out + 16);
  errs[5] = attrs_of<VR_LOCAL_BAKED, true, false, GEN>(out + 20);
  errs[6] = attrs_of<VR_LOCAL_RAY, false, true, GEN>(out + 24);
  errs[7] = attrs_of<VR_LOCAL_RAY, true, true, GEN>(out + 28);
}

extern "C" int vr_scatter_attrs(int* out) {
  cudaError_t errs[16];
  attrs_of_forms<false>(out, errs);
  attrs_of_forms<true>(out + 32, errs + 8);
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

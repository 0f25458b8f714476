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
// it too; indices are 32-bit (the launcher refuses tables past 2^31 floats,
// common.cuh past_int_index). The radiance form runs 5 blocks an SM (48
// registers, a few spilled), the loops 4 (64): PERF.md §6 has the shapes,
// block counts and cuts measured.
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
// fixed form, its registers and its time.
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

template <int LOCAL, bool ARMS, int TX, int TY, bool GEN = false>
__global__ void __launch_bounds__(TX * TY, K2Tile<LOCAL>::MIN_BLOCKS)
shadow_scatter_kernel(VrTables T, const float* __restrict__ prev_sh,
                      const float* __restrict__ low,
                      float* __restrict__ out_sh,
                      float* __restrict__ out_sc) {
  __shared__ TileTerms<TX, TY> S;
  extern __shared__ float dyn_s[];  // region_floats (GEN: + sun_inv_floats)
  tile_region<true, TX, TY, GEN>(T, S, dyn_s);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TX + tx, y = blockIdx.y * TY + ty;
  const int z = blockIdx.z;
  if (x >= T.w || y >= T.h) return;
  const int n = T.d * T.h * T.w;
  const int i = (z * T.h + y) * T.w + x;
  float wx, wy, wz, cwx, cwy, cwz, sc[4];
  if constexpr (GEN) {
    tile_blend<ARMS, TX, TY, true>(T, prev_sh, out_sh, S, dyn_s, x, y, n, i,
                                   wx, wy, wz, nullptr);
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
                     blended);
    // scatter_slice (material fused, dir lights folded)
    view_world(T.spar, S.vxc[tx], S.vyc[ty], S.vz_c, cwx, cwy, cwz);
    const auto sun_at = [&](int li) { return blended[li]; };
    scatter_froxel<LOCAL, false, ARMS>(T, S.low, low, z, y, x, i, n, wx, wy,
                                       wz, cwx, cwy, cwz, sun_at, sc);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out_sc[c * n + i] = sc[c];
}

// Launches of the fixed (0) and general (1) forms since the library was
// loaded (vr_shadow_scatter_forms).
static long g_forms[2];

// The dynamic shared bytes of a launch at reprojection window k with n_dir
// suns: the region, and in the general form the suns' inverse directions.
static int k2_shared(int tx, int ty, int k, bool gen, int n_dir) {
  return (region_floats(tx, ty, k) + (gen ? sun_inv_floats(n_dir) : 0))
         * (int)sizeof(float);
}

template <int LOCAL, bool ARMS, bool GEN>
static int launch_tile(const VrTables* T, const float* prev_sh,
                       const float* low, float* out_sh, float* out_sc,
                       cudaStream_t stream) {
  constexpr int TX = K2Tile<LOCAL>::X, TY = K2Tile<LOCAL>::Y;
  const dim3 grid((T->w + TX - 1) / TX, (T->h + TY - 1) / TY, T->d);
  const int shared = k2_shared(TX, TY, T->k, GEN, T->n_dir);
  if (shared > 48 * 1024) {  // a wide reprojection window, or many suns
    const cudaError_t err = cudaFuncSetAttribute(
        shadow_scatter_kernel<LOCAL, ARMS, TX, TY, GEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  shadow_scatter_kernel<LOCAL, ARMS, TX, TY, GEN>
      <<<grid, dim3(TX, TY), shared, stream>>>(*T, prev_sh, low, out_sh,
                                               out_sc);
  ++g_forms[GEN];
  return 0;
}

template <int LOCAL, bool ARMS>
static int launch_form(const VrTables* T, const float* prev_sh,
                       const float* low, float* out_sh, float* out_sc,
                       cudaStream_t stream) {
  if (needs_general(*T))
    return launch_tile<LOCAL, ARMS, true>(T, prev_sh, low, out_sh, out_sc,
                                          stream);
  return launch_tile<LOCAL, ARMS, false>(T, prev_sh, low, out_sh, out_sc,
                                         stream);
}

template <int LOCAL>
static int launch_shadow_scatter(const VrTables* T, const float* prev_sh,
                                 const float* low, float* out_sh,
                                 float* out_sc, cudaStream_t stream) {
  if (needs_arms(*T))
    return launch_form<LOCAL, true>(T, prev_sh, low, out_sh, out_sc, stream);
  return launch_form<LOCAL, false>(T, prev_sh, low, out_sh, out_sc, stream);
}

// local: VR_LOCAL_*; low: the radiance (+ fBm) volume [3 + n_noise, DL,
// HL, WL], the visibility volume [NL, DL, HL, WL], or null for
// VR_LOCAL_RAY.
extern "C" int vr_shadow_scatter(const VrTables* T, const float* prev_sh,
                                 const float* low, float* out_sh,
                                 float* out_sc, int local,
                                 cudaStream_t stream) {
  if ((local == VR_LOCAL_RAY) != (low == nullptr) || past_int_index(*T))
    return (int)cudaErrorInvalidValue;
  int err;
  switch (local) {
    case VR_LOCAL_RADIANCE:
      err = launch_shadow_scatter<VR_LOCAL_RADIANCE>(T, prev_sh, low, out_sh,
                                                     out_sc, stream);
      break;
    case VR_LOCAL_RAY:
      err = launch_shadow_scatter<VR_LOCAL_RAY>(T, prev_sh, low, out_sh,
                                                out_sc, stream);
      break;
    case VR_LOCAL_BAKED:
      err = launch_shadow_scatter<VR_LOCAL_BAKED>(T, prev_sh, low, out_sh,
                                                  out_sc, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// The launches of the fixed and the general form so far into out[0..1].
extern "C" int vr_shadow_scatter_forms(int* out) {
  out[0] = (int)g_forms[0];
  out[1] = (int)g_forms[1];
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

// cudaFuncGetAttributes of the twelve kernels, the fixed forms then the
// general ones, each LOCAL (radiance, ray, baked) outer and ARMS (false,
// true) inner: registers per thread, static shared bytes per block, local
// bytes per thread and largest block into out[4 i .. 4 i + 3]; returns the
// error.
template <int LOCAL, bool ARMS, bool GEN = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)shadow_scatter_kernel<LOCAL, ARMS, K2Tile<LOCAL>::X,
                                             K2Tile<LOCAL>::Y, GEN>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_shadow_scatter_attrs(int* out) {
  const cudaError_t errs[12] = {
      attrs_of<VR_LOCAL_RADIANCE, false>(out),
      attrs_of<VR_LOCAL_RADIANCE, true>(out + 4),
      attrs_of<VR_LOCAL_RAY, false>(out + 8),
      attrs_of<VR_LOCAL_RAY, true>(out + 12),
      attrs_of<VR_LOCAL_BAKED, false>(out + 16),
      attrs_of<VR_LOCAL_BAKED, true>(out + 20),
      attrs_of<VR_LOCAL_RADIANCE, false, true>(out + 24),
      attrs_of<VR_LOCAL_RADIANCE, true, true>(out + 28),
      attrs_of<VR_LOCAL_RAY, false, true>(out + 32),
      attrs_of<VR_LOCAL_RAY, true, true>(out + 36),
      attrs_of<VR_LOCAL_BAKED, false, true>(out + 40),
      attrs_of<VR_LOCAL_BAKED, true, true>(out + 44)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

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
// for bit by
// construction; and every value is the thread-per-froxel form's, from the
// same operations in the same order. Indices are 32-bit: the launcher
// refuses tables past 2^31 floats (common.cuh past_int_index).
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
// most VR_MAX_DIR suns keeps the fixed form.
#include "common.cuh"

// The tile, columns x rows: a block of X * Y threads, MIN_BLOCKS of them an
// SM (the launch bounds; mirrored by ops/shadow_blend.K5_TILE).
struct K5Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 6;
};

template <bool ARMS, bool GEN = false>
__global__ void __launch_bounds__(K5Tile::X * K5Tile::Y, K5Tile::MIN_BLOCKS)
shadow_blend_kernel(VrTables T, const float* __restrict__ prev_sh,
                    float* __restrict__ out_sh) {
  constexpr int TX = K5Tile::X, TY = K5Tile::Y;
  __shared__ TileTerms<TX, TY> S;
  extern __shared__ float dyn_s[];  // region_floats (GEN: + sun_inv_floats)
  tile_region<false, TX, TY, GEN>(T, S, dyn_s);
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= T.w || y >= T.h) return;
  const int n = T.d * T.h * T.w;
  const int i = (z * T.h + y) * T.w + x;
  float wx, wy, wz;
  if constexpr (GEN) {
    tile_blend<ARMS, TX, TY, true>(T, prev_sh, out_sh, S, dyn_s, x, y, n, i,
                                   wx, wy, wz, nullptr);
  } else {
    float blended[VR_MAX_DIR];
    tile_blend<ARMS>(T, prev_sh, out_sh, S, dyn_s, x, y, n, i, wx, wy, wz,
                     blended);
  }
}

// Launches of the fixed (0) and general (1) forms since the library was
// loaded (vr_shadow_blend_forms).
static long g_forms[2];

// The dynamic shared bytes of a launch at reprojection window k with n_dir
// suns: the region, and in the general form the suns' inverse directions.
static int k5_shared(int k, bool gen, int n_dir) {
  return (region_floats(K5Tile::X, K5Tile::Y, k)
          + (gen ? sun_inv_floats(n_dir) : 0)) * (int)sizeof(float);
}

template <bool ARMS, bool GEN>
static int launch_tile(const VrTables* T, const float* prev_sh,
                       float* out_sh, cudaStream_t stream) {
  constexpr int TX = K5Tile::X, TY = K5Tile::Y;
  const dim3 grid((T->w + TX - 1) / TX, (T->h + TY - 1) / TY, T->d);
  const int shared = k5_shared(T->k, GEN, T->n_dir);
  if (shared > 48 * 1024) {  // a wide reprojection window, or many suns
    const cudaError_t err = cudaFuncSetAttribute(
        shadow_blend_kernel<ARMS, GEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  shadow_blend_kernel<ARMS, GEN><<<grid, dim3(TX, TY), shared, stream>>>(
      *T, prev_sh, out_sh);
  ++g_forms[GEN];
  return 0;
}

template <bool ARMS>
static int launch_form(const VrTables* T, const float* prev_sh,
                       float* out_sh, cudaStream_t stream) {
  return general_suns(*T)
             ? launch_tile<ARMS, true>(T, prev_sh, out_sh, stream)
             : launch_tile<ARMS, false>(T, prev_sh, out_sh, stream);
}

extern "C" int vr_shadow_blend(const VrTables* T, const float* prev_sh,
                               float* out_sh, cudaStream_t stream) {
  if (past_int_index(*T)) return (int)cudaErrorInvalidValue;
  const int err = needs_arms(*T)
                      ? launch_form<true>(T, prev_sh, out_sh, stream)
                      : launch_form<false>(T, prev_sh, out_sh, stream);
  return err ? err : (int)cudaGetLastError();
}

// The launches of the fixed and the general form so far into out[0..1].
extern "C" int vr_shadow_blend_forms(int* out) {
  out[0] = (int)g_forms[0];
  out[1] = (int)g_forms[1];
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

// cudaFuncGetAttributes of the four kernels, the fixed forms then the
// general ones, ARMS false then true: registers per thread, static shared
// bytes per block, local bytes per thread and largest block into
// out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS, bool GEN = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)shadow_blend_kernel<ARMS, GEN>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_shadow_blend_attrs(int* out) {
  const cudaError_t errs[4] = {attrs_of<false>(out), attrs_of<true>(out + 4),
                               attrs_of<false, true>(out + 8),
                               attrs_of<true, true>(out + 12)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

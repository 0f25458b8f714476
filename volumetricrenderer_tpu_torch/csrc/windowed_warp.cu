// K11 windowed_warp: the separable windowed tent resample at arbitrary
// target volumes.
//
// Replaces the TPU kernels volumetricrenderer_tpu/ops/pallas/warp.py
// `_pass_kernel` / `_run_pass` / `windowed_warp_pallas`: three pass kernels
// (z, y, x), each reading its target volume and the previous pass's output
// and keeping its 2k+1 shifted taps in VMEM, with two intermediate volumes
// in HBM between them. A pass weights its taps by the offset of its target
// AT ITS OWN OUTPUT POINT, clipped to +-k, so output (z, y, x) is
//
//   sum_dx wx(offx[z,y,x]) sum_dy wy(offy[z,y,cx]) sum_dz wz(offz[z,cy,cx])
//       vol[cz, cy, cx]
//
// with clamped neighbours, and of each pass's 2k+1 taps only the two around
// its offset have a non-zero tent weight. On the GPU that is one gather
// of 8 taps a channel (common.cuh warp8_by), summed in the passes'
// ascending tap order so the float sums match three sequential passes. No
// intermediate volume exists. The targets are arbitrary coordinate volumes
// (the reprojection through world space, pipeline.reproject_texel), not
// the analytic offsets of temporal_blend.cu.
//
// A block owns a tile of one slice (K11Tile) and stages the offsets its
// froxels' taps read once: the y offsets in the tile's rows and the z
// offsets in every row of its region (the tile and k rows and columns
// before it, k + 1 after: the reach of the taps, common.cuh region_nx /
// region_ny), each target loaded once in coalesced rows, clamped to the
// volume and clipped to +-k once, into shared memory. Each froxel then
// reads only its own x target from device memory, then its taps. The
// thread-per-froxel form ran three levels of dependent scattered loads (tx,
// then ty at 2 columns, then tz at 4 (row, column) pairs) before its taps,
// with every target value loaded and clipped by up to 8 threads. NC, the
// channels, is a template parameter (1 to 4; the wrapper runs more in
// chunks of 4). Indices are 32-bit: the launcher refuses volumes past 2^31
// floats or 65535 slices.
//
// vol and out are [NC, D, H, W], the targets [D, H, W] texel coordinates;
// targets are clipped to the volume, offsets to +-k, taps edge-clamped.
//
// Bound on the H100: bytes. Read NC volume planes and 3 target planes,
// write NC planes of 16.6 MB at 240x135x128: 11 planes, 0.054 ms at
// 3.35 TB/s for NC = 4. Work: 7 offsets, 14 tent weights and 14
// multiply-adds per channel, ~150 flops per froxel, ~10 us at the fp32
// rate. What holds it is the block's chain -- the staging's loads, a
// barrier, then a froxel's 32 tap loads, which wait on both -- at 6
// blocks an SM (PERF.md §6).
#include "common.cuh"

// The tile, columns x rows: a block of X * Y threads, MIN_BLOCKS of them an
// SM (the launch bounds; the tile mirrored by ops/warp.K11_TILE).
struct K11Tile {
  static constexpr int X = 16, Y = 16, MIN_BLOCKS = 6;
};

// The dynamic shared memory of a tile at window k, floats: the y offsets of
// the tile's rows, then the z offsets of the region's rows, each over the
// region's columns (mirrored by ops/warp.k11_shared_bytes).
__host__ __device__ __forceinline__ int k11_floats(int k) {
  return (K11Tile::Y + region_ny(K11Tile::Y, k)) * region_nx(K11Tile::X, k);
}

// The target t at index idx, clamped to the volume's n cells along its
// axis, less the cell index `base`, clipped to +-kf.
__device__ __forceinline__ float target_offset(const float* __restrict__ t,
                                               int idx, int n, int base,
                                               float kf) {
  const float v = clampf(__ldg(t + idx), 0.0f, (float)n - 1.0f);
  return clampf(v - (float)base, -kf, kf);
}

template <int NC>
__global__ void __launch_bounds__(K11Tile::X * K11Tile::Y,
                                  K11Tile::MIN_BLOCKS)
windowed_warp_kernel(const float* __restrict__ vol,
                     const float* __restrict__ tx_v,
                     const float* __restrict__ ty_v,
                     const float* __restrict__ tz_v, float* __restrict__ out,
                     int d, int h, int w, int k) {
  constexpr int TX = K11Tile::X, TY = K11Tile::Y, NT = TX * TY;
  extern __shared__ float dyn_s[];  // k11_floats
  const int nx = region_nx(TX, k), ny = region_ny(TY, k);
  const float* oy_s = dyn_s;            // [TY][nx]
  const float* oz_s = dyn_s + TY * nx;  // [ny][nx]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  const int z = blockIdx.z;
  const int plane = z * h * w;
  const float kf = (float)k;
  // the region's row r at clamp(yt - k + r), column c at clamp(xt - k + c);
  // the y offsets at the tile's rows yt + r (the last one clamped where the
  // tile passes the grid: those rows' threads read nothing)
  for (int j = tid; j < (TY + ny) * nx; j += NT) {
    const int r = j / nx, c = j - r * nx;
    const int col = clampi(xt - k + c, 0, w - 1);
    if (r < TY) {
      const int row = min(yt + r, h - 1);
      dyn_s[j] = target_offset(ty_v, plane + row * w + col, h, row, kf);
    } else {
      const int row = clampi(yt - k + r - TY, 0, h - 1);
      dyn_s[j] = target_offset(tz_v, plane + row * w + col, d, z, kf);
    }
  }
  __syncthreads();
  const int x = xt + tx, y = yt + ty;
  if (x >= w || y >= h) return;
  const int n = d * h * w;
  const int i = plane + y * w + x;
  const int row_y = ty * nx + k - xt;
  const auto oy_at = [&](int cx) { return oy_s[row_y + cx]; };
  const auto oz_at = [&](int, int cy, int cx) {
    return oz_s[(cy - yt + k) * nx + k - xt + cx];
  };
  float acc[NC];
  warp8_by<NC>(vol, n, z, y, x, w, h, d, target_offset(tx_v, i, w, x, kf),
               oy_at, oz_at, acc);
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c * n + i] = acc[c];
}

template <int NC>
static int launch_tile(const float* vol, const float* tx, const float* ty,
                       const float* tz, float* out, int d, int h, int w,
                       int k, cudaStream_t stream) {
  constexpr int TX = K11Tile::X, TY = K11Tile::Y;
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, d);
  const int shared = k11_floats(k) * (int)sizeof(float);
  if (shared > 48 * 1024) {  // a wide reprojection window
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_warp_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  windowed_warp_kernel<NC><<<grid, dim3(TX, TY), shared, stream>>>(
      vol, tx, ty, tz, out, d, h, w, k);
  return 0;
}

// nc 1 to 4 channels.
extern "C" int vr_windowed_warp(const float* vol, const float* tx,
                                const float* ty, const float* tz, float* out,
                                int nc, int d, int h, int w, int k,
                                cudaStream_t stream) {
  if ((long)nc * d * h * w > 2147483647L || d > 65535)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (nc) {
    case 1: err = launch_tile<1>(vol, tx, ty, tz, out, d, h, w, k, stream);
            break;
    case 2: err = launch_tile<2>(vol, tx, ty, tz, out, d, h, w, k, stream);
            break;
    case 3: err = launch_tile<3>(vol, tx, ty, tz, out, d, h, w, k, stream);
            break;
    case 4: err = launch_tile<4>(vol, tx, ty, tz, out, d, h, w, k, stream);
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// The tile (columns, rows) into out[0..1] and the dynamic shared bytes of a
// launch at window k into out[2].
extern "C" int vr_windowed_warp_geometry(int k, int* out) {
  out[0] = K11Tile::X;
  out[1] = K11Tile::Y;
  out[2] = k11_floats(k) * (int)sizeof(float);
  return 0;
}

// cudaFuncGetAttributes of the kernel at four channels (the history's
// material and scatter blends): registers per thread, static shared bytes
// per block, local bytes per thread and largest block into out[0..3];
// returns the error.
extern "C" int vr_windowed_warp_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)windowed_warp_kernel<4>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return (int)err;
}

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
// chunks of 4).
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/warp.k11_form): the
// narrow form indexes in 32 bits and puts a slice on each launch-grid z
// index; it takes every launch whose [NC, D, H, W] volume holds under 2^31
// floats, on at most VR_MAX_GRID_Z slices. Past that the wide form (I =
// int64_t): every froxel, target and channel index in 64 bits, the slices
// launched in parts of at most VR_MAX_GRID_Z (the block's slice is
// blockIdx.z + z0). An output reads only the volume and the targets, which
// K11 does not write, so the parts are independent and the wide form gives
// the narrow one's values bit for bit. Either form takes at most
// VR_MAX_GRID_Z row tiles on the launch grid's y axis.
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
template <class I>
__device__ __forceinline__ float target_offset(const float* __restrict__ t,
                                               I idx, int n, int base,
                                               float kf) {
  const float v = clampf(__ldg(t + idx), 0.0f, (float)n - 1.0f);
  return clampf(v - (float)base, -kf, kf);
}

template <int NC, class I = int>
__global__ void __launch_bounds__(K11Tile::X * K11Tile::Y,
                                  K11Tile::MIN_BLOCKS)
windowed_warp_kernel(const float* __restrict__ vol,
                     const float* __restrict__ tx_v,
                     const float* __restrict__ ty_v,
                     const float* __restrict__ tz_v, float* __restrict__ out,
                     int d, int h, int w, int k, int z_part) {
  constexpr int TX = K11Tile::X, TY = K11Tile::Y, NT = TX * TY;
  extern __shared__ float dyn_s[];  // k11_floats
  const int nx = region_nx(TX, k), ny = region_ny(TY, k);
  const float* oy_s = dyn_s;            // [TY][nx]
  const float* oz_s = dyn_s + TY * nx;  // [ny][nx]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  // the narrow form's slice is blockIdx.z; the wide form's part starts at
  // z_part
  const int z = blockIdx.z + (sizeof(I) > sizeof(int) ? z_part : 0);
  const I plane = (I)z * h * w;
  const float kf = (float)k;
  // the region's row r at clamp(yt - k + r), column c at clamp(xt - k + c);
  // the y offsets at the tile's rows yt + r (the last one clamped where the
  // tile passes the grid: those rows' threads read nothing)
  for (int j = tid; j < (TY + ny) * nx; j += NT) {
    const int r = j / nx, c = j - r * nx;
    const int col = clampi(xt - k + c, 0, w - 1);
    if (r < TY) {
      const int row = min(yt + r, h - 1);
      dyn_s[j] = target_offset(ty_v, plane + (I)row * w + col, h, row, kf);
    } else {
      const int row = clampi(yt - k + r - TY, 0, h - 1);
      dyn_s[j] = target_offset(tz_v, plane + (I)row * w + col, d, z, kf);
    }
  }
  __syncthreads();
  const int x = xt + tx, y = yt + ty;
  if (x >= w || y >= h) return;
  const I n = (I)d * h * w;
  const I i = plane + (I)y * w + x;
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

// Launches of the narrow (0) and wide (1) index forms since the library
// was loaded (vr_windowed_warp_index_forms).
static long g_index_forms[2];

// Whether the wide form takes a launch (mirrored by ops/warp.k11_form): at
// most VR_MAX_GRID_Z row tiles on the launch grid's y axis.
static bool k11_wide_fits(int h) {
  return (h + K11Tile::Y - 1) / K11Tile::Y <= VR_MAX_GRID_Z;
}

// Whether the narrow form takes it: what the wide form takes, with the
// [nc, D, H, W] volume under 2^31 floats on at most VR_MAX_GRID_Z slices.
static bool k11_narrow_fits(int nc, int d, int h, int w) {
  return k11_wide_fits(h) && !past_int(nc, (long)d * h * w)
         && d <= VR_MAX_GRID_Z;
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k11_form(int nc, int d, int h, int w) {
  if (k11_narrow_fits(nc, d, h, w)) return VR_FORM_NARROW;
  return k11_wide_fits(h) ? VR_FORM_WIDE : -1;
}

template <int NC, class I>
static int launch_tile(const float* vol, const float* tx, const float* ty,
                       const float* tz, float* out, int d, int h, int w,
                       int k, cudaStream_t stream) {
  constexpr int TX = K11Tile::X, TY = K11Tile::Y;
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  const auto kernel = windowed_warp_kernel<NC, I>;
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, d);
  const int shared = k11_floats(k) * (int)sizeof(float);
  if (shared > 48 * 1024) {  // a wide reprojection window
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  if (!WIDE) {
    kernel<<<grid, dim3(TX, TY), shared, stream>>>(vol, tx, ty, tz, out, d,
                                                   h, w, k, 0);
  } else {  // the slices in parts of at most VR_MAX_GRID_Z
    for (int z0 = 0; z0 < d; z0 += VR_MAX_GRID_Z) {
      grid.z = min(VR_MAX_GRID_Z, d - z0);
      kernel<<<grid, dim3(TX, TY), shared, stream>>>(vol, tx, ty, tz, out,
                                                     d, h, w, k, z0);
    }
  }
  ++g_index_forms[WIDE];
  return 0;
}

// The warp of nc channels (1 to 4).
template <class I>
static int launch_channels(const float* vol, const float* tx,
                           const float* ty, const float* tz, float* out,
                           int nc, int d, int h, int w, int k,
                           cudaStream_t stream) {
  switch (nc) {
    case 1: return launch_tile<1, I>(vol, tx, ty, tz, out, d, h, w, k, stream);
    case 2: return launch_tile<2, I>(vol, tx, ty, tz, out, d, h, w, k, stream);
    case 3: return launch_tile<3, I>(vol, tx, ty, tz, out, d, h, w, k, stream);
    case 4: return launch_tile<4, I>(vol, tx, ty, tz, out, d, h, w, k, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// nc 1 to 4 channels. form: VR_FORM_RULE (the size rule's, k11_form), or
// the narrow or the wide form, refused where it does not take the launch.
extern "C" int vr_windowed_warp_form(const float* vol, const float* tx,
                                     const float* ty, const float* tz,
                                     float* out, int nc, int d, int h, int w,
                                     int k, int form, cudaStream_t stream) {
  if (nc < 1 || nc > 4) return (int)cudaErrorInvalidValue;
  if (form == VR_FORM_RULE) form = k11_form(nc, d, h, w);
  const bool fits = form == VR_FORM_NARROW ? k11_narrow_fits(nc, d, h, w)
                    : form == VR_FORM_WIDE ? k11_wide_fits(h)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  const int err =
      form == VR_FORM_WIDE
          ? launch_channels<int64_t>(vol, tx, ty, tz, out, nc, d, h, w, k,
                                     stream)
          : launch_channels<int>(vol, tx, ty, tz, out, nc, d, h, w, k,
                                 stream);
  return err ? err : (int)cudaGetLastError();
}

// The size rule's form for a launch of nc channels into out[0] (-1: past
// the wide form too) and its launch's slice parts into out[1].
extern "C" int vr_windowed_warp_form_of(int nc, int d, int h, int w,
                                        int* out) {
  out[0] = k11_form(nc, d, h, w);
  out[1] = out[0] == VR_FORM_WIDE ? grid_part_count(d) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_windowed_warp_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
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
// material and scatter blends), narrow then wide: registers per thread,
// static shared bytes per block, local bytes per thread and largest block
// into out[4 i .. 4 i + 3]; returns the error.
template <class I>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)windowed_warp_kernel<4, I>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_windowed_warp_attrs(int* out) {
  const cudaError_t errs[2] = {attrs_of<int>(out),
                               attrs_of<int64_t>(out + 4)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

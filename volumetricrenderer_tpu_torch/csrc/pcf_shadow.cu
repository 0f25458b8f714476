// K12 pcf_shadow: the cascaded-PCF sun shadow volume of the shadow-map
// modes.
//
// Replaces volumetricrenderer_tpu/ops/pallas/pcf_shadow.py `_kernel` /
// `pcf_dir_shadow_pallas` (:222, :355). The TPU kernel ran one z slice per
// grid step and, because Mosaic gathers only along 128 lanes, fetched the
// four PCF taps in two passes (a column gather of a 512x512 atlas window,
// a transpose, a row gather) over a doubled-lane x layout. On the GPU each
// thread reads its taps straight from the atlas: no window, no transposes.
//
// Per froxel (z, y, x) of the grid it is given (full rate, or the low-rate
// grid of dir_shadow_subsample) and per sun: the jittered world position
// (for the split-sphere select), then over the slice's count[z] active
// cascades in order[z] (ops/pcf_shadow.schedule):
//   u = a_u x + c_u, v = a_v x + b_v y + c_v, ref = a_r x + b_r y + c_r,
//   four taps at (floor(v) + dy, floor(u) + dx) clamped to the atlas,
//   lit = ref <= stored weighted bilinearly, and the one-hot mask (inside
//   cascade ci's sphere and not inside ci - 1's);
// then cmp + (1 - min(sum of masks, 1)) (fully lit outside every cascade),
// the lerp to the strength, the square, the has_shadow gate and, where the
// schedule flagged a window overflow, the NaN poison: the arithmetic of the
// TPU kernel and of the twin ops/pcf_shadow.pcf_shadow_plain, in their
// order (no FMA contraction), so that a compare flips only for a coordinate
// within ulps of a texel edge.
//
// A block owns a 16x16 tile (K12Tile) of one slice of one sun (grid z =
// sun x slice: all suns in one launch), a block of 16 x 4 threads. Before
// its one barrier its threads compute, each an item, what the froxels
// share: per column the view-space x and its three world products, and per
// cascade u, floor(u), its fraction, the two clamped atlas columns and the
// x products of v and ref; per row the clamped y, the view-space y and its
// products, and per cascade the y products of v and ref; the slice's view
// depth (each of those items computes it again: the same float) and its
// products; the slice's count, order, the cascades' constant terms and the
// split spheres. Then each thread takes 4 froxels of its column (rows 4
// apart, so a warp stores 2 rows of 16 at a time): three sums each for the
// world position and, per active cascade, the column's terms read once for
// the 4, two sums each for v and ref, the four taps, the compare, the
// sphere tests and the accumulation. A thread per froxel computed all of
// these itself: the depth mapping's log and exp and four divisions for the
// world position, per cascade eight coefficient loads and u's floor and
// clamps, with a 64-bit index split by division. Every value is that
// form's, from the same expressions in the same order (a product computed
// once is the float each froxel computed), so the volume is bit for bit
// the same.
// A thread a froxel in 16x16 threads ran 20-29% slower than 4 froxels a
// thread, 16x8 threads with 2 froxels each 4-9% slower (PERF.md §6). The
// atlas is read through L1 and L2, not staged: a tile's footprint holds
// more texels than its 1024 taps at the low rate (~3 texels a column
// step).
//
// Index forms (common.cuh VR_FORM_*; mirrored by ops/pcf_shadow.k12_form):
// the narrow form indexes in 32 bits and puts a (sun, slice) on each
// launch-grid z index; it takes every launch whose volumes [Nd, D, H, W],
// atlases [Nd, S2, S2] and cascade tables [Nd, D, C, 8] hold under 2^31
// floats, on at most VR_MAX_GRID_Z (sun, slice) pairs. Past that the wide
// form (I = int64_t): the suns' tables, the atlas rows and the output in
// 64 bits, the flat (sun, slice) index launched in parts of at most
// VR_MAX_GRID_Z, each block's index the part's first plus blockIdx.z and
// split into (sun, slice) after that. A sun's own tables (count, order,
// coef by slice) stay indexed in 32 bits: the wide form takes a sun's
// [D, C, 8] cascade table under 2^31 floats. An output reads only the
// tables and the atlas, so the parts are independent and the wide form
// gives the narrow one's values bit for bit. Either form takes at most
// VR_MAX_GRID_Z row tiles on the launch grid's y axis.
//
// Bound on the H100: bytes. At 240x135x128 froxels, low rate (120x135x64)
// with one sun: 4.1 MB of output and a 4.2 MB atlas read once, ~2.5 us at
// 3.35 TB/s; full rate ~6 us. The atlas stays in the 50 MB L2, and
// neighbouring threads read neighbouring texels; with ~1.5 active cascades
// per slice the work is ~100 flops per froxel.
#include "common.cuh"

// The tile: a block of X x Y threads, MIN_BLOCKS of them an SM (the launch
// bounds), each thread R froxels of its column (rows Y apart), so the tile
// is X columns x Y R rows (mirrored by ops/pcf_shadow.K12_TILE and
// K12_ROWS_PER_THREAD).
struct K12Tile {
  static constexpr int X = 16, Y = 4, R = 4, MIN_BLOCKS = 16;
  static constexpr int ROWS = Y * R;
};

// The block's dynamic shared memory at nc cascades, in floats (the ints
// stored as their bits): the slice's three world products of the view
// depth and its count; order; (c_v, c_r) and the split sphere of each
// cascade; per column (x) the three world products of vx, then per cascade
// fu, the two atlas columns, a_v x and a_r x; per row (y) the three world
// products of vy, then per cascade b_v y and b_r y. Mirrored by
// ops/pcf_shadow.k12_shared_bytes.
__host__ __device__ __forceinline__ int k12_floats(int nc) {
  return 4 + 7 * nc + K12Tile::X * (3 + 5 * nc)
         + K12Tile::ROWS * (3 + 2 * nc);
}

__device__ __forceinline__ float inside_sphere(const float* sph, int ci,
                                               float wx, float wy, float wz) {
  const float dx = wx - sph[ci * 4 + 0];
  const float dy = wy - sph[ci * 4 + 1];
  const float dz = wz - sph[ci * 4 + 2];
  return dx * dx + dy * dy + dz * dz < sph[ci * 4 + 3] ? 1.0f : 0.0f;
}

// The tables of sun li lie at these strides from the first sun's (I: the
// index type of the strides).
struct K12Sun {
  const float *par, *coef, *sph, *atlas;
  const int *order, *count;
};

template <class I>
__device__ __forceinline__ K12Sun k12_sun(const float* par, const float* coef,
                                          const int* order, const int* count,
                                          const float* sph,
                                          const float* atlas, int li, int d,
                                          int nc, int s2) {
  return {par + 24 * (I)li, coef + (I)li * d * nc * 8, sph + (I)li * nc * 4,
          atlas + (I)li * s2 * s2, order + (I)li * d * nc,
          count + (I)li * d};
}

// The jittered view depth of slice z (dir_shadow.froxel_world's mapping).
__device__ __forceinline__ float k12_vz(const float* par, int z, int d) {
  const float fz = (float)z + 0.5f + par[7];
  return (expf(logf(par[2]) * fz / (float)d) - 1.0f) * par[3] + par[4];
}

template <class I = int>
__global__ void __launch_bounds__(K12Tile::X * K12Tile::Y,
                                  K12Tile::MIN_BLOCKS)
pcf_shadow_kernel(const float* __restrict__ par_all,
                  const float* __restrict__ coef_all,
                  const int* __restrict__ order_all,
                  const int* __restrict__ count_all,
                  const float* __restrict__ sph_all,
                  const float* __restrict__ atlas_all, int w, int h, int d,
                  int h_glob, int s2, int nc, float* __restrict__ out,
                  I b_part) {
  constexpr bool WIDE = sizeof(I) > sizeof(int);
  constexpr int TX = K12Tile::X, TY = K12Tile::ROWS, R = K12Tile::R;
  constexpr int NT = TX * K12Tile::Y;
  extern __shared__ float k12_s[];  // k12_floats(nc)
  int* k12_i = reinterpret_cast<int*>(k12_s);
  float* slice_s = k12_s;                   // [3] + count
  int* order_s = k12_i + 4;                 // [nc]
  float* cterm_s = k12_s + 4 + nc;          // [nc][2]
  float* sph_s = cterm_s + 2 * nc;          // [nc][4]
  float* col_s = sph_s + 4 * nc;            // [3 + 5 nc][TX]
  float* row_s = col_s + TX * (3 + 5 * nc); // [3 + 2 nc][TY]
  int* col_i = reinterpret_cast<int*>(col_s);

  const int tx = threadIdx.x, tid = threadIdx.y * TX + tx;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  // the flat (sun, slice) index: blockIdx.z in the narrow form, the
  // part's first index b_part + blockIdx.z in the wide one, split after the
  // offset
  const I bz = WIDE ? (I)blockIdx.z + b_part : (I)0;
  int li, z;
  if constexpr (WIDE) {
    li = (int)(bz / d);
    z = (int)(bz - (I)li * d);
  } else {
    li = blockIdx.z / d;
    z = blockIdx.z - li * d;
  }
  const K12Sun S = k12_sun<I>(par_all, coef_all, order_all, count_all,
                              sph_all, atlas_all, li, d, nc, s2);
  const float* par = S.par;

  // 1. the items, one a thread: columns (x, c) and rows (y, c), c = 0 the
  // view-space term and c = 1 + ci cascade ci's; then the slice's tables
  const int n_col = TX * (1 + nc), n_row = TY * (1 + nc);
  const int n_items = n_col + n_row + 1 + nc * 7;
  for (int j = tid; j < n_items; j += NT) {
    if (j < n_col) {
      const int x = j % TX, c = j / TX;
      const float xs = (float)(xt + x);
      if (c == 0) {
        const float vz = k12_vz(par, z, d);
        const float vx =
            (2.0f * (xs + 0.5f + par[5]) / (float)w - 1.0f) * vz / par[0];
        col_s[x] = par[8] * vx;
        col_s[TX + x] = par[12] * vx;
        col_s[2 * TX + x] = par[16] * vx;
        if (x == 0) {
          slice_s[0] = par[10] * vz;
          slice_s[1] = par[14] * vz;
          slice_s[2] = par[18] * vz;
        }
      } else {
        const int ci = c - 1;
        const float* q = S.coef + (z * nc + ci) * 8;
        const float u = q[0] * xs + q[1];
        const float u0 = floorf(u);
        float* cc = col_s + (3 + 5 * ci) * TX;
        int* ci_i = col_i + (3 + 5 * ci) * TX;
        cc[x] = u - u0;
        ci_i[TX + x] = clampi((int)u0, 0, s2 - 1);
        ci_i[2 * TX + x] = clampi((int)u0 + 1, 0, s2 - 1);
        cc[3 * TX + x] = q[2] * xs;
        cc[4 * TX + x] = q[5] * xs;
      }
    } else if (j < n_col + n_row) {
      const int y = (j - n_col) % TY, c = (j - n_col) / TY;
      const float ys =
          clampf((float)(yt + y) + par[21], 0.0f, (float)h_glob - 1.0f);
      if (c == 0) {
        const float vz = k12_vz(par, z, d);
        const float vy = (2.0f * (ys + 0.5f + par[6]) / (float)h_glob - 1.0f)
                         * vz / par[1];
        row_s[y] = par[9] * vy;
        row_s[TY + y] = par[13] * vy;
        row_s[2 * TY + y] = par[17] * vy;
      } else {
        const float* q = S.coef + (z * nc + c - 1) * 8;
        float* rc = row_s + (3 + 2 * (c - 1)) * TY;
        rc[y] = q[3] * ys;
        rc[TY + y] = q[6] * ys;
      }
    } else {
      const int k = j - n_col - n_row;
      if (k == 0) {
        k12_i[3] = S.count[z];
      } else if (k <= nc) {
        order_s[k - 1] = S.order[z * nc + k - 1];
      } else if (k <= 3 * nc) {
        const int ci = (k - 1 - nc) / 2, e = (k - 1 - nc) % 2;
        cterm_s[2 * ci + e] = S.coef[(z * nc + ci) * 8 + (e ? 7 : 4)];
      } else {
        sph_s[k - 1 - 3 * nc] = S.sph[k - 1 - 3 * nc];
      }
    }
  }
  const float sr = par[20], gate = par[22], poison = par[23];
  const float wx0 = par[11], wy0 = par[15], wz0 = par[19];
  __syncthreads();
  const int x = xt + tx;
  if (x >= w) return;

  // 2. the thread's froxels, rows ty + Y j of the tile: their jittered
  // world positions, then the active cascades, each cascade's column terms
  // read once for them all
  float wx[R], wy[R], wz[R], acc_cmp[R], acc_mask[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int ty = threadIdx.y + K12Tile::Y * j;
    wx[j] = col_s[tx] + row_s[ty] + slice_s[0] + wx0;
    wy[j] = col_s[TX + tx] + row_s[TY + ty] + slice_s[1] + wy0;
    wz[j] = col_s[2 * TX + tx] + row_s[2 * TY + ty] + slice_s[2] + wz0;
    acc_cmp[j] = 0.0f;
    acc_mask[j] = 0.0f;
  }
  const int n_act = k12_i[3];
  const float* atlas = S.atlas;
  for (int k = 0; k < n_act; ++k) {
    const int ci = order_s[k];
    const float* cc = col_s + (3 + 5 * ci) * TX;
    const int* ci_i = col_i + (3 + 5 * ci) * TX;
    const float* rc = row_s + (3 + 2 * ci) * TY;
    const float fu = cc[tx];
    const int gu0 = ci_i[TX + tx];
    const int gu1 = ci_i[2 * TX + tx];
    const float v_x = cc[3 * TX + tx], ref_x = cc[4 * TX + tx];
    const float v_c = cterm_s[2 * ci], ref_c = cterm_s[2 * ci + 1];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int ty = threadIdx.y + K12Tile::Y * j;
      const float v = v_x + rc[ty] + v_c;
      const float ref = ref_x + rc[TY + ty] + ref_c;
      const float v0 = floorf(v);
      const float fv = v - v0;
      const I r0 = (I)clampi((int)v0, 0, s2 - 1) * s2;
      const I r1 = (I)clampi((int)v0 + 1, 0, s2 - 1) * s2;
      const float le00 = ref <= __ldg(atlas + r0 + gu0) ? 1.0f : 0.0f;
      const float le01 = ref <= __ldg(atlas + r0 + gu1) ? 1.0f : 0.0f;
      const float le10 = ref <= __ldg(atlas + r1 + gu0) ? 1.0f : 0.0f;
      const float le11 = ref <= __ldg(atlas + r1 + gu1) ? 1.0f : 0.0f;
      const float cmp = (1.0f - fv) * ((1.0f - fu) * le00 + fu * le01) +
                        fv * ((1.0f - fu) * le10 + fu * le11);
      const float prev =
          ci > 0 ? inside_sphere(sph_s, ci - 1, wx[j], wy[j], wz[j]) : 0.0f;
      const float mask =
          inside_sphere(sph_s, ci, wx[j], wy[j], wz[j]) * (1.0f - prev);
      acc_cmp[j] = acc_cmp[j] + mask * cmp;
      acc_mask[j] = acc_mask[j] + mask;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = yt + threadIdx.y + K12Tile::Y * j;
    if (y >= h) break;
    const float cmp = acc_cmp[j] + (1.0f - fminf(acc_mask[j], 1.0f));
    const float vis = sr + (1.0f - sr) * cmp;
    float res = 1.0f + gate * (vis * vis - 1.0f);
    if (poison > 0.0f) res = res + __int_as_float(0x7fc00000);  // NaN
    if constexpr (WIDE) {
      out[(bz * h + y) * w + x] = res;
    } else {
      out[((blockIdx.z * h) + y) * w + x] = res;
    }
  }
}

// Launches of the narrow (0) and wide (1) index forms since the library
// was loaded (vr_pcf_shadow_index_forms).
static long g_index_forms[2];

// Whether the wide form takes nd suns' launch (mirrored by
// ops/pcf_shadow.k12_form): at most VR_MAX_GRID_Z row tiles on the launch
// grid's y axis, a sun's cascade table [d, nc, 8] under 2^31 floats.
static bool k12_wide_fits(int h, int d, int nc) {
  return (h + K12Tile::ROWS - 1) / K12Tile::ROWS <= VR_MAX_GRID_Z
         && !past_int(d, 8L * nc);
}

// Whether the narrow form takes it: what the wide form takes, with the
// volumes [nd, d, h, w], the atlases [nd, s2, s2] and the cascade tables
// [nd, d, nc, 8] under 2^31 floats, on at most VR_MAX_GRID_Z (sun, slice)
// pairs.
static bool k12_narrow_fits(int w, int h, int d, int s2, int nc, int nd) {
  return k12_wide_fits(h, d, nc) && !past_int(nd, (long)d * h * w)
         && !past_int(nd, (long)s2 * s2) && !past_int(nd, 8L * d * nc)
         && (long)nd * d <= VR_MAX_GRID_Z;
}

// The size rule's form: narrow where it fits, else wide, else -1.
static int k12_form(int w, int h, int d, int s2, int nc, int nd) {
  if (k12_narrow_fits(w, h, d, s2, nc, nd)) return VR_FORM_NARROW;
  return k12_wide_fits(h, d, nc) ? VR_FORM_WIDE : -1;
}

// The parts of the flat (sun, slice) launch-grid axis of nd x d blocks.
static long k12_parts(int d, int nd) {
  return ((long)nd * d + VR_MAX_GRID_Z - 1) / VR_MAX_GRID_Z;
}

// K12 for the nd suns whose tables lie one after the other (par [nd, 24],
// coef [nd, d, nc, 8], order [nd, d, nc], count [nd, d], spheres [nd, nc,
// 4], atlas [nd, s2, s2]) into out [nd, d, h, w]: the narrow form in one
// launch, the wide form in k12_parts launches. form: VR_FORM_RULE (the size
// rule's, k12_form), or the narrow or the wide form, refused where it does
// not take the launch.
extern "C" int vr_pcf_shadow_form(const float* par, const float* coef,
                                  const int* order, const int* count,
                                  const float* sph, const float* atlas, int w,
                                  int h, int d, int h_glob, int s2, int nc,
                                  int nd, float* out, int form,
                                  cudaStream_t stream) {
  if (form == VR_FORM_RULE) form = k12_form(w, h, d, s2, nc, nd);
  const bool fits = form == VR_FORM_NARROW
                        ? k12_narrow_fits(w, h, d, s2, nc, nd)
                    : form == VR_FORM_WIDE ? k12_wide_fits(h, d, nc)
                                           : false;
  if (!fits) return (int)cudaErrorInvalidValue;
  constexpr int TX = K12Tile::X, TY = K12Tile::ROWS;
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, 1);
  const int shared = k12_floats(nc) * (int)sizeof(float);
  const dim3 block(TX, K12Tile::Y);
  if (form == VR_FORM_NARROW) {
    grid.z = nd * d;
    pcf_shadow_kernel<int><<<grid, block, shared, stream>>>(
        par, coef, order, count, sph, atlas, w, h, d, h_glob, s2, nc, out,
        0);
  } else {  // the flat (sun, slice) index in parts of at most VR_MAX_GRID_Z
    const long n = (long)nd * d;
    for (long b0 = 0; b0 < n; b0 += VR_MAX_GRID_Z) {
      grid.z = (unsigned)(n - b0 < VR_MAX_GRID_Z ? n - b0 : VR_MAX_GRID_Z);
      pcf_shadow_kernel<int64_t><<<grid, block, shared, stream>>>(
          par, coef, order, count, sph, atlas, w, h, d, h_glob, s2, nc, out,
          (int64_t)b0);
    }
  }
  ++g_index_forms[form];
  return (int)cudaGetLastError();
}

// One sun's K12 in the size rule's form.
extern "C" int vr_pcf_shadow(const float* par, const float* coef,
                             const int* order, const int* count,
                             const float* sph, const float* atlas, int w,
                             int h, int d, int h_glob, int s2, int nc,
                             float* out, cudaStream_t stream) {
  return vr_pcf_shadow_form(par, coef, order, count, sph, atlas, w, h, d,
                            h_glob, s2, nc, 1, out, VR_FORM_RULE, stream);
}

// The size rule's form for nd suns into out[0] (-1: past the wide form
// too) and its launch's parts of the flat (sun, slice) axis into out[1].
extern "C" int vr_pcf_shadow_form_of(int w, int h, int d, int s2, int nc,
                                     int nd, int* out) {
  out[0] = k12_form(w, h, d, s2, nc, nd);
  out[1] = out[0] == VR_FORM_WIDE ? (int)k12_parts(d, nd) : 1;
  return 0;
}

// The launches of the narrow and the wide form so far into out[0..1].
extern "C" int vr_pcf_shadow_index_forms(int* out) {
  out[0] = (int)g_index_forms[0];
  out[1] = (int)g_index_forms[1];
  return 0;
}

// The tile (columns, rows), the dynamic shared bytes at nc cascades and
// the block's rows of threads into out[0..3].
extern "C" int vr_pcf_shadow_geometry(int nc, int* out) {
  out[0] = K12Tile::X;
  out[1] = K12Tile::ROWS;
  out[2] = k12_floats(nc) * (int)sizeof(float);
  out[3] = K12Tile::Y;
  return 0;
}

// cudaFuncGetAttributes of the kernel, narrow then wide: registers per
// thread, static shared bytes per block, local bytes per thread and largest
// block into out[4 i .. 4 i + 3]; returns the error.
template <class I>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)pcf_shadow_kernel<I>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_pcf_shadow_attrs(int* out) {
  const cudaError_t errs[2] = {attrs_of<int>(out),
                               attrs_of<int64_t>(out + 4)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

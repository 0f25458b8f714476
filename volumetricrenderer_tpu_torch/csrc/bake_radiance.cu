// K1 bake_radiance: the low-rate local-light radiance + fBm bake.
//
// Replaces stage 0 of the TPU megakernel
// (volumetricrenderer_tpu/ops/pallas/frame_fused.py `_kernel`, lines
// 179-262: the inline radiance bake with INLINE_VIS), which baked low slices
// into a VMEM ring just ahead of the scatter that reads them; and the
// standalone TPU kernel that bakes the same volume for the staged frame
// (volumetricrenderer_tpu/ops/pallas/visibility.py `_radiance_kernel` /
// `bake_radiance_pallas`). Here the whole
// low volume [3 + n_noise, DL, HL, WL] is baked up front into device memory
// (65,280 samples at FULL, ss=4: 1 MB), before shadow_scatter reads it.
//
// Per low sample: the jittered world position (visibility.bake_world_planes),
// the camera direction, phase g, then for every local light that
// low_slice_active keeps for this low slice the light factor (falloff x
// cone x HG) and an any-hit shadow ray, summed in light order; then one fBm
// factor per noise-bearing medium. The shadow ray is common.cuh any_hit:
// with heightfield_local_shadows it also marches the terrain (hf_steps fBm
// samples over the band it crosses), and with fractional boxes it returns an
// occlusion amount, not 0 or 1.
//
// Bound on the H100: operations. The bytes are tiny (1 MB out); each
// sample runs up to 16 lights x 7 primitive tests plus 3 Perlin octaves,
// ~2-4k flops, so ~0.2 GFLOP in all -- a few microseconds at the fp32 rate.
// A thread per sample walking its lights in series ran at 10x that: a slab
// shard's 19,200 samples took as long as the grid's 65,280, each thread a
// chain of 16 light iterations and 3 octaves. So the lights of a sample are
// spread over warps. A block of K1_WARPS warps owns a patch of one low
// slice in `groups` light groups, each group's warps holding the patch's
// samples (lane = sample, a warp's 32 a 16 x 2 patch: a warp keeps one
// light at a time and the slice's culling, and its control flow stays
// uniform):
//   1. the light group 0 warps compute each sample's world position, view
//      direction and phase terms into shared memory;
//   2. each pass over 32 lights: every warp takes the slice's active lights
//      of the pass from one ballot of low_slice_active, in light order, and
//      light group g the items q = g mod groups: the pairs (sample, q-th
//      active light), light_factor x (1 - any_hit x gate) into shared
//      memory; after the first pass's lights the fBm channels, one item an
//      octave (perlin_fbm's loop body into shared memory);
//   3. after a barrier the light group 0 warps add the pass's pairs x the
//      light colour into their sample's sums, in light order, from 0, and
//      sum the octaves as perlin_fbm does -- the parent's products and sums
//      in the parent's order, so the result is bit for bit the
//      thread-per-sample form's. The sums carry over the passes: no cap on
//      the light count.
// With one light group (one light and no fBm channel: demo_scene's spot
// light) there is nothing to exchange, and each thread runs the
// thread-per-sample loop. A pair skips what cannot change it (k1_pair):
// the any-hit ray where the light factor is 0, and without the arms the
// whole pair where the light's range culls the sample; the plane and sphere
// tests of the rays leave before a division or a root whose answer is known
// (common.cuh any_hit's EARLY). All tables stay in device memory, read
// through the read-only cache; lights are looped at run time.
//
// The block stages its fBm items in static shared arrays of VR_MAX_NOISE
// channels. More channels take the GEN instantiation of the light-group
// kernel (one light group never has more than one item): the same items in
// dynamic shared memory after the octaves (k1_shared grows by
// K1_OCT + 2 ints a channel), set above 48 KB by the launcher where the
// channels need it. Every value is the fixed form's.
//
// Past the channels whose octaves and items fit a block's shared memory
// (426 and more at 16 lights, 422 at 32 or more) the launcher takes the
// CHUNKED instantiation: the GEN kernel with its first `chunk` channels
// staged as GEN stages them (chunk the most that fits beside the terms and
// one pass's pairs, k1_chunk_of), and every channel past them a whole
// channel an item -- noise_factor written straight out, as GEN's items of
// more than K1_OCT octaves are -- light group g taking every groups-th, in
// the first pass before its barrier. perlin_fbm sums its octaves as the
// spread sum does, so every channel is GEN's bit for bit.
#include "common.cuh"

// A block's warps and their launch bounds (blocks an SM), the lights of a
// pass (one ballot), and a warp's samples: K1_WX columns x 32 / K1_WX rows
// of its low slice (a patch, so that a light's range and cone cut through
// few warps; 16 x 2 measured faster than 8 x 4, 4 x 8 and 32 x 1).
#define K1_WARPS 4
#define K1_MIN_BLOCKS 8
#define K1_MIN_BLOCKS_ARMS 6  // the arms' terrain march: 85 registers
#define K1_PASS 32
#define K1_WX 16
#define K1_WY (32 / K1_WX)
// The per-sample terms in shared memory: world position, view direction,
// phase g, g^2 and the HG numerator; and the octaves of an fBm channel that
// are items of their own (a channel of more octaves is one item).
#define K1_TERMS 9
#define K1_OCT 4

// The light groups of a launch: the least power of two that takes every
// item of the first pass (its lights and the fBm channels), at most
// K1_WARPS. Mirrored by ops/frame_fused.k1_geometry, as are the rest.
__host__ __device__ __forceinline__ int k1_groups(int n_lights, int n_noise) {
  const int items = (n_lights < K1_PASS ? n_lights : K1_PASS) + n_noise;
  int g = 1;
  while (g < items && g < K1_WARPS) g *= 2;
  return g;
}

// Whether the launch takes the general form: more fBm channels than the
// fixed form's static arrays hold.
__host__ __device__ __forceinline__ bool k1_general(int n_noise) {
  return n_noise > VR_MAX_NOISE;
}

// Dynamic shared memory, floats: the terms of each of the block's samples,
// then the pairs of one pass (a light of the pass and a sample each), then
// the octaves of each fBm channel; in the general form then the fBm items
// (K1_OCT a channel), each channel's medium and its octaves, as ints; none
// with one light group, whose threads keep their samples' terms and sums.
__host__ __device__ __forceinline__ int k1_shared(int n_lights, int n_noise,
                                                  int groups, int samples) {
  if (groups == 1) return 0;
  return (K1_TERMS + (n_lights < K1_PASS ? n_lights : K1_PASS)
          + n_noise * K1_OCT) * samples
         + (k1_general(n_noise) ? n_noise * (K1_OCT + 2) : 0);
}

// The chunked form's dynamic shared memory, floats: GEN's with its first
// `chunk` channels staged (their items always in dynamic shared memory).
__host__ __device__ __forceinline__ long k1_chunked_shared(int n_lights,
                                                           int chunk,
                                                           int samples) {
  return (long)(K1_TERMS + (n_lights < K1_PASS ? n_lights : K1_PASS)
                + chunk * K1_OCT) * samples
         + (long)chunk * (K1_OCT + 2);
}

// The channels the chunked form stages: the most whose octaves and items
// fit a block's shared memory (common.cuh VR_MAX_SHARED, less
// VR_TILE_STATIC) beside the terms and one pass's pairs, at most n_noise
// (mirrored by ops/frame_fused.k1_geometry's chunk).
inline int k1_chunk_of(int n_lights, int n_noise, int samples) {
  const long room = (VR_MAX_SHARED - VR_TILE_STATIC) / (long)sizeof(float)
                    - k1_chunked_shared(n_lights, 0, samples);
  const long c = room / (K1_OCT * samples + K1_OCT + 2);
  return c < n_noise ? (int)c : n_noise;
}

// The medium of fBm channel ni: the ni-th noise-bearing one.
__device__ __forceinline__ int noise_medium(const VrTables& T, int ni) {
  int mi = 0;
  for (int left = ni; mi < T.n_media; ++mi)
    if (T.med_static[6 * mi] && left-- == 0) break;
  return mi;
}

// The terms of low sample (m, r, c): its jittered world position
// (visibility.bake_world_planes), view direction
// (visibility.radiance_view_dirs), phase g, g^2 and the HG numerator.
__device__ __forceinline__ void k1_terms(const VrTables& T, int m, int r,
                                         int c, float* v) {
  const float* p = T.spar;
  float wx, wy, wz;
  low_sample_world(T, m, r, c, wx, wy, wz);
  float vdx = wx - p[20], vdy = wy - p[21], vdz = wz - p[22];
  const float inv = rsqrt_exact(vdx * vdx + vdy * vdy + vdz * vdz + 1e-18f);
  const float phg = phase_g(T, wx, wy, wz);
  const float g2 = phg * phg;
  v[0] = wx;
  v[1] = wy;
  v[2] = wz;
  v[3] = vdx * inv;
  v[4] = vdy * inv;
  v[5] = vdz * inv;
  v[6] = phg;
  v[7] = g2;
  v[8] = (1.0f - g2) / (float)(4.0 * VR_PI);
}

// The position of the q-th set bit of `bits`.
__device__ __forceinline__ int nth_bit(unsigned bits, int q) {
  for (; q > 0; --q) bits &= bits - 1;
  return __ffs(bits) - 1;
}

// The pair (sample, light row ql) of terms t (stride ns): light_factor x
// (1 - any_hit x gate), the thread-per-sample form's value or, where it is
// certainly +-0, +-0 -- which adds nothing to a sum that starts from +0 (an
// exact +0 or -0 term leaves every partial sum, never -0, as it is).
// Certainly +-0: light_factor returns +-0 (then the any-hit ray, which can
// only scale it, is not cast); or, without the arms (with them this test
// measured slower), the light's range culls the sample: d2 >= range^2
// clamps the falloff to 0, and with a finite multiplier, spot flag and gate
// and |g| <= 0.9, which keeps the HG term finite, every factor after it is
// finite.
template <bool ARMS>
__device__ __forceinline__ float k1_pair(const VrTables& T, const float* ql,
                                         float wx, float wy, float wz,
                                         const float* t, int ns) {
  const float phg = t[6 * ns];
  const float tx = wx - ql[0], ty = wy - ql[1], tz = wz - ql[2];
  const float d2 = tx * tx + ty * ty + tz * tz;
  const float r2 = ql[6] * ql[6];
  const float big = 3.4028235e38f;  // the largest float: not inf, not NaN
  if (!ARMS && d2 >= r2 && r2 > 0.0f && fabsf(phg) <= 0.9f
      && fabsf(ql[7]) <= big && fabsf(ql[8]) <= big && fabsf(ql[14]) <= big)
    return 0.0f;
  float ldx, ldy, ldz, dist;
  const float factor = light_factor(ql, wx, wy, wz, t[3 * ns], t[4 * ns],
                                    t[5 * ns], phg, t[7 * ns], t[8 * ns],
                                    ldx, ldy, ldz, dist);
  float occ = 0.0f;
  if (factor != 0.0f)
    occ = any_hit<ARMS, false, true>(T, wx, wy, wz, -ldx, -ldy, -ldz,
                                     dist - 0.05f, T.hf_local);
  return factor * (1.0f - occ * ql[14]);
}

// SPREAD: light groups > 1; else the thread-per-sample loop, a kernel of
// its own so that it keeps the registers it needs (the parent's 45 and 67).
// GEN (SPREAD only): the fBm items in dynamic shared memory. CHUNKED (GEN
// only): the first `chunk` channels staged, the rest whole channels.
template <bool ARMS, bool SPREAD, bool GEN = false, bool CHUNKED = false>
__global__ void __launch_bounds__(32 * K1_WARPS,
                                  !SPREAD ? 1
                                  : ARMS  ? K1_MIN_BLOCKS_ARMS
                                          : K1_MIN_BLOCKS)
bake_radiance_kernel(VrTables T, float* __restrict__ out, int groups,
                     int runs_x, int runs_y, int chunk) {
  extern __shared__ float k1_s[];  // k1_shared
  const int sw = K1_WARPS / groups;  // warps of a light group
  const int ns = 32 * sw;            // samples of the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / sw;           // this warp's light group
  const int wi = warp - g * sw;      // its place in the group
  const int s = wi * 32 + lane;      // its lane's sample in the block
  const int per_slice = runs_x * runs_y;
  const int m = blockIdx.x / per_slice;  // low slice
  const int b = blockIdx.x - m * per_slice;
  const int by = b / runs_x, bx = b - by * runs_x;
  // the group's warps one below the other: a block's patch is K1_WX
  // columns x sw * K1_WY rows
  const int c = bx * K1_WX + lane % K1_WX;
  const int r = (by * sw + wi) * K1_WY + lane / K1_WX;
  const bool valid = c < T.wl && r < T.hl;
  float* terms = k1_s;               // [K1_TERMS][ns]
  float* pairs = k1_s + K1_TERMS * ns;
  const long plane = (long)T.dl * T.hl * T.wl;
  const long i = ((long)m * T.hl + r) * T.wl + c;

  if constexpr (!SPREAD) {  // the thread-per-sample loop, k1_pair's exits
    float v[K1_TERMS];
    k1_terms(T, m, min(r, T.hl - 1), min(c, T.wl - 1), v);
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
    for (int li = 0; li < T.n_lights; ++li) {
      if (!T.active[li * T.dl + m]) continue;
      const float* ql = T.lights + 16 * li;
      const float base = k1_pair<ARMS>(T, ql, v[0], v[1], v[2], v, 1);
      acc_r = acc_r + base * ql[3];
      acc_g = acc_g + base * ql[4];
      acc_b = acc_b + base * ql[5];
    }
    if (!valid) return;
    out[i] = acc_r;
    out[plane + i] = acc_g;
    out[2 * plane + i] = acc_b;
    for (int mi = 0, ni = 0; mi < T.n_media && ni < T.n_noise; ++mi)
      if (T.med_static[6 * mi])
        out[(3 + ni++) * plane + i] = noise_factor(T, mi, v[0], v[1], v[2]);
    return;
  }

  // The block's tables, staged by the last warp (a warp of a light group
  // past 0, idle in step 1) so that no later step waits on a chain of
  // table loads: the pass's light colours (its lane's light), and the
  // first pass's fBm items, (channel, octave) each, octave 7 for a whole
  // channel of more than K1_OCT octaves, with each channel's medium and
  // octaves.
  __shared__ float colour_s[3][K1_PASS];
  __shared__ int fbm_item_s[GEN ? 1 : VR_MAX_NOISE * K1_OCT];
  __shared__ int fbm_mi_s[GEN ? 1 : VR_MAX_NOISE];
  __shared__ int fbm_oct_s[GEN ? 1 : VR_MAX_NOISE], fbm_n;
  int* fbm_item = fbm_item_s;
  int* fbm_mi = fbm_mi_s;
  int* fbm_oct = fbm_oct_s;
  if constexpr (GEN) {  // after the octaves (k1_shared)
    fbm_item = reinterpret_cast<int*>(
        pairs + ((T.n_lights < K1_PASS ? T.n_lights : K1_PASS)
                 + (CHUNKED ? chunk : T.n_noise) * K1_OCT) * ns);
    fbm_mi = fbm_item + (CHUNKED ? chunk : T.n_noise) * K1_OCT;
    fbm_oct = fbm_mi + (CHUNKED ? chunk : T.n_noise);
  }
  const bool stager = warp == K1_WARPS - 1;
  if (stager && lane == 0) {
    int u = 0;
    for (int ni = 0; ni < (CHUNKED ? chunk : T.n_noise); ++ni) {
      const int mi = noise_medium(T, ni), oct = T.med_static[6 * mi + 1];
      fbm_mi[ni] = mi;
      fbm_oct[ni] = oct;
      for (int o = 0; o < (oct > K1_OCT ? 1 : oct); ++o)
        fbm_item[u++] = 8 * ni + (oct > K1_OCT ? 7 : o);
    }
    fbm_n = u;
  }

  // 1. per sample (the edge's own again past a ragged edge)
  if (g == 0) {
    float v[K1_TERMS];
    k1_terms(T, m, min(r, T.hl - 1), min(c, T.wl - 1), v);
#pragma unroll
    for (int t = 0; t < K1_TERMS; ++t) terms[t * ns + s] = v[t];
  }

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float* octs = pairs + (T.n_lights < K1_PASS ? T.n_lights : K1_PASS) * ns;
  const int passes = (T.n_lights + K1_PASS - 1) / K1_PASS;
  for (int pass = 0; pass == 0 || pass < passes; ++pass) {
    const int l0 = pass * K1_PASS;
    if (stager && l0 + lane < T.n_lights) {
      const float* ql = T.lights + 16 * (l0 + lane);
      colour_s[0][lane] = ql[3];
      colour_s[1][lane] = ql[4];
      colour_s[2][lane] = ql[5];
    }
    const bool on =
        l0 + lane < T.n_lights && T.active[(l0 + lane) * T.dl + m];
    const unsigned act = __ballot_sync(0xffffffffu, on);
    const int n_act = __popc(act);
    if (pass == 0) __syncthreads();  // step 1's terms, the fBm items
    const float wx = terms[s], wy = terms[ns + s], wz = terms[2 * ns + s];
    const int items = n_act + (pass == 0 ? fbm_n : 0);
    // 2. the pairs of light group g, and the fBm items
    for (int q = g; q < items; q += groups) {
      if (q < n_act) {
        pairs[q * ns + s] = k1_pair<ARMS>(
            T, T.lights + 16 * (l0 + nth_bit(act, q)), wx, wy, wz,
            terms + s, ns);
        continue;
      }
      // material.noise_factor_planes: fBm channel ni of the (ni)-th
      // noise-bearing medium, octave o of perlin_fbm's loop into shared
      // memory, or the whole fBm written straight out; out has no noise
      // channels when the fBm is not baked
      const int ni = fbm_item[q - n_act] / 8, o = fbm_item[q - n_act] % 8;
      const int mi = fbm_mi[ni];
      const int* st = T.med_static + 6 * mi;
      if (o == 7) {
        if (valid) out[(3 + ni) * plane + i] = noise_factor(T, mi, wx, wy, wz);
        continue;
      }
      const float* qm = T.med + 20 * mi;
      const float ux = wx * qm[5] + qm[8], uy = wy * qm[6] + qm[9];
      const float uz = wz * qm[7] + qm[10];
      const int per = st[2] * (1 << o);
      const float fper = (float)per;
      octs[(ni * K1_OCT + o) * ns + s] =
          perlin_single(ux * fper, uy * fper, uz * fper, per, st[3] + o);
    }
    if constexpr (CHUNKED) {
      // the channels past the chunk, a whole channel an item: light group g
      // every groups-th, noise_factor straight out (as the items of more
      // than K1_OCT octaves)
      for (int mi = 0, ni = 0; pass == 0 && mi < T.n_media && ni < T.n_noise;
           ++mi) {
        if (!T.med_static[6 * mi]) continue;
        const int q = ni++ - chunk;
        if (q >= 0 && q % groups == g && valid)
          out[(3 + chunk + q) * plane + i] = noise_factor(T, mi, wx, wy, wz);
      }
    }
    __syncthreads();
    // 3. the sums, in light order; the fBm of the octave items, in
    // perlin_fbm's order
    if (g == 0) {
      unsigned bits = act;
      for (int q = 0; bits; ++q, bits &= bits - 1) {
        const int l = __ffs(bits) - 1;
        const float base = pairs[q * ns + s];
        acc_r = acc_r + base * colour_s[0][l];
        acc_g = acc_g + base * colour_s[1][l];
        acc_b = acc_b + base * colour_s[2][l];
      }
      for (int ni = 0; pass == 0 && ni < (CHUNKED ? chunk : T.n_noise);
           ++ni) {
        const int oct = fbm_oct[ni];
        if (oct > K1_OCT) continue;
        float total = 0.0f;
        float amp = 1.0f;
        double norm = 0.0;  // a Python float in the reference
        for (int o = 0; o < oct; ++o) {
          total = total + amp * octs[(ni * K1_OCT + o) * ns + s];
          norm += amp;
          amp *= 0.5f;
        }
        if (valid)
          out[(3 + ni) * plane + i] = clampf(
              0.5f + 0.5f * (total / (float)norm) * 1.5f, 0.0f, 1.0f);
      }
    }
    if (pass + 1 < passes) __syncthreads();  // the next pass's pairs
  }
  if (g == 0 && valid) {
    out[i] = acc_r;
    out[plane + i] = acc_g;
    out[2 * plane + i] = acc_b;
  }
}

// Whether the launch takes the chunked form: light groups to spread its
// items over, and more fBm channels than fit a block's shared memory.
static bool k1_chunked(int n_lights, int n_noise, int groups, int samples) {
  return groups > 1 && k1_general(n_noise)
         && (long)k1_shared(n_lights, n_noise, groups, samples)
                    * (long)sizeof(float) + VR_TILE_STATIC
                > VR_MAX_SHARED;
}

// The launch of the low grid (wl, hl, dl) with n_lights local lights and
// n_noise fBm channels into out[0..7]: blocks, threads a block, samples a
// block, light groups, passes of lights, dynamic shared bytes, and a
// block's columns and rows of its low slice.
extern "C" int vr_bake_radiance_geometry(int n_lights, int n_noise, int wl,
                                         int hl, int dl, int* out) {
  const int groups = k1_groups(n_lights, n_noise);
  const int sw = K1_WARPS / groups;
  const int cols = K1_WX, rows = sw * K1_WY;
  out[0] = ((wl + cols - 1) / cols) * ((hl + rows - 1) / rows) * dl;
  out[1] = 32 * K1_WARPS;
  out[2] = 32 * sw;
  out[3] = groups;
  out[4] = n_lights > 0 ? (n_lights + K1_PASS - 1) / K1_PASS : 1;
  out[5] = k1_chunked(n_lights, n_noise, groups, out[2])
               ? (int)k1_chunked_shared(
                     n_lights, k1_chunk_of(n_lights, n_noise, out[2]),
                     out[2]) * (int)sizeof(float)
               : k1_shared(n_lights, n_noise, groups, out[2])
                     * (int)sizeof(float);
  out[6] = cols;
  out[7] = rows;
  return 0;
}

// Launches of the fixed (0), general (1) and chunked (2) forms since the
// library was loaded (vr_bake_radiance_forms).
static long g_forms[3];

template <bool ARMS>
static int launch_general(const VrTables* T, const int* geo, int runs_x,
                          int runs_y, float* out, cudaStream_t stream) {
  if (geo[5] > 48 * 1024) {  // many fBm channels
    const cudaError_t err = cudaFuncSetAttribute(
        bake_radiance_kernel<ARMS, true, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, geo[5]);
    if (err != cudaSuccess) return (int)err;
  }
  bake_radiance_kernel<ARMS, true, true><<<geo[0], geo[1], geo[5], stream>>>(
      *T, out, geo[3], runs_x, runs_y, 0);
  return 0;
}

// The chunked form with `chunk` staged channels.
template <bool ARMS>
static int launch_chunked(const VrTables* T, const int* geo, int runs_x,
                          int runs_y, int chunk, float* out,
                          cudaStream_t stream) {
  const auto kernel = bake_radiance_kernel<ARMS, true, true, true>;
  const int shared =
      (int)k1_chunked_shared(T->n_lights, chunk, geo[2]) * (int)sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<geo[0], geo[1], shared, stream>>>(*T, out, geo[3], runs_x, runs_y,
                                             chunk);
  return 0;
}

// Whether K1 takes the table (mirrored by ops/frame_fused.check_k1_indices).
// It writes [3 + n_noise, DL, HL, WL] at 64-bit offsets (a sample's index
// and the channel stride are longs) on a 1-D grid of blocks, so neither
// that volume's size nor the slice count limits it; it indexes the cull
// table [NL, DL] and the lights table [NL, 16] in 32 bits, and its grid
// holds at most 2^31 - 1 blocks. No wider form is needed below those.
static bool k1_fits(const VrTables& T) {
  const long sw = K1_WARPS / k1_groups(T.n_lights, T.n_noise);
  const long blocks = ((T.wl + K1_WX - 1) / K1_WX)
                      * ((T.hl + sw * K1_WY - 1) / (sw * K1_WY));
  return !past_int(T.n_lights, T.dl) && !past_int(T.n_lights, 16)
         && !past_int(blocks, T.dl);
}

extern "C" int vr_bake_radiance(const VrTables* T, float* out,
                                cudaStream_t stream) {
  if (!k1_fits(*T)) return (int)cudaErrorInvalidValue;
  int geo[8];
  vr_bake_radiance_geometry(T->n_lights, T->n_noise, T->wl, T->hl, T->dl,
                            geo);
  const int runs_x = (T->wl + geo[6] - 1) / geo[6];
  const int runs_y = (T->hl + geo[7] - 1) / geo[7];
  const bool arms = needs_arms(*T), spread = geo[3] > 1;
  const bool gen = k1_general(T->n_noise);
  if (k1_chunked(T->n_lights, T->n_noise, geo[3], geo[2])) {
    const int chunk = k1_chunk_of(T->n_lights, T->n_noise, geo[2]);
    const int err = arms ? launch_chunked<true>(T, geo, runs_x, runs_y, chunk,
                                                out, stream)
                         : launch_chunked<false>(T, geo, runs_x, runs_y,
                                                 chunk, out, stream);
    ++g_forms[2];
    return err ? err : (int)cudaGetLastError();
  }
  ++g_forms[gen];
  if (gen) {  // more than one item: spread
    const int err = arms ? launch_general<true>(T, geo, runs_x, runs_y, out,
                                                stream)
                         : launch_general<false>(T, geo, runs_x, runs_y, out,
                                                 stream);
    return err ? err : (int)cudaGetLastError();
  }
  if (arms && spread)
    bake_radiance_kernel<true, true><<<geo[0], geo[1], geo[5], stream>>>(
        *T, out, geo[3], runs_x, runs_y, 0);
  else if (spread)
    bake_radiance_kernel<false, true><<<geo[0], geo[1], geo[5], stream>>>(
        *T, out, geo[3], runs_x, runs_y, 0);
  else if (arms)
    bake_radiance_kernel<true, false><<<geo[0], geo[1], geo[5], stream>>>(
        *T, out, geo[3], runs_x, runs_y, 0);
  else
    bake_radiance_kernel<false, false><<<geo[0], geo[1], geo[5], stream>>>(
        *T, out, geo[3], runs_x, runs_y, 0);
  return (int)cudaGetLastError();
}

// The chunked form forced, with `chunk` staged channels (-1: the most that
// fit, k1_chunk_of); refused with one light group (nothing to spread) and
// where the chunk is past n_noise or does not fit.
extern "C" int vr_bake_radiance_chunked(const VrTables* T, float* out,
                                        int chunk, cudaStream_t stream) {
  if (!k1_fits(*T)) return (int)cudaErrorInvalidValue;
  int geo[8];
  vr_bake_radiance_geometry(T->n_lights, T->n_noise, T->wl, T->hl, T->dl,
                            geo);
  if (chunk < 0) chunk = k1_chunk_of(T->n_lights, T->n_noise, geo[2]);
  if (geo[3] < 2 || chunk > T->n_noise
      || chunk > k1_chunk_of(T->n_lights, T->n_noise, geo[2]))
    return (int)cudaErrorInvalidValue;
  const int runs_x = (T->wl + geo[6] - 1) / geo[6];
  const int runs_y = (T->hl + geo[7] - 1) / geo[7];
  const int err = needs_arms(*T)
                      ? launch_chunked<true>(T, geo, runs_x, runs_y, chunk,
                                             out, stream)
                      : launch_chunked<false>(T, geo, runs_x, runs_y, chunk,
                                              out, stream);
  ++g_forms[2];
  return err ? err : (int)cudaGetLastError();
}

// The form a launch with n_lights local lights and n_noise fBm channels
// takes into out[0] (0 fixed, 1 general, 2 chunked), the channels it stages
// into out[1] (n_noise but in the chunked form) and its dynamic shared
// bytes into out[2].
extern "C" int vr_bake_radiance_plan(int n_lights, int n_noise, int* out) {
  int geo[8];
  vr_bake_radiance_geometry(n_lights, n_noise, 1, 1, 1, geo);
  const bool chunked = k1_chunked(n_lights, n_noise, geo[3], geo[2]);
  out[0] = chunked ? 2 : k1_general(n_noise) ? 1 : 0;
  out[1] = chunked ? k1_chunk_of(n_lights, n_noise, geo[2]) : n_noise;
  out[2] = geo[5];
  return 0;
}

// The launches of the fixed, the general and the chunked form so far into
// out[0..2].
extern "C" int vr_bake_radiance_forms(int* out) {
  for (int f = 0; f < 3; ++f) out[f] = (int)g_forms[f];
  return 0;
}

// cudaFuncGetAttributes of the eight kernels, SPREAD (true, false) outer
// and ARMS (false, true) inner, then the general (SPREAD) forms, then the
// chunked ones, ARMS false then true: registers per thread, static shared
// bytes per block, local bytes per thread and largest block into
// out[4 i .. 4 i + 3]; returns the error.
template <bool ARMS, bool SPREAD, bool GEN = false, bool CHUNKED = false>
static cudaError_t attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, (const void*)bake_radiance_kernel<ARMS, SPREAD, GEN, CHUNKED>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return err;
}

extern "C" int vr_bake_radiance_attrs(int* out) {
  const cudaError_t errs[8] = {
      attrs_of<false, true>(out), attrs_of<true, true>(out + 4),
      attrs_of<false, false>(out + 8), attrs_of<true, false>(out + 12),
      attrs_of<false, true, true>(out + 16),
      attrs_of<true, true, true>(out + 20),
      attrs_of<false, true, true, true>(out + 24),
      attrs_of<true, true, true, true>(out + 28)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

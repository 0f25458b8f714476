// Device helpers shared by the volume-phase kernels (bake_radiance.cu,
// shadow_scatter.cu, integrate_blend.cu, shadow_blend.cu, dir_shadow.cu,
// scatter.cu, integrate.cu, bake_visibility.cu, temporal_blend.cu).
//
// Each function is the CUDA form of a device helper that the TPU kernels
// (volumetricrenderer_tpu/ops/pallas/: frame_fused.py inlines the bodies of
// dir_shadow.py, shadow_blend.py, scatter.py, integrate.py and
// integrate_blend.py) share, and of its
// plain-torch twin in volumetricrenderer_tpu_torch/ops/: the arithmetic is
// written in the same order so that, built without fast math and without
// FMA contraction, a kernel agrees with its twin to a few ulp.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VR_PI 3.1415926535  // the reference's truncated constant
// The fixed forms' counts: the slice tiles keep VR_MAX_DIR suns' values
// and K1 and the scatter VR_MAX_NOISE fBm channels in arrays; a frame with
// more takes the kernels' general (GEN) instantiations, which take any count
// (needs_general)
#define VR_MAX_DIR 4        // directional lights
#define VR_MAX_NOISE 4      // noise-bearing media baked at the low rate
// The most blocks a launch grid's y or z axis holds
#define VR_MAX_GRID_Z 65535

// Packed tables and dims of one frame (the wrapper fills it from the
// pack_* tables; mirrored by ops/cuda.py VrTables). All pointers are device
// pointers to contiguous arrays; a table the frame does not have is null
// (the low-grid tables at ss = 1, the light schedule where no per-light
// scatter runs).
struct VrTables {
  const float* spar;      // [25] pack_params (jittered) + slab y phase
  const float* sbpar;     // [24] pack_blend_params, shadow blend
  const float* abpar;     // [28] pack_blend_params, acc blend + jitter
  const float* slights;   // [Nd, 8] dir_shadow.pack_dir_lights
  const float* dirs;      // [Nd, 8] scatter.pack_dir_lights
  const float* lights;    // [NL, 16] scatter.pack_lights
  const float* planes;    // [P, 4]
  const float* spheres;   // [S, 4]
  const float* boxes;     // [B, 8]
  const float* med;       // [M, 20] material.pack_media
  const int* med_static;  // [M, 6] (src, octaves, period, seed, box, add)
  const int* active;      // [NL, DL] low_slice_active
  const int* tent_xk;     // [W] first x tap of the tent upsample
  const float* tent_xw;   // [2, W] its two weights
  const int* tent_yk;     // [H]
  const float* tent_yw;   // [2, H]
  const int* order;       // [D, NL] slice_light_order: active lights first
  const int* count;       // [D] number of active lights of the slice
  const float* hf;        // [6] material.pack_heightfield; null: no terrain
  int n_dir, n_lights, n_planes, n_spheres, n_boxes, n_media, n_noise;
  int jitter_dir;  // 1: the sun scatter uses the jittered position
  int w, h, d, h_glob, k, ss, wl, hl, dl;
  int hf_octaves, hf_period, hf_seed, hf_steps;  // the terrain's statics
  int hf_local;    // 1: local-light rays march the terrain too
  int fractional;  // 1: some box opacity < 1 (occlusion amounts)
  float hf_far;    // the terrain march's far clamp
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float rsqrt_exact(float v) {
  return 1.0f / sqrtf(v);
}

// froxel -> view depth of continuous froxel z `fz`.
__device__ __forceinline__ float view_z(const float* p, float fz, int d) {
  return (expf(logf(p[14]) * fz / (float)d) - 1.0f) * p[15] + p[16];
}

// Local-light source of scatter_froxel.
#define VR_LOCAL_RADIANCE 0  // the upsampled low-rate radiance
#define VR_LOCAL_RAY 1       // per-light loop, one any-hit ray per light
#define VR_LOCAL_BAKED 2     // per-light loop over the low-rate visibility

// froxel_world's view-space x of continuous column fxc and y of continuous
// row fyc at view depth vz: functions of (column, slice) and (row, slice)
// alone, so a slice tile computes each once.
__device__ __forceinline__ float froxel_vx(const float* p, float fxc,
                                          float vz, int w) {
  return (2.0f * fxc / (float)w - 1.0f) * vz / p[12];
}

__device__ __forceinline__ float froxel_vy(const float* p, float fyc,
                                          float vz, int h_glob) {
  return (2.0f * fyc / (float)h_glob - 1.0f) * vz / p[13];
}

// The rest of froxel_world: view space -> world.
__device__ __forceinline__ void view_world(const float* p, float vx, float vy,
                                           float vz, float& wx, float& wy,
                                           float& wz) {
  wx = p[0] * vx + p[1] * vy + p[2] * vz + p[3];
  wy = p[4] * vx + p[5] * vy + p[6] * vz + p[7];
  wz = p[8] * vx + p[9] * vy + p[10] * vz + p[11];
}

// froxel (continuous fxc, fyc, view depth vz) -> world position.
__device__ __forceinline__ void froxel_world(const float* p, float fxc,
                                             float fyc, float vz, int w,
                                             int h_glob, float& wx,
                                             float& wy, float& wz) {
  view_world(p, froxel_vx(p, fxc, vz, w), froxel_vy(p, fyc, vz, h_glob), vz,
             wx, wy, wz);
}

// visibility.bake_world_planes: jittered world position of low sample
// (m, r, c), which sits at full coordinate ss*k + (ss-1)/2; its row also
// takes the slab's y phase (-y0) mod ss, packed on the host at p[24], so a
// slab's low rows sit on the global ss-grid (0 for a whole grid).
__device__ __forceinline__ void low_sample_world(const VrTables& T, int m,
                                                 int r, int c, float& wx,
                                                 float& wy, float& wz) {
  const float* p = T.spar;
  const int ss = T.ss;
  const float off = (float)(ss - 1) * 0.5f;
  const float fz = (float)ss * (float)m + off + 0.5f + p[19];
  const float vz = view_z(p, fz, T.d);
  const float xs = (float)c * (float)ss + off;
  float ys = (float)r * (float)ss + off + p[24];
  ys = clampf(ys + p[23], 0.0f, (float)T.h_glob - 1.0f);
  froxel_world(p, xs + 0.5f + p[17], ys + 0.5f + p[18], vz, T.w, T.h_glob,
               wx, wy, wz);
}

// ---- material.py: uint32 lattice hash, Perlin, fBm ------------------------

__device__ __forceinline__ int hash3(int ix, int iy, int iz, int seed) {
  uint32_t h = (uint32_t)ix * 0x8DA6B343u + (uint32_t)iy * 0xD8163841u
               + (uint32_t)iz * 0xCB1AB31Fu
               + (uint32_t)seed * 0x9E3779B9u;
  h = h ^ (h >> 13);
  h = h * 0x85EBCA6Bu;
  h = h ^ (h >> 16);
  return (int)(h & 15u);
}

__device__ __forceinline__ float grad_dot(int h, float dx, float dy,
                                          float dz) {
  float u = h < 8 ? dx : dy;
  float v = h < 4 ? dy : ((h == 12 || h == 14) ? dx : dz);
  return ((h & 1) == 0 ? u : -u) + ((h & 2) == 0 ? v : -v);
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ int wrap_lattice(int a, int period) {
  if ((period & (period - 1)) == 0) return a & (period - 1);
  int m = a % period;
  return m < 0 ? m + period : m;
}

__device__ float perlin_single(float px, float py, float pz, int period,
                               int seed) {
  float p0x = floorf(px), p0y = floorf(py), p0z = floorf(pz);
  float fx = px - p0x, fy = py - p0y, fz = pz - p0z;
  int i0x = (int)p0x, i0y = (int)p0y, i0z = (int)p0z;
  float ux = fade(fx), uy = fade(fy), uz = fade(fz);
  float n[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
    int h = hash3(wrap_lattice(i0x + dx, period),
                  wrap_lattice(i0y + dy, period),
                  wrap_lattice(i0z + dz, period), seed);
    n[c] = grad_dot(h, fx - (float)dx, fy - (float)dy, fz - (float)dz);
  }
  float nx00 = n[0] + ux * (n[1] - n[0]);
  float nx10 = n[2] + ux * (n[3] - n[2]);
  float nx01 = n[4] + ux * (n[5] - n[4]);
  float nx11 = n[6] + ux * (n[7] - n[6]);
  float nxy0 = nx00 + uy * (nx10 - nx00);
  float nxy1 = nx01 + uy * (nx11 - nx01);
  return nxy0 + uz * (nxy1 - nxy0);
}

__device__ float perlin_fbm(float ux, float uy, float uz, int octaves,
                            int period, int seed) {
  float total = 0.0f;
  float amp = 1.0f;
  double norm = 0.0;  // a Python float in the reference
  int per = period;
  for (int o = 0; o < octaves; ++o) {
    float fper = (float)per;
    total = total + amp * perlin_single(ux * fper, uy * fper, uz * fper, per,
                                        seed + o);
    norm += amp;
    amp *= 0.5f;
    per *= 2;
  }
  return clampf(0.5f + 0.5f * (total / (float)norm) * 1.5f, 0.0f, 1.0f);
}

// ---- occlude.py: the any-hit shadow ray, and its terrain march ----------

// material.heightfield_occluded: does the ray (o, unit ld) cross below the
// terrain at one of hf_steps midpoint samples of the interval where it
// crosses the height band [base, base + amp], clamped to
// min(max_t, hf_far)? A thread whose band is empty skips the march: the
// reference's march ends in `occ & valid`. The first sample below the
// surface ends it too.
__device__ bool heightfield_occluded(const VrTables& T, float wx, float wy,
                                     float wz, float ldx, float ldy,
                                     float ldz, float max_t) {
  const float* q = T.hf;
  const float amp = q[0], base = q[1];
  const float hmax = base + amp;
  const float eps = 1e-4f;
  const float cap = fminf(max_t, T.hf_far);
  const bool horiz = fabsf(ldy) < 1e-7f;
  const float safe = horiz ? 1e-7f : ldy;
  const float ta = (hmax - wy) / safe;
  const float tb = (base - wy) / safe;
  const bool in_band = wy >= base && wy <= hmax;
  float lo = horiz ? (in_band ? eps : cap) : fminf(ta, tb);
  float hi = horiz ? (in_band ? cap : 0.0f) : fmaxf(ta, tb);
  lo = fminf(fmaxf(lo, eps), cap);
  hi = fminf(fmaxf(hi, eps), cap);
  if (!(hi > lo)) return false;
  const int steps = T.hf_steps;
  for (int i = 0; i < steps; ++i) {
    // (i + 0.5) / steps, rounded once to float as the reference's constant
    const float s = (float)(2 * i + 1) / (float)(2 * steps);
    const float t = lo + (hi - lo) * s;
    const float px = wx + t * ldx;
    const float py = wy + t * ldy;
    const float pz = wz + t * ldz;
    const float u = px * q[2] + q[4];
    const float v = pz * q[3] + q[5];
    const float hgt = base + amp * perlin_fbm(u, v, 0.0f, T.hf_octaves,
                                              T.hf_period, T.hf_seed);
    if (py < hgt) return true;
  }
  return false;
}

// The any-hit's three primitive tests: does the ray (o, unit dir) hit
// plane row q, sphere row q or box row q (with the ray's inverse
// direction i) for t in (1e-4, max_t)?
// EARLY (the slice tiles' sun rays, K1's local rays) returns before the
// division or the square root where the answer is known: a plane's
// t = num / denom is above 1e-4 only where num and denom have one sign, and
// a sphere is hit only where disc > 0 -- the same answers.
template <bool EARLY = false>
__device__ __forceinline__ bool plane_hit(const float* q, float wx, float wy,
                                          float wz, float dx, float dy,
                                          float dz, float max_t) {
  float denom = dx * q[0] + dy * q[1] + dz * q[2];
  if (fabsf(denom) < 1e-9f) denom = 1e-9f;
  const float num = -(wx * q[0] + wy * q[1] + wz * q[2] + q[3]);
  if (EARLY && !((num > 0.0f && denom > 0.0f) || (num < 0.0f && denom < 0.0f)))
    return false;
  float t = num / denom;
  return t > 1e-4f && t < max_t;
}

template <bool EARLY = false>
__device__ __forceinline__ bool sphere_hit(const float* q, float wx,
                                           float wy, float wz, float dx,
                                           float dy, float dz, float max_t) {
  float ox = wx - q[0], oy = wy - q[1], oz = wz - q[2];
  float bq = ox * dx + oy * dy + oz * dz;
  float cq = ox * ox + oy * oy + oz * oz - q[3] * q[3];
  float disc = bq * bq - cq;
  if (EARLY && !(disc > 0.0f)) return false;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-bq - sq > 1e-4f) ? -bq - sq : -bq + sq;
  return disc > 0.0f && t > 1e-4f && t < max_t;
}

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-9f ? 1e-9f : d);
}

__device__ __forceinline__ bool box_hit(const float* q, float wx, float wy,
                                        float wz, float ix, float iy,
                                        float iz, float max_t) {
  float t0x = (q[0] - wx) * ix, t1x = (q[4] - wx) * ix;
  float t0y = (q[1] - wy) * iy, t1y = (q[5] - wy) * iy;
  float t0z = (q[2] - wz) * iz, t1z = (q[6] - wz) * iz;
  float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fminf(t0z, t1z));
  float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fmaxf(t0z, t1z));
  float t = tmin > 1e-4f ? tmin : tmax;
  return tmax >= tmin && t > 1e-4f && t < max_t;
}

// The box tests' inverse direction of the ray (dx, dy, dz): inv_dir of each
// component, or with INV (the slice tiles' sun rays, whose direction is a
// frame constant) the three values at `inv`, computed once per block with
// inv_dir.
template <bool INV>
__device__ __forceinline__ void ray_inverse(float dx, float dy, float dz,
                                            const float* inv, float& ix,
                                            float& iy, float& iz) {
  if constexpr (INV) {
    ix = inv[0];
    iy = inv[1];
    iz = inv[2];
  } else {
    ix = inv_dir(dx);
    iy = inv_dir(dy);
    iz = inv_dir(dz);
  }
}

// occlude.any_hit, solid branch: does the ray hit a plane, sphere or box?
// EARLY: plane_hit's and sphere_hit's early exits (the same answers).
template <bool INV = false, bool EARLY = INV>
__device__ bool any_hit_solid(const VrTables& T, float wx, float wy,
                              float wz, float dx, float dy, float dz,
                              float max_t, const float* inv = nullptr) {
  for (int i = 0; i < T.n_planes; ++i)
    if (plane_hit<EARLY>(T.planes + 4 * i, wx, wy, wz, dx, dy, dz, max_t))
      return true;
  for (int i = 0; i < T.n_spheres; ++i)
    if (sphere_hit<EARLY>(T.spheres + 4 * i, wx, wy, wz, dx, dy, dz, max_t))
      return true;
  if (T.n_boxes) {
    float ix, iy, iz;
    ray_inverse<INV>(dx, dy, dz, inv, ix, iy, iz);
    for (int i = 0; i < T.n_boxes; ++i)
      if (box_hit(T.boxes + 8 * i, wx, wy, wz, ix, iy, iz, max_t))
        return true;
  }
  return false;
}

// occlude._any_hit_fractional: the occlusion amount
// 1 - prod(1 - opacity_i * hit_i). A plane or sphere hit makes the product
// 0 whatever follows, and a box that is missed multiplies it by exactly 1,
// so the early exits and the skipped factors give the reference's value.
// (One body for both arms, this one with an early 1 where the product
// reaches 0, gives the same values but ran every ARMS kernel 2-19% slower
// on an H100: PERF.md §6.) EARLY: as any_hit_solid's.
template <bool INV = false, bool EARLY = INV>
__device__ float any_hit_fractional(const VrTables& T, float wx, float wy,
                                    float wz, float dx, float dy, float dz,
                                    float max_t, bool terrain,
                                    const float* inv = nullptr) {
  for (int i = 0; i < T.n_planes; ++i)
    if (plane_hit<EARLY>(T.planes + 4 * i, wx, wy, wz, dx, dy, dz, max_t))
      return 1.0f;
  for (int i = 0; i < T.n_spheres; ++i)
    if (sphere_hit<EARLY>(T.spheres + 4 * i, wx, wy, wz, dx, dy, dz, max_t))
      return 1.0f;
  float trans = 1.0f;
  if (T.n_boxes) {
    float ix, iy, iz;
    ray_inverse<INV>(dx, dy, dz, inv, ix, iy, iz);
    for (int i = 0; i < T.n_boxes; ++i) {
      const float* q = T.boxes + 8 * i;
      if (box_hit(q, wx, wy, wz, ix, iy, iz, max_t))
        trans = trans * (1.0f - q[3]);
    }
  }
  if (trans > 0.0f && terrain && T.hf != nullptr
      && heightfield_occluded(T, wx, wy, wz, dx, dy, dz, max_t))
    return 1.0f;
  return 1.0f - trans;
}

// occlude.any_hit: the occlusion of the ray (o, unit dir) for t in (1e-4,
// max_t) by the primitives and, with `terrain`, by the heightfield: 1 or 0
// (the reference's bool, which its consumers turn into 1 - occ x gate), or
// the occlusion amount where some box is fractional. ARMS is the kernels'
// template parameter: false (no heightfield, every box solid) compiles
// exactly the solid test, so a solid scene's kernels keep their registers
// and their time; true adds the two arms behind uniform branches. INV: the
// ray's inverse direction is given (ray_inverse). EARLY: the plane and
// sphere tests' exits (any_hit_solid).
template <bool ARMS, bool INV = false, bool EARLY = INV>
__device__ __forceinline__ float any_hit(const VrTables& T, float wx,
                                         float wy, float wz, float dx,
                                         float dy, float dz, float max_t,
                                         bool terrain,
                                         const float* inv = nullptr) {
  if constexpr (ARMS) {
    if (T.fractional)
      return any_hit_fractional<INV, EARLY>(T, wx, wy, wz, dx, dy, dz, max_t,
                                            terrain, inv);
    if (any_hit_solid<INV, EARLY>(T, wx, wy, wz, dx, dy, dz, max_t, inv))
      return 1.0f;
    return terrain && T.hf != nullptr
                   && heightfield_occluded(T, wx, wy, wz, dx, dy, dz, max_t)
               ? 1.0f : 0.0f;
  } else {
    return any_hit_solid<INV, EARLY>(T, wx, wy, wz, dx, dy, dz, max_t, inv)
               ? 1.0f : 0.0f;
  }
}

// Whether a frame's tables need the arms (the ARMS instantiation).
inline bool needs_arms(const VrTables& T) {
  return T.hf != nullptr || T.fractional;
}

// scatter.light_factor: HG x falloff x cone x range cull of light row q.
__device__ __forceinline__ float light_factor(
    const float* q, float wx, float wy, float wz, float vdx, float vdy,
    float vdz, float phg, float g2, float hg_num, float& ldx, float& ldy,
    float& ldz, float& dist) {
  float tx = wx - q[0], ty = wy - q[1], tz = wz - q[2];
  float d2 = tx * tx + ty * ty + tz * tz;
  float inv_d = rsqrt_exact(d2 + 1e-18f);
  dist = d2 * inv_d;
  ldx = tx * inv_d;
  ldy = ty * inv_d;
  ldz = tz * inv_d;
  float rng = q[6], mult = q[7], is_spot = q[8];
  float x = d2 / (rng * rng);
  float fall = clampf((1.0f - x) * 5.0f, 0.0f, 1.0f) / (1.0f + 25.0f * x)
               * mult;
  float cos_angle = ldx * q[9] + ldy * q[10] + ldz * q[11];
  float cos_inner = 1.0f / q[13];
  float cone_den = fminf(q[12] - cos_inner, -1e-9f);
  float t_cone = clampf((cos_angle - cos_inner) / cone_den, 0.0f, 1.0f);
  float cone = 1.0f - t_cone * t_cone * (3.0f - 2.0f * t_cone);
  float keep = cos_angle >= q[12] ? 1.0f : 0.0f;
  fall = fall * (1.0f - is_spot + is_spot * cone * keep);
  fall = fall * (dist <= rng ? 1.0f : 0.0f);
  float cos_t = -(vdx * ldx + vdy * ldy + vdz * ldz);
  float b = 1.0f + g2 - 2.0f * phg * cos_t;
  float rb = rsqrt_exact(b);
  return hg_num * rb * rb * rb * fall;
}

// dir_shadow.froxel_world's view depth of slice z and continuous column of
// x and row of y (the slab's global row clamped to the grid) at the froxel
// centre, jittered or not: p = spar. The slice tiles compute them once a
// block (tile_scalars, tile_line).
__device__ __forceinline__ float center_vz(const float* p, int z,
                                           bool jittered, int d) {
  return view_z(p, (float)z + 0.5f + (jittered ? p[19] : 0.0f), d);
}

__device__ __forceinline__ float center_fx(const float* p, int x,
                                           bool jittered) {
  return (float)x + 0.5f + (jittered ? p[17] : 0.0f);
}

__device__ __forceinline__ float center_fy(const float* p, int y,
                                           bool jittered, int h_glob) {
  const float ys = clampf((float)y + p[23], 0.0f, (float)h_glob - 1.0f);
  return ys + 0.5f + (jittered ? p[18] : 0.0f);
}

// dir_shadow.dir_shadow_slice: sun li's visibility at a world position, one
// any-hit ray towards the sun (the terrain always marched), squared and
// gated by has_shadow. INV: the ray's inverse direction is given at inv.
template <bool ARMS, bool INV = false>
__device__ __forceinline__ float sun_shadow(const VrTables& T, int li,
                                            float wx, float wy, float wz,
                                            const float* inv = nullptr) {
  const float* q = T.slights + 8 * li;
  const float strength_r = q[3], gate = q[4];
  const float occ = any_hit<ARMS, INV>(T, wx, wy, wz, -q[0], -q[1], -q[2],
                                       1e4f, true, inv);
  float vis = strength_r + (1.0f - strength_r) * (1.0f - occ);
  vis = vis * vis;
  return 1.0f + gate * (vis - 1.0f);
}

// ---- material.py: the media -----------------------------------------------

// EARLY (the slice tiles' material) skips the division where the clamp
// decides the result: with e1 - e0 > 0, x - e0 <= 0 gives a quotient <= 0
// (clamped to 0, and 0 or -0 gives 0) and x - e0 >= e1 - e0 one >= 1
// (clamped to 1, giving 1): the same value as the division's.
template <bool EARLY = false>
__device__ __forceinline__ float smoothstep(float e0, float e1, float x) {
  const float a = x - e0, b = e1 - e0;
  if constexpr (EARLY) {
    if (b > 0.0f) {
      if (a <= 0.0f) return 0.0f;
      if (a >= b) return 1.0f;
    }
  }
  float t = clampf(a / b, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

template <bool EARLY = false>
__device__ __forceinline__ float box_mask(const float* q, float wx, float wy,
                                          float wz) {
  float soft = fmaxf(q[19], 1e-6f);
  float lo = fminf(fminf(smoothstep<EARLY>(q[13], q[13] + soft, wx),
                         smoothstep<EARLY>(q[14], q[14] + soft, wy)),
                   smoothstep<EARLY>(q[15], q[15] + soft, wz));
  float hi = fminf(fminf(smoothstep<EARLY>(-q[16], -(q[16] - soft), -wx),
                         smoothstep<EARLY>(-q[17], -(q[17] - soft), -wy)),
                   smoothstep<EARLY>(-q[18], -(q[18] - soft), -wz));
  return lo * hi;
}

// material.phase_g_plane (the box mask's clamped divisions skipped, as in
// material below)
__device__ float phase_g(const VrTables& T, float wx, float wy, float wz) {
  float g = 0.0f;
  for (int mi = 0; mi < T.n_media; ++mi) {
    const float* q = T.med + 20 * mi;
    const int* st = T.med_static + 6 * mi;
    float mask = st[4] ? box_mask<true>(q, wx, wy, wz) : 1.0f;
    if (st[5]) g = g + q[4] * mask;
    else g = g * (1.0f - mask) + q[4] * mask;
  }
  return g;
}

// material.noise_factor_planes: fBm factor of noise-bearing medium `mi`.
__device__ __forceinline__ float noise_factor(const VrTables& T, int mi,
                                              float wx, float wy, float wz) {
  const float* q = T.med + 20 * mi;
  const int* st = T.med_static + 6 * mi;
  return perlin_fbm(wx * q[5] + q[8], wy * q[6] + q[9], wz * q[7] + q[10],
                    st[1], st[2], st[3]);
}

// material.material_planes with the fBm factors given (baked: noise_at(i)
// for the i-th noise-bearing medium), or evaluated here.
template <class NoiseAt>
__device__ void material(const VrTables& T, float wx, float wy, float wz,
                         bool baked, const NoiseAt& noise_at, float& sr,
                         float& sg, float& sb, float& sa, float& g) {
  sr = sg = sb = sa = g = 0.0f;
  int ni = 0;
  for (int mi = 0; mi < T.n_media; ++mi) {
    const float* q = T.med + 20 * mi;
    const int* st = T.med_static + 6 * mi;
    float factor = 1.0f;
    if (st[0])
      factor = factor * (baked ? noise_at(ni++)
                               : noise_factor(T, mi, wx, wy, wz));
    factor = factor * expf(-fmaxf(q[11], 0.0f) * fmaxf(wy - q[12], 0.0f));
    float mask = st[4] ? box_mask<true>(q, wx, wy, wz) : 1.0f;
    float a_r = q[0] * factor, a_g = q[1] * factor, a_b = q[2] * factor;
    float a_a = q[3] * factor;
    if (st[5]) {
      sr = sr + a_r * mask;
      sg = sg + a_g * mask;
      sb = sb + a_b * mask;
      sa = sa + a_a * mask;
      g = g + q[4] * mask;
    } else {
      float inv = 1.0f - mask;
      sr = sr * inv + a_r * mask;
      sg = sg * inv + a_g * mask;
      sb = sb * inv + a_b * mask;
      sa = sa * inv + a_a * mask;
      g = g * inv + q[4] * mask;
    }
  }
}

// ---- temporal.py: reprojection offsets and the separable tent warp ------

// temporal._reproj_offsets at froxel (z, y, x), unjittered centre; vz is
// the view depth of slice z's centre (view_z(p, z + 0.5, d)). Offsets are
// clipped to +-k after the clamps to the volume.
struct Reproj {
  float ox, oy, oz, success;
};

// The reprojection's view-space x of column x and y of row y at depth vz: a
// function of (x, vz) and of (y, vz) alone, so a tile can compute each once.
__device__ __forceinline__ float reproj_vx(const float* p, int x, float vz,
                                           int w) {
  return (2.0f * ((float)x + 0.5f) / (float)w - 1.0f) * vz / p[12];
}

__device__ __forceinline__ float reproj_vy(const float* p, int y, float vz,
                                           int h_glob) {
  const float ys = clampf((float)y + p[22], 0.0f, (float)h_glob - 1.0f);
  return (2.0f * (ys + 0.5f) / (float)h_glob - 1.0f) * vz / p[13];
}

// The rest of the reprojection, from the view-space position (vx, vy, vz) of
// froxel (z, y, x) and lfpz = logf(p[14]), a frame constant.
__device__ __forceinline__ Reproj reproj_view_l(const float* p, int z, int y,
                                                int x, float vx, float vy,
                                                float vz, float lfpz, int w,
                                                int h, int d, int h_glob,
                                                int k, bool with_jitter) {
  float fpx = p[12], fpy = p[13], fpw = p[15], near_ = p[16];
  float eps = p[21], y0 = p[22];
  float pvx = p[0] * vx + p[1] * vy + p[2] * vz + p[3];
  float pvy = p[4] * vx + p[5] * vy + p[6] * vz + p[7];
  float pvz = p[8] * vx + p[9] * vy + p[10] * vz + p[11];
  float pfz = (float)d * logf(fmaxf((pvz - near_) / fpw + 1.0f, 1e-8f))
              / lfpz;
  float pfx = (float)w * (fpx * pvx / pvz + 1.0f) / 2.0f;
  float pfy = (float)h_glob * (fpy * pvy / pvz + 1.0f) / 2.0f;
  if (with_jitter) {
    pfx = pfx + p[17];
    pfy = pfy + p[18];
    pfz = pfz + p[19];
  }
  float tx = pfx + eps * (float)w - 0.5f;
  float ty = pfy + eps * (float)h_glob - 0.5f - y0;
  float tz = pfz + eps * (float)d - 0.5f;
  float ux = pfx / (float)w + eps;
  float uy = pfy / (float)h_glob + eps;
  Reproj r;
  r.success = (ux >= 0.0f && ux <= 1.0f && uy >= 0.0f && uy <= 1.0f)
                  ? 1.0f : 0.0f;
  tz = clampf(tz, 0.0f, (float)d - 1.0f);
  ty = clampf(ty, 0.0f, (float)h - 1.0f);
  tx = clampf(tx, 0.0f, (float)w - 1.0f);
  float kf = (float)k;
  r.oz = clampf(tz - (float)z, -kf, kf);
  r.oy = clampf(ty - (float)y, -kf, kf);
  r.ox = clampf(tx - (float)x, -kf, kf);
  return r;
}

__device__ __forceinline__ Reproj reproj_view(const float* p, int z, int y,
                                              int x, float vx, float vy,
                                              float vz, int w, int h, int d,
                                              int h_glob, int k,
                                              bool with_jitter) {
  return reproj_view_l(p, z, y, x, vx, vy, vz, logf(p[14]), w, h, d, h_glob,
                       k, with_jitter);
}

__device__ __forceinline__ float tent_w(float off, int dd) {
  return fmaxf(0.0f, 1.0f - fabsf(off - (float)dd));
}

// The separable windowed warp of NC history channels at output (z, y, x):
//   sum_dx wx(offx[z,y,x]) sum_dy wy(offy[z,y,cx]) sum_dz wz(offz[z,cy,cx])
//       prev[c][cz, cy, cx]
// over the two taps per axis whose tent weight can be non-zero, in the
// order the three passes add them. prev: NC planes of [D, H, W] at stride
// `cstride` floats; ox the x offset at (z, y, x), oy_at(cx) the y offset at
// (z, y, cx), oz_at(b, cy, cx) the z offset at (z, cy, cx), cy the row of
// the y tap b of column cx. I: the index type (int where the planes hold
// under 2^31 floats: fewer registers).
template <int NC, class OyAt, class OzAt, class I = long>
__device__ __forceinline__ void warp8_by(const float* prev, I cstride,
                                         int z, int y, int x, int w, int h,
                                         int d, float ox, const OyAt& oy_at,
                                         const OzAt& oz_at, float* out) {
  float accx[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) accx[c] = 0.0f;
  int x0 = (int)floorf(ox);
  for (int a = 0; a < 2; ++a) {
    float wxa = tent_w(ox, x0 + a);
    int cx = clampi(x + x0 + a, 0, w - 1);
    float oy = oy_at(cx);
    int y0 = (int)floorf(oy);
    float accy[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) accy[c] = 0.0f;
    for (int b = 0; b < 2; ++b) {
      float wyb = tent_w(oy, y0 + b);
      int cy = clampi(y + y0 + b, 0, h - 1);
      float oz = oz_at(b, cy, cx);
      int z0 = (int)floorf(oz);
      float accz[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) accz[c] = 0.0f;
      for (int e = 0; e < 2; ++e) {
        float wze = tent_w(oz, z0 + e);
        int cz = clampi(z + z0 + e, 0, d - 1);
        I idx = ((I)cz * h + cy) * w + cx;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          accz[c] = accz[c] + __ldg(prev + (c * cstride + idx)) * wze;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) accy[c] = accy[c] + accz[c] * wyb;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) accx[c] = accx[c] + accy[c] * wxa;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = accx[c];
}

// ---- visibility.py: the low-rate upsample ----------------------------------

// The z-lerp + separable clamp-to-edge tent of a low channel [DL, HL, WL] at
// full froxel (z, y, x), split so that a froxel computes its taps once for
// every channel it reads: the slice terms (low_slice, constants of a slice
// tile), then the column's and the row's tent taps (low_taps). I: the
// index type of the offsets (int64_t in K2's and K6's wide forms, int
// elsewhere).
template <class I = int>
struct LowSliceT {
  I sa, sb;  // offsets of the low slices ka, kb = min(ka + 1, DL - 1)
  float vt;  // the z-lerp weight
};

template <class I = int>
__device__ __forceinline__ LowSliceT<I> low_slice(const VrTables& T, int z) {
  const float vu = ((float)z - (float)(T.ss - 1) * 0.5f) / (float)T.ss;
  const float vkf = clampf(floorf(vu), 0.0f, (float)T.dl - 1.0f);
  const int ka = (int)vkf;
  const int kb = min(ka + 1, T.dl - 1);
  LowSliceT<I> s;
  s.vt = clampf(vu - vkf, 0.0f, 1.0f);
  s.sa = (I)ka * T.hl * T.wl;
  s.sb = (I)kb * T.hl * T.wl;
  return s;
}

template <class I = int>
struct LowTapsT {
  I a0, b0, a1, b1;  // slice ka or kb (a, b), tent row ky0 or ky1 (0, 1)
  int kx0, kx1;
  float vt, wx0, wx1, wy0, wy1;
};

template <class I>
__device__ __forceinline__ LowTapsT<I> low_taps(const VrTables& T,
                                                const LowSliceT<I>& s, int y,
                                                int x) {
  LowTapsT<I> t;
  t.kx0 = T.tent_xk[x];
  t.kx1 = min(t.kx0 + 1, T.wl - 1);
  t.wx0 = T.tent_xw[x];
  t.wx1 = T.tent_xw[T.w + x];
  const int ky0 = T.tent_yk[y], ky1 = min(ky0 + 1, T.hl - 1);
  t.wy0 = T.tent_yw[y];
  t.wy1 = T.tent_yw[T.h + y];
  t.a0 = s.sa + (I)ky0 * T.wl;
  t.b0 = s.sb + (I)ky0 * T.wl;
  t.a1 = s.sa + (I)ky1 * T.wl;
  t.b1 = s.sb + (I)ky1 * T.wl;
  t.vt = s.vt;
  return t;
}

// The upsampled value of low channel `vol` at the taps: each tent row's
// z-lerps, the x tent, then the y tent.
template <class I>
__device__ __forceinline__ float low_at(const float* __restrict__ vol,
                                        const LowTapsT<I>& t) {
  float rows[2];
  const I as[2] = {t.a0, t.a1}, bs[2] = {t.b0, t.b1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float va0 = __ldg(vol + as[r] + t.kx0);
    const float vb0 = __ldg(vol + bs[r] + t.kx0);
    const float va1 = __ldg(vol + as[r] + t.kx1);
    const float vb1 = __ldg(vol + bs[r] + t.kx1);
    const float l0 = va0 + t.vt * (vb0 - va0);
    const float l1 = va1 + t.vt * (vb1 - va1);
    rows[r] = l0 * t.wx0 + l1 * t.wx1;
  }
  return rows[0] * t.wy0 + rows[1] * t.wy1;
}

// ---- the slice tiles of K2, K5, K6 and K7 ----------------------------------

// What the froxels of a TX x TY tile (columns x rows) of one slice share,
// computed once per block on the device with the expressions of
// the froxel centre (center_vz, center_fx, center_fy, froxel_vx,
// froxel_vy), reproj_offsets, low_slice and inv_dir (tile_scalars,
// then tile_line): the view depth of the slice's jittered and unjittered
// centres, froxel_vx of each column and froxel_vy of each row at both, the
// upsample's slice terms and, with BLEND (the shadow blend's), its view
// depth and log(fpz) and the inverse direction of each sun's shadow ray
// (the fixed forms' VR_MAX_DIR suns; the general forms keep them in dynamic
// shared memory, sun_inverses). I: the index type of the upsample's slice
// offsets.
template <int TX, int TY, class I = int>
struct TileTerms {
  using Index = I;
  static constexpr int LINES = 2 * TX + 2 * TY;  // tile_line's items
  float vxj[TX], vxc[TX], vyj[TY], vyc[TY];
  float vz_j, vz_c, vz_b, lfpz_b;
  LowSliceT<I> low;
  float sun_inv[VR_MAX_DIR][3];
};

// Step 1, before a barrier: the slice's scalars, one thread each, on the
// first lanes of as many of the block's NT threads' warps as there are
// scalars (their chains of log, exp and divisions run side by side).
// SCATTER false (K5, the shadow half alone) leaves out the unjittered
// centre's depth and the upsample's slice terms, which only the scatter
// reads. GEN (the general forms) leaves out the suns' items: sun_inverses.
template <bool BLEND, int NT, bool SCATTER = true, bool GEN = false,
          class Terms>
__device__ __forceinline__ void tile_scalars(const VrTables& T, int z,
                                             int tid, Terms& S) {
  const float* p = T.spar;
  const int items = BLEND ? 5 + (GEN ? 0 : T.n_dir) : 3;
  for (int item = 0; item < items; ++item) {
    if (tid != (item * 32) % NT + (item * 32) / NT) continue;
    if (!SCATTER && (item == 1 || item == 2)) continue;
    if (item == 0) {
      S.vz_j = center_vz(p, z, true, T.d);
    } else if (item == 1) {
      S.vz_c = center_vz(p, z, false, T.d);
    } else if (item == 2) {
      if (T.dl > 0) S.low = low_slice<typename Terms::Index>(T, z);
    } else if (item == 3) {
      S.vz_b = view_z(T.sbpar, (float)z + 0.5f, T.d);
    } else if (item == 4) {
      S.lfpz_b = logf(T.sbpar[14]);
    } else {
      const float* q = T.slights + 8 * (item - 5);
      float* inv = S.sun_inv[item - 5];
      inv[0] = inv_dir(-q[0]);
      inv[1] = inv_dir(-q[1]);
      inv[2] = inv_dir(-q[2]);
    }
  }
}

// The general forms' step 1 for the suns: the inverse direction of each
// sun's shadow ray, as tile_scalars' items 5.. compute them, 3 floats a sun
// at inv (dynamic shared memory: sun_inv_floats), the block's nt threads
// taking the suns in turn.
__host__ __device__ __forceinline__ int sun_inv_floats(int n_dir) {
  return 3 * n_dir;
}

__device__ __forceinline__ void sun_inverses(const VrTables& T, int tid,
                                             int nt, float* inv) {
  for (int li = tid; li < T.n_dir; li += nt) {
    const float* q = T.slights + 8 * li;
    inv[3 * li] = inv_dir(-q[0]);
    inv[3 * li + 1] = inv_dir(-q[1]);
    inv[3 * li + 2] = inv_dir(-q[2]);
  }
}

// The suns' inverse directions in device memory (the gen_global forms of K2,
// K5 and K7): sun_inverses over the whole grid of a launch, one thread a
// sun, into inv [n_dir, 3] -- the same device function as the blocks of the
// shared forms run, so the same bits. A template, so that only the sources
// that launch it compile it.
template <int = 0>
__global__ void sun_inverses_kernel(VrTables T, float* __restrict__ inv) {
  sun_inverses(T, blockIdx.x * blockDim.x + threadIdx.x,
               gridDim.x * blockDim.x, inv);
}

// Fill inv [n_dir, 3] on the stream, ahead of the kernel that reads it.
template <int = 0>
int fill_sun_inverses(const VrTables* T, float* inv,
                             cudaStream_t stream) {
  if (T->n_dir == 0) return 0;
  if (inv == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 256, blocks = (T->n_dir + threads - 1) / threads;
  sun_inverses_kernel<> <<<blocks, threads, 0, stream>>>(*T, inv);
  return (int)cudaGetLastError();
}

// A block's shared memory on the H100 (the opt-in limit) and what the
// slice tiles keep in static shared memory beside their dynamic bytes (under
// 1 KB: TileTerms; mirrored by ops/temporal.MAX_SHARED_BYTES and
// TILE_STATIC_SHARED). The general forms of K2, K5 and K7 keep the suns'
// inverse directions after their region where both fit, in device memory
// past that (VR_SUNS_*; mirrored by ops/scatter.sun_form).
#define VR_MAX_SHARED 232448
#define VR_TILE_STATIC 1024
#define VR_SUNS_SHARED 0  // the fixed form, or GEN with the suns in shared
#define VR_SUNS_GLOBAL 1  // GEN with the suns in device memory (gen_global)

// The sun form a launch of region_bytes (0: K7) and gen (the general
// instantiation) takes for n_dir suns: shared where the bytes fit, global
// past that, -1 where the region alone does not fit.
inline int sun_form_of(int region_bytes, bool gen, int n_dir) {
  if (region_bytes + VR_TILE_STATIC > VR_MAX_SHARED) return -1;
  const long bytes = region_bytes
                     + (gen ? (long)sun_inv_floats(n_dir) * sizeof(float)
                            : 0L);
  return bytes + VR_TILE_STATIC > VR_MAX_SHARED ? VR_SUNS_GLOBAL
                                                : VR_SUNS_SHARED;
}

// Whether a frame's counts pass the fixed forms' arrays: its suns (the
// shadow kernels K5 and K7) or also its fBm channels (K2 and K6, whose
// scatter reads them). The launchers then take the GEN instantiation.
inline bool general_suns(const VrTables& T) { return T.n_dir > VR_MAX_DIR; }

inline bool needs_general(const VrTables& T) {
  return general_suns(T) || T.n_noise > VR_MAX_NOISE;
}

// Step 2, after it: item j < LINES of the tile at (xt, yt); the unjittered
// items (vxc, vyc) are the scatter's.
template <int TX, int TY>
__device__ __forceinline__ bool tile_line_unjittered(int j) {
  return (j >= TX && j < 2 * TX) || j >= 2 * TX + TY;
}

template <int TX, int TY, class I>
__device__ __forceinline__ void tile_line(const VrTables& T, int xt, int yt,
                                          int j, TileTerms<TX, TY, I>& S) {
  const float* p = T.spar;
  if (j < TX) {
    S.vxj[j] = froxel_vx(p, center_fx(p, xt + j, true), S.vz_j, T.w);
  } else if (j < 2 * TX) {
    j -= TX;
    S.vxc[j] = froxel_vx(p, center_fx(p, xt + j, false), S.vz_c, T.w);
  } else if (j < 2 * TX + TY) {
    j -= 2 * TX;
    S.vyj[j] = froxel_vy(p, center_fy(p, yt + j, true, T.h_glob), S.vz_j,
                         T.h_glob);
  } else {
    j -= 2 * TX + TY;
    S.vyc[j] = froxel_vy(p, center_fy(p, yt + j, false, T.h_glob), S.vz_c,
                         T.h_glob);
  }
}

// The reprojection region of a TX x TY tile at (xt, yt), the reach of the
// shadow blend's warp taps: rows yt - k .. yt + TY + k and columns
// xt - k .. xt + TX + k, each clamped to the grid.
__host__ __device__ __forceinline__ int region_nx(int tx, int k) {
  return tx + 2 * k + 1;
}

__host__ __device__ __forceinline__ int region_ny(int ty, int k) {
  return ty + 2 * k + 1;
}

// Its dynamic shared memory, floats: the region's ox, oy, oz and success
// planes, then reproj_vx of its columns and reproj_vy of its rows
// (mirrored by ops/temporal.region_shared_bytes); the general forms of K2
// and K5 keep the suns' sun_inv_floats after it.
__host__ __device__ __forceinline__ int region_floats(int tx, int ty, int k) {
  const int nx = region_nx(tx, k), ny = region_ny(ty, k);
  return 4 * nx * ny + nx + ny;
}

// The shadow half of a slice tile: K5 shadow_blend is this alone, K2
// shadow_scatter runs it and then the scatter half, so K2 equals K5 then K6
// by construction. The block owns the TX x TY tile (blockIdx.x, blockIdx.y)
// of slice blockIdx.z, S its terms and dyn_s its region_floats. Steps 1 and
// 2, tile_region, end with a barrier (SCATTER: also the terms of the
// scatter half, tile_scalars; GEN: the suns' inverse directions after the
// region, sun_inverses):
//   1. the slice's scalars, then each column's and row's view-space terms,
//      and reproj_vx / reproj_vy of the region;
//   2. the reprojection offsets of the shadow blend, each once, at every
//      (row, column) of the region, into shared memory, and of each only
//      the outputs the warp reads: all four at the tile's own cells, oy and
//      oz in the other columns of its rows, oz alone in the other rows:
//      ~2.4 reprojections a froxel where one froxel's own warp took 7.
// Step 3, tile_blend, per froxel (x, y) of the grid (index i of n):
//   3. the sun rays (their inverse directions from step 1, the plane and
//      sphere tests leaving before a division or a root whose answer is
//      known), warp8_by<1> reading the offsets from shared memory, the
//      weight-mode blend cur + alpha * success * (warped - cur) (sbpar:
//      jittered reprojection, the 1e-4 uvw nudge) and the store of the
//      history out_sh; the jittered world position (wx, wy, wz) and each
//      sun's blended shadow (blended; GEN: in out_sh alone) are left for
//      the scatter half. The fixed form casts every sun's ray before the
//      warps; GEN takes the suns one at a time, each value computed alone,
//      so the two are the same bit for bit.
// Every value is the thread-per-froxel form's (sun_shadow, then warp8_by
// over the reprojection offsets at each tap, as temporal_blend.cu's weight
// mode blends), from the same operations in the same order. I: the index
// type of the [Nd, D, H, W] planes (int, or int64_t in K2's and K5's wide
// forms, whose launchers also run the slices in parts of at most
// VR_MAX_GRID_Z: the block's slice is blockIdx.z + z0).
// K10 (temporal_blend.cu region_offsets) runs steps 1b and 2 on its own
// blend table in a copy of this loop: a routine shared by the three
// kernels made K5 2% slower at the same registers and spills, so
// tile_region stays as K2 and K5 were measured. Change the two together.
// SG (gen_global, GEN only): the suns' inverse directions are in device
// memory (fill_sun_inverses), not computed here. RG (region_global, GEN and
// SG only): the region's offsets are in device memory (fill_region_plane),
// so step 1 stops after the tile's own lines and step 2 is not run.
template <bool SCATTER, int TX, int TY, bool GEN = false, bool SG = false,
          bool RG = false, class I = int>
__device__ __forceinline__ void tile_region(const VrTables& T,
                                            TileTerms<TX, TY, I>& S,
                                            float* dyn_s, int z0 = 0) {
  static_assert(!RG || (GEN && SG), "region_global reads its suns from "
                "device memory too");
  constexpr int NT = TX * TY;
  const int w = T.w, h = T.h, d = T.d, k = T.k;
  const int nx = region_nx(TX, k), ny = region_ny(TY, k), nr = nx * ny;
  float* ox_s = dyn_s;
  float* oy_s = dyn_s + nr;
  float* oz_s = dyn_s + 2 * nr;
  float* ok_s = dyn_s + 3 * nr;
  float* rvx_s = dyn_s + 4 * nr;
  float* rvy_s = rvx_s + nx;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  const int z = blockIdx.z + z0;
  const float* sb = T.sbpar;

  // 1. the slice's scalars; then the columns' and rows' terms
  tile_scalars<true, NT, SCATTER, GEN>(T, z, tid, S);
  if constexpr (GEN && !SG)
    sun_inverses(T, tid, NT, dyn_s + region_floats(TX, TY, k));
  __syncthreads();
  constexpr int LINES = TileTerms<TX, TY>::LINES;
  if constexpr (RG) {
    for (int j = tid; j < LINES; j += NT)
      if (SCATTER || !tile_line_unjittered<TX, TY>(j))
        tile_line(T, xt, yt, j, S);
    __syncthreads();
  } else {
    for (int j = tid; j < LINES + nx + ny; j += NT) {
      if (j < LINES) {
        if (SCATTER || !tile_line_unjittered<TX, TY>(j))
          tile_line(T, xt, yt, j, S);
      } else if (j < LINES + nx) {
        const int c = j - LINES;
        rvx_s[c] = reproj_vx(sb, clampi(xt - k + c, 0, w - 1), S.vz_b, w);
      } else {
        const int r = j - LINES - nx;
        rvy_s[r] = reproj_vy(sb, clampi(yt - k + r, 0, h - 1), S.vz_b,
                             T.h_glob);
      }
    }
    __syncthreads();
    // 2. reproj_offsets(sbpar, ...) at every (row r, column c) of the region,
    // at (clamp(yt - k + r), clamp(xt - k + c)), each output only where the
    // warp reads it
    {
      const int r = ty + k, c = tx + k, j = r * nx + c;
      const Reproj o = reproj_view_l(sb, z, min(yt + ty, h - 1),
                                     min(xt + tx, w - 1), rvx_s[c], rvy_s[r],
                                     S.vz_b, S.lfpz_b, w, h, d, T.h_glob, k,
                                     true);
      ox_s[j] = o.ox;
      oy_s[j] = o.oy;
      oz_s[j] = o.oz;
      ok_s[j] = o.success;
    }
    const int side = 2 * k + 1;       // the region's columns (rows) past the
    const int n_side = TY * side;     // tile's, k before and k + 1 after it
    for (int j = tid; j < n_side + side * nx; j += NT) {
      if (j < n_side) {
        const int r = j / side, e = j - r * side;
        const int c = e < k ? e : TX + e;
        const Reproj o = reproj_view_l(sb, z, min(yt + r, h - 1),
                                       clampi(xt - k + c, 0, w - 1), rvx_s[c],
                                       rvy_s[r + k], S.vz_b, S.lfpz_b, w, h, d,
                                       T.h_glob, k, true);
        oy_s[(r + k) * nx + c] = o.oy;
        oz_s[(r + k) * nx + c] = o.oz;
      } else {
        const int q = j - n_side, e = q / nx, c = q - e * nx;
        const int r = e < k ? e : TY + e;
        oz_s[r * nx + c] =
            reproj_view_l(sb, z, clampi(yt - k + r, 0, h - 1),
                          clampi(xt - k + c, 0, w - 1), rvx_s[c], rvy_s[r],
                          S.vz_b, S.lfpz_b, w, h, d, T.h_glob, k, true).oz;
      }
    }
    __syncthreads();
  }
}

// SG (gen_global, GEN only): the suns' inverse directions read from
// sun_inv_g [n_dir, 3] in device memory, every thread of a warp at the same
// address, where GEN reads them after the region. RG (region_global, GEN
// and SG only): the warp's offsets read from region_g [4, D, H, W]
// (fill_region_plane) at the froxel and at the taps' columns and rows,
// where the shared forms read them from the region: the same values.
template <bool ARMS, int TX, int TY, bool GEN = false, bool SG = false,
          bool RG = false, class I = int>
__device__ __forceinline__ void tile_blend(
    const VrTables& T, const float* __restrict__ prev_sh,
    float* __restrict__ out_sh, const TileTerms<TX, TY, I>& S,
    const float* dyn_s, int x, int y, I n, I i, float& wx, float& wy,
    float& wz, float* blended, int z0 = 0,
    const float* __restrict__ sun_inv_g = nullptr,
    const float* __restrict__ region_g = nullptr) {
  const int w = T.w, h = T.h, d = T.d, k = T.k;
  const int nx = region_nx(TX, k), nr = nx * region_ny(TY, k);
  const float* ox_s = dyn_s;
  const float* oy_s = dyn_s + nr;
  const float* oz_s = dyn_s + 2 * nr;
  const float* ok_s = dyn_s + 3 * nr;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int xt = blockIdx.x * TX, yt = blockIdx.y * TY;
  const int z = blockIdx.z + z0;
  const float* sb = T.sbpar;
  // dir_shadow_slice: jittered world position, one ray per sun
  view_world(T.spar, S.vxj[tx], S.vyj[ty], S.vz_j, wx, wy, wz);
  if constexpr (RG) {  // GEN's loop, the offsets from region_g
    const I row = ((I)z * h + y) * w;  // + cx: column cx of row y
    const float swgt = sb[20] * __ldg(region_g + (3 * n + i));
    const auto oy_at = [&](int cx) {
      return __ldg(region_g + (n + row + cx));
    };
    const auto oz_at = [&](int, int cy, int cx) {
      return __ldg(region_g + (2 * n + ((I)z * h + cy) * w + cx));
    };
    const float ox = __ldg(region_g + i);
    for (int li = 0; li < T.n_dir; ++li) {
      const float cur = sun_shadow<ARMS, true>(T, li, wx, wy, wz,
                                               sun_inv_g + 3 * li);
      float warped;
      warp8_by<1>(prev_sh + li * n, n, z, y, x, w, h, d, ox, oy_at, oz_at,
                  &warped);
      out_sh[li * n + i] = cur + swgt * (warped - cur);
    }
  } else if constexpr (GEN) {  // each sun's ray, warp and blend in turn
    const float* inv = SG ? sun_inv_g : dyn_s + region_floats(TX, TY, k);
    const int row_y = (ty + k) * nx + k - xt;
    const float swgt = sb[20] * ok_s[row_y + x];
    const auto oy_at = [&](int cx) { return oy_s[row_y + cx]; };
    const auto oz_at = [&](int, int cy, int cx) {
      return oz_s[(cy - yt + k) * nx + k - xt + cx];
    };
    for (int li = 0; li < T.n_dir; ++li) {
      const float cur = sun_shadow<ARMS, true>(T, li, wx, wy, wz,
                                               inv + 3 * li);
      float warped;
      warp8_by<1>(prev_sh + li * n, n, z, y, x, w, h, d, ox_s[row_y + x],
                  oy_at, oz_at, &warped);
      out_sh[li * n + i] = cur + swgt * (warped - cur);
    }
  } else {
    float cur[VR_MAX_DIR];
    for (int li = 0; li < T.n_dir; ++li)
      cur[li] = sun_shadow<ARMS, true>(T, li, wx, wy, wz, S.sun_inv[li]);
    // the shadow blend (weight mode): the offsets at (y, cx) and (cy, cx)
    // from the region, column cx at cx - (xt - k), row cy at cy - (yt - k)
    const int row_y = (ty + k) * nx + k - xt;
    const float swgt = sb[20] * ok_s[row_y + x];
    const auto oy_at = [&](int cx) { return oy_s[row_y + cx]; };
    const auto oz_at = [&](int, int cy, int cx) {
      return oz_s[(cy - yt + k) * nx + k - xt + cx];
    };
    for (int li = 0; li < T.n_dir; ++li) {
      float warped;
      warp8_by<1>(prev_sh + li * n, n, z, y, x, w, h, d, ox_s[row_y + x],
                  oy_at, oz_at, &warped);
      blended[li] = cur[li] + swgt * (warped - cur[li]);
      out_sh[li * n + i] = blended[li];
    }
  }
}

// The region forms of K2, K5, K10 and K3 (mirrored by
// ops/temporal.region_form and ops/frame_fused.k3_window_form): the
// region_shared form stages a tile's reprojection offsets in dynamic shared
// memory (region_floats; K3: its chunk's, integrate_blend.cu k3_shared).
// Past a block's shared memory (the 16 x 16 slice tiles from k = 52, K3
// from k = 159) the launchers' region_global form reads them from device
// memory instead: fill_region_plane writes them first. That form is the
// wide index form's instantiation (64-bit indices, the slices or rows in
// parts) and, in K2 and K5, gen_global's (the suns' inverse directions in
// device memory too): the forms PRs 25-28 hold bit for bit the narrow,
// fixed and general ones.
#define VR_REGION_SHARED 0
#define VR_REGION_GLOBAL 1

// The region form of a launch whose region takes region_bytes of dynamic
// shared memory beside static_bytes of static shared memory.
inline int region_form_of(long region_bytes, long static_bytes) {
  return region_bytes + static_bytes > VR_MAX_SHARED ? VR_REGION_GLOBAL
                                                     : VR_REGION_SHARED;
}

// The region_global forms' pre-pass: reproj_view_l at every froxel
// (z, y, x) of a w x h x d launch on blend table bp, its ox, oy, oz and
// success into plane [4, d, h, w] (device memory, 64-bit indices). The
// shared forms compute the value at the region cell of column x and row y
// from the same device functions on the same arguments (the slice's view
// depth view_z(bp, z + 0.5, d) and logf(bp[14]), reproj_vx of the column,
// reproj_vy of the row), so each cell holds the same bits; every froxel
// has all four outputs, where the shared forms keep only those their warp
// reads. A block takes 128 columns of one row at a time, its rows
// (z * h + y) strided over the launch grid's y axis. A template, so that
// only the sources that launch it compile it. Bound: bytes, 16 a froxel
// written (66 MB at 240x135x128, ~20 us at 3.35 TB/s), ~60 flops a froxel.
template <int = 0>
__global__ void __launch_bounds__(128)
region_plane_kernel(const float* __restrict__ bp, bool with_jitter, int w,
                    int h, int d, int h_glob, int k,
                    float* __restrict__ plane) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const long rows = (long)d * h, n = rows * w;
  for (long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int z = (int)(r / h), y = (int)(r - (long)z * h);
    const float vz = view_z(bp, (float)z + 0.5f, d);
    const Reproj o = reproj_view_l(bp, z, y, x, reproj_vx(bp, x, vz, w),
                                   reproj_vy(bp, y, vz, h_glob), vz,
                                   logf(bp[14]), w, h, d, h_glob, k,
                                   with_jitter);
    const long i = r * w + x;
    plane[i] = o.ox;
    plane[n + i] = o.oy;
    plane[2 * n + i] = o.oz;
    plane[3 * n + i] = o.success;
  }
}

// Fill plane [4, d, h, w] on the stream, ahead of the kernel that reads it.
template <int = 0>
int fill_region_plane(const float* bp, bool with_jitter, int w, int h,
                      int d, int h_glob, int k, float* plane,
                      cudaStream_t stream) {
  if (plane == nullptr) return (int)cudaErrorInvalidValue;
  const long rows = (long)d * h;
  const dim3 grid((w + 127) / 128, (unsigned)(rows < 65535 ? rows : 65535));
  region_plane_kernel<><<<grid, 128, 0, stream>>>(bp, with_jitter, w, h, d,
                                                  h_glob, k, plane);
  return (int)cudaGetLastError();
}

// The index forms of K2, K3, K5-K12 (mirrored by ops/cuda.INDEX_FORMS):
// the narrow form indexes in 32 bits and puts its slices (K3: its rows;
// K12: its (sun, slice) pairs) on one launch-grid axis; the wide form is
// the same kernel on int64_t indices, launched in parts of at most
// VR_MAX_GRID_Z slices (rows, pairs). K8 and K9 run 1-D grids: their wide
// forms are one launch.
// A launcher takes the narrow form wherever it fits, or the form it is
// given. K1 has a bound of its own (bake_radiance.cu k1_fits).
#define VR_FORM_RULE -1
#define VR_FORM_NARROW 0
#define VR_FORM_WIDE 1

// The parts of n slices (rows) of a launch-grid axis: the first index of
// part p is p * VR_MAX_GRID_Z (mirrored by ops/cuda.grid_parts).
inline int grid_part_count(int n) {
  return (n + VR_MAX_GRID_Z - 1) / VR_MAX_GRID_Z;
}

// Whether a table of n rows of `width` floats each holds 2^31 floats or
// more: past a 32-bit index.
inline bool past_int(long n, long width) {
  return n * width > 2147483647L;
}

// What the narrow forms of the slice tiles K5, K6 and K7 share (mirrored
// by ops/scatter.tile_planes_why): the [max(4, Nd), D, H, W] planes
// (the histories, the shadow volume, the scatter and material planes)
// under 2^31 floats, on at most VR_MAX_GRID_Z slices (a slice a launch-grid
// z index). K6 adds the low channels and the schedule it reads.
inline bool tile_planes_fit(const VrTables& T) {
  const long n = (long)T.w * T.h * T.d;
  return !past_int(T.n_dir > 4 ? T.n_dir : 4, n) && T.d <= VR_MAX_GRID_Z;
}

// What every form of K5 and K7 (tiles of ty rows) needs (mirrored by
// ops/scatter.check_tile_indices): at most VR_MAX_GRID_Z row tiles on the
// launch grid's y axis, the suns' table [Nd, 8] under 2^31 floats.
inline bool tile_rows_fit(const VrTables& T, int ty) {
  return (T.h + ty - 1) / ty <= VR_MAX_GRID_Z && !past_int(T.n_dir, 8);
}

// ---- scatter.py: the per-froxel in-scatter ---------------------------------

// scatter.scatter_slice at froxel (z, y, x) (i its index in the [D, H, W]
// planes of n froxels; low_s the upsample's terms of slice z), jittered
// world position (wx, wy, wz) and unjittered (cwx, cwy, cwz):
// out = (r, g, b, ext).
// Material: MAT_PLANES false evaluates the media table here and writes
// ext = (luma(sigma_s) + sigma_a) x suns; MAT_PLANES true reads sigma_s rgb
// from mat_a [4, D, H, W] and phase g from mat_b [1, D, H, W] and leaves
// out[3] alone (the caller adds the extinction).
// Local lights, by LOCAL:
//   VR_LOCAL_RADIANCE  the low-rate radiance of `low` [3 + n_noise, DL, HL,
//       WL] upsampled, times sigma_s; with the media evaluated here, the
//       fBm factors upsampled from its noise channels when n_noise > 0;
//   VR_LOCAL_RAY       (low unused) every light of the slice's schedule
//       order[z][0 .. count[z]) adds light_factor x (1 - any_hit x gate) x
//       colour x sigma_s, in schedule order (ascending light index);
//   VR_LOCAL_BAKED     the same loop, the shadow term read from the
//       low-rate per-light visibility `low` [NL, DL, HL, WL], upsampled
//       (z-lerp, x tent, y tent) at the light's channel.
// The upsample's taps are computed once per froxel for all its channels. In
// both loops the fBm is evaluated here. Then every sun adds colour x
// sun_at(li) (its blended shadow) x HG x sigma_s at the unjittered centre
// (the jittered one with jitter_dir), in sun order. ARMS: the rays' any_hit
// instantiation. GEN (any fBm channel count): each baked fBm factor is
// upsampled where the material reads it, where the fixed form upsamples
// its VR_MAX_NOISE channels into an array first: the same values. I: the
// index type of the planes, the low volume and the schedule (int64_t in
// K2's and K6's wide forms, int elsewhere), deduced from i and n.
template <int LOCAL, bool MAT_PLANES, bool ARMS, bool GEN = false,
          class SunAt, class I>
__device__ void scatter_froxel(const VrTables& T, const LowSliceT<I>& low_s,
                               const float* __restrict__ low, int z, int y,
                               int x, I i, I n, float wx, float wy,
                               float wz, float cwx, float cwy, float cwz,
                               const SunAt& sun_at, float* out,
                               const float* __restrict__ mat_a = nullptr,
                               const float* __restrict__ mat_b = nullptr) {
  const float* p = T.spar;
  const I lplane = (I)T.dl * T.hl * T.wl;
  LowTapsT<I> up;
  if constexpr (LOCAL != VR_LOCAL_RAY) up = low_taps(T, low_s, y, x);
  float sr, sg, sbl, phg;
  if constexpr (MAT_PLANES) {
    sr = __ldg(mat_a + i);
    sg = __ldg(mat_a + n + i);
    sbl = __ldg(mat_a + 2 * n + i);
    phg = __ldg(mat_b + i);
  } else {
    const bool baked_noise = LOCAL == VR_LOCAL_RADIANCE && T.n_noise > 0;
    float s_a;
    if constexpr (GEN) {
      const auto noise_at = [&](int c) {
        return low_at(low + (3 + c) * lplane, up);
      };
      material(T, wx, wy, wz, baked_noise, noise_at, sr, sg, sbl, s_a, phg);
    } else {
      float noise[VR_MAX_NOISE];
      if (baked_noise)
        for (int c = 0; c < T.n_noise; ++c)
          noise[c] = low_at(low + (3 + c) * lplane, up);
      const auto noise_at = [&](int c) { return noise[c]; };
      material(T, wx, wy, wz, baked_noise, noise_at, sr, sg, sbl, s_a, phg);
    }
    out[3] = (0.3f * sr + 0.59f * sg + 0.11f * sbl + s_a) * (float)T.n_dir;
  }
  const float g2 = phg * phg;
  const float hg_num = (1.0f - g2) / (float)(4.0 * VR_PI);
  float ar, ag, ab;
  if constexpr (LOCAL != VR_LOCAL_RADIANCE) {
    float vdx = wx - p[20], vdy = wy - p[21], vdz = wz - p[22];
    const float invd = rsqrt_exact(vdx * vdx + vdy * vdy + vdz * vdz
                                   + 1e-18f);
    vdx = vdx * invd;
    vdy = vdy * invd;
    vdz = vdz * invd;
    ar = ag = ab = 0.0f;
    const int* ord = T.order + (I)z * T.n_lights;
    const int n_act = T.count[z];
    for (int j = 0; j < n_act; ++j) {
      const int li = ord[j];
      const float* q = T.lights + 16 * li;
      float ldx, ldy, ldz, dist;
      const float factor = light_factor(q, wx, wy, wz, vdx, vdy, vdz, phg,
                                        g2, hg_num, ldx, ldy, ldz, dist);
      float shadow;
      if constexpr (LOCAL == VR_LOCAL_BAKED) {
        shadow = low_at(low + li * lplane, up);
      } else {
        const float occ = any_hit<ARMS>(T, wx, wy, wz, -ldx, -ldy, -ldz,
                                        dist - 0.05f, T.hf_local);
        shadow = 1.0f - occ * q[14];
      }
      const float base = factor * shadow;
      ar = ar + base * q[3] * sr;
      ag = ag + base * q[4] * sg;
      ab = ab + base * q[5] * sbl;
    }
  } else {
    ar = low_at(low, up) * sr;
    ag = low_at(low + lplane, up) * sg;
    ab = low_at(low + 2 * lplane, up) * sbl;
  }
  if (T.n_dir) {
    if (T.jitter_dir) {
      cwx = wx;
      cwy = wy;
      cwz = wz;
    }
    float dvx = cwx - p[20], dvy = cwy - p[21], dvz = cwz - p[22];
    const float inv = rsqrt_exact(dvx * dvx + dvy * dvy + dvz * dvz + 1e-18f);
    dvx = dvx * inv;
    dvy = dvy * inv;
    dvz = dvz * inv;
    for (int li = 0; li < T.n_dir; ++li) {
      const float* q = T.dirs + 8 * li;
      const float cos_t = -(dvx * q[0] + dvy * q[1] + dvz * q[2]);
      const float b = 1.0f + g2 - 2.0f * phg * cos_t;
      const float rb = rsqrt_exact(b);
      const float hg = hg_num * rb * rb * rb;
      const float base = sun_at(li) * hg;
      ar = ar + base * q[3] * sr;
      ag = ag + base * q[4] * sg;
      ab = ab + base * q[5] * sbl;
    }
  }
  out[0] = ar;
  out[1] = ag;
  out[2] = ab;
}

// ---- integrate.py: the jittered xy sample and the slice integral -----------

// integrate.make_xy_blend weights for the jitter offset (ox, oy) in (-1, 1):
// x taps (-1, 0, +1) then y taps.
__device__ __forceinline__ void xy_blend_weights(float ox, float oy,
                                                 float* wts) {
  wts[0] = fmaxf(-ox, 0.0f);
  wts[1] = 1.0f - fabsf(ox);
  wts[2] = fmaxf(ox, 0.0f);
  wts[3] = fmaxf(-oy, 0.0f);
  wts[4] = 1.0f - fabsf(oy);
  wts[5] = fmaxf(oy, 0.0f);
}

// The 3-tap clamped xy tent of the 4 scatter planes sc [4, D, H, W]
// (n = D*H*W, of index type I) at (z, y, x), x first then y.
template <class I>
__device__ __forceinline__ void xy_blend4(const float* __restrict__ sc,
                                          I n, int z, int y, int x,
                                          int w, int h, const float* wts,
                                          float* out) {
  const int xm = max(x - 1, 0), xp = min(x + 1, w - 1);
  const int ym = max(y - 1, 0), yp = min(y + 1, h - 1);
  const int rows[3] = {ym, y, yp};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* pl = sc + (c * n + (I)z * h * w);
    float px[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* row = pl + (I)rows[r] * w;
      px[r] = wts[0] * __ldg(row + xm) + wts[1] * __ldg(row + x)
              + wts[2] * __ldg(row + xp);
    }
    out[c] = wts[3] * px[0] + wts[4] * px[1] + wts[5] * px[2];
  }
}

// The thickness of slice z in view depth, from the depth mapping (fpw,
// near; lfpz = log(fpz)).
__device__ __forceinline__ float slice_dz(float lfpz, float fpw, float near_,
                                          int z, int d) {
  const float zf = (float)z;
  const float vz_hi = (expf(lfpz * (zf + 0.5f) / (float)d) - 1.0f) * fpw
                      + near_;
  const float vz_lo = zf > 0.0f
      ? (expf(lfpz * (zf - 0.5f) / (float)d) - 1.0f) * fpw + near_
      : near_;
  return vz_hi - vz_lo;
}

// The terms of one slice of the front-to-back integral: its transmittance
// t and the factor that scales its sampled radiance, from its extinction
// `ext` and its thickness dz. The expm1 form, Taylor below an optical
// depth of 1e-2.
__device__ __forceinline__ void slice_terms(float dz, float ext, float& t,
                                            float& factor) {
  const float od = ext * dz;
  t = expf(-od);
  const bool small = od < 1e-2f;
  factor = small ? dz * (1.0f - 0.5f * od * (1.0f - od / 3.0f))
                 : (1.0f - t) / ext;
}

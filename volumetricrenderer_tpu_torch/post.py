"""Post-processing stack: the HDR image to a display image.

Counterpart of `volumetricrenderer_tpu/post.py`, effect for effect, in the
same order and under the same on/off conditions (`apply_post_planes`):
lens distortion -> SSR -> DoF -> motion blur -> chromatic aberration ->
bloom -> vignette -> AO -> tonemap -> grading -> LUTs -> grain -> gamma,
then the LDR pass SMAA -> FXAA -> dither; TAA (`taa_step`) and auto
exposure (`auto_exposure_step`) are steps the caller threads across frames.
See the JAX module's docstring for what each effect models.

The chain is channel-planar: lists of [H, W] float32 planes, as there.
Everything is plain torch, as it is plain XLA in the JAX package, except
the SSR march, which is kernel K13 (ops/ssr.py, csrc/ssr_march.cu) on a
CUDA tensor and, under grad, K13 forward and K15 (csrc/ssr_march_grad.cu)
backward (ops/ssr.SsrMarchFn). Every shift, blur, ring and tent is built from edge-replicated
pads and slices in the JAX expression order, never from a convolution:
cuDNN would run a float32 convolution in TF32 on the card. The camera
matrix product of `camera_velocity` is written out for the same reason.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.material import _s32
from volumetricrenderer_tpu_torch.ops.noise import interleaved_gradient_noise

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """The JAX package's PostConfig: the same fields and defaults."""
    exposure: float = 1.0
    bloom_strength: float = 0.0        # 0 disables bloom
    bloom_threshold: float = 1.0
    bloom_levels: int = 3
    vignette: float = 0.0              # 0 disables
    tonemap: str = "aces"              # "aces" | "none"
    gamma: float = 2.2
    grade_lift: tuple = (0.0, 0.0, 0.0)
    grade_gamma: tuple = (1.0, 1.0, 1.0)
    grade_gain: tuple = (1.0, 1.0, 1.0)
    saturation: float = 1.0
    contrast: float = 1.0
    chromatic_aberration: float = 0.0
    grain: float = 0.0
    grain_seed: int = 0
    dof_focus_distance: float = 0.0    # 0 disables DoF
    dof_focal_length: float = 0.05     # meters (50mm)
    dof_aperture: float = 5.6          # f-number
    dof_max_coc: float = 8.0           # pixels at full blur
    motion_blur: float = 0.0           # 0 disables
    grade_luts: tuple = None           # 3 tuples of node values, or None
    auto_exposure: bool = False
    ae_filtering: tuple = (0.5, 0.95)
    ae_min_ev: float = -9.0
    ae_max_ev: float = 9.0
    ae_key: float = 1.0
    ae_speed_up: float = 2.0
    ae_speed_down: float = 1.0
    fxaa: bool = False
    fxaa_abs_threshold: float = 0.0312
    fxaa_rel_threshold: float = 0.063
    lens_distortion: float = 0.0       # 0 disables
    ld_intensity_x: float = 1.0
    ld_intensity_y: float = 1.0
    ld_center: tuple = (0.0, 0.0)
    ld_scale: float = 1.0
    ld_window: int = 8
    dithering: bool = False
    ao_intensity: float = 0.0          # 0 disables
    ao_radius_px: int = 8
    ao_multiscale: bool = False
    ao_levels: int = 4
    taa_sharpness: float = 0.25
    taa_stationary_blend: float = 0.95
    taa_motion_blend: float = 0.85
    taa_window: int = 4
    smaa: bool = False
    smaa_threshold: float = 0.1
    smaa_max_search: int = 16
    ssr_intensity: float = 0.0         # 0 disables
    ssr_steps: int = 12
    ssr_dirs: int = 8
    ssr_thickness: float = 0.6
    ssr_max_px: int = 56
    ssr_downsample: int = 4
    ssr_fov_y_deg: float = 60.0
    ssr_distance_fade: float = 0.5


def _split(rgb: torch.Tensor):
    return [rgb[..., c] for c in range(3)]


def _merge(planes) -> torch.Tensor:
    return torch.stack(planes, dim=-1)


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a positive int n by binary powering, jax.lax.integer_pow's
    order of multiplications (torch's pow would round otherwise)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """jnp.mod for floats: fmod, moved into the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def _coords(n: int, dev) -> torch.Tensor:
    """(i + 0.5) / n over the n pixel centres."""
    return (torch.arange(n, dtype=f32, device=dev) + 0.5) / n


def aces_tonemap(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES fit (elementwise)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


# --------------------------------------------------------------------------- #
# Planar primitives
# --------------------------------------------------------------------------- #

def _down2_p(p: torch.Tensor) -> torch.Tensor:
    h2, w2 = p.shape[0] // 2, p.shape[1] // 2
    p = p[:h2 * 2, :w2 * 2]
    p = (p[0::2] + p[1::2]) * 0.5
    return (p[:, 0::2] + p[:, 1::2]) * 0.5


def _pad_edge(p: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """p with its edge rows and columns replicated outward."""
    if not (top or bottom or left or right):
        return p
    return F.pad(p[None], (left, right, top, bottom), mode="replicate")[0]


def _up2_p(p: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    up = p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    up = _pad_edge(up, 0, max(0, out_h - up.shape[0]), 0,
                   max(0, out_w - up.shape[1]))
    return up[:out_h, :out_w]


def _blur3_p(p: torch.Tensor) -> torch.Tensor:
    """Separable [1,2,1]/4 blur with edge clamp."""
    q = _pad_edge(p, 1, 1, 0, 0)
    p = q[:-2] * 0.25 + q[1:-1] * 0.5 + q[2:] * 0.25
    q = _pad_edge(p, 0, 0, 1, 1)
    return q[:, :-2] * 0.25 + q[:, 1:-1] * 0.5 + q[:, 2:] * 0.25


def _shift2_p(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static integer shift with edge clamp: out[y, x] = p[clamp(y + dy),
    clamp(x + dx)]."""
    h, w = p.shape
    q = _pad_edge(p, max(-dy, 0), max(dy, 0), max(-dx, 0), max(dx, 0))
    y0, x0 = max(dy, 0), max(dx, 0)
    return q[y0:y0 + h, x0:x0 + w]


# --------------------------------------------------------------------------- #
# Effects
# --------------------------------------------------------------------------- #

def _bloom_p(planes, threshold: float, levels: int):
    outs = []
    for p in planes:
        cur = torch.clamp(p - threshold, min=0.0)
        pyr = []
        for _ in range(levels):
            cur = _blur3_p(_down2_p(cur))
            pyr.append(cur)
        out = pyr[-1]
        for lvl in reversed(pyr[:-1]):
            out = lvl + _up2_p(out, lvl.shape[0], lvl.shape[1])
        outs.append(_up2_p(out, p.shape[0], p.shape[1]))
    return outs


def bloom(rgb: torch.Tensor, threshold: float, levels: int) -> torch.Tensor:
    """Threshold -> downsample pyramid -> blur -> additive upsample chain."""
    return _merge(_bloom_p(_split(rgb), threshold, levels))


def _ca_p(planes, strength_px: float):
    """Radial R/B shift by one static pixel shift per half-plane."""
    r, g, b = planes
    h, w = r.shape
    yy = _coords(h, r.device) - 0.5
    xx = _coords(w, r.device) - 0.5
    r2 = torch.clamp((xx[None, :] * xx[None, :] + yy[:, None] * yy[:, None])
                     * 4.0, max=1.0)
    amt = float(np.clip(np.float32(strength_px), 0.0, 8.0)) * r2

    def shifted(p, s):
        xs = torch.where(xx[None, :] > 0, _shift2_p(p, 0, s),
                         _shift2_p(p, 0, -s))
        return torch.where(yy[:, None] > 0, _shift2_p(xs, s, 0),
                           _shift2_p(xs, -s, 0))

    r_in = shifted(r, 1)
    b_in = shifted(b, 2)
    frac = amt * 0.5
    return [r + frac * (r_in - r), g, b + frac * (b_in - b)]


def chromatic_aberration(rgb: torch.Tensor, strength_px: float
                         ) -> torch.Tensor:
    return _merge(_ca_p(_split(rgb), strength_px))


def _grade_p(planes, cfg: PostConfig):
    """Lift/gamma/gain (ASC CDL-style) + saturation + contrast around 0.5."""
    out = []
    for c, p in enumerate(planes):
        x = torch.clamp(p, min=0.0)
        x = torch.clamp(x * cfg.grade_gain[c] + cfg.grade_lift[c] * (1.0 - x),
                        min=0.0)
        out.append(x ** (1.0 / max(cfg.grade_gamma[c], 1e-4)))
    luma = 0.2126 * out[0] + 0.7152 * out[1] + 0.0722 * out[2]
    out = [luma + cfg.saturation * (x - luma) for x in out]
    if cfg.contrast != 1.0:
        out = [0.5 + cfg.contrast * (x - 0.5) for x in out]
    return out


def color_grade(rgb: torch.Tensor, cfg: PostConfig) -> torch.Tensor:
    return _merge(_grade_p(_split(rgb), cfg))


def _grain_noise(h: int, w: int, seed: int, device) -> torch.Tensor:
    """Hash-noise plane (JenkinsHash-style integer mix). The uint32 bits ride
    int32 tensors, as ops/material._hash3's do: products and sums wrap to
    the same 32 bits, and the right shifts are made logical by masking; the
    float comes from the unsigned value."""
    ix = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    iy = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    hsh = ix * _s32(0x8DA6B343) + iy * _s32(0xD8163841) \
        + _s32(seed * 0x9E3779B9)
    hsh = hsh ^ ((hsh >> 13) & 0x7FFFF)
    hsh = hsh * _s32(0x85EBCA6B)
    hsh = hsh ^ ((hsh >> 16) & 0xFFFF)
    u = hsh.to(torch.int64) & 0xFFFFFFFF
    return u.to(f32) * (1.0 / 4294967295.0) - 0.5


def _luma_p(planes):
    return 0.2126 * planes[0] + 0.7152 * planes[1] + 0.0722 * planes[2]


def film_grain(rgb: torch.Tensor, strength: float, seed: int
               ) -> torch.Tensor:
    """Hash-noise grain, luminance-masked so shadows carry more grain."""
    h, w = rgb.shape[:2]
    n = _grain_noise(h, w, seed, rgb.device)
    mask = 1.0 - torch.clamp(_luma_p(_split(rgb)), 0.0, 1.0) * 0.5
    return rgb + (strength * n * mask)[..., None]


def circle_of_confusion(view_depth: torch.Tensor, cfg: PostConfig
                        ) -> torch.Tensor:
    """Thin-lens CoC in pixels (DepthOfField.cs:153-161 model)."""
    f = cfg.dof_focal_length
    big_f = float(max(np.float32(cfg.dof_focus_distance),
                      np.float32(f + 1e-4)))
    a = f / cfg.dof_aperture
    d = torch.clamp(view_depth, min=1e-4)
    denom = float(np.float32(big_f) - np.float32(f))
    coc_m = a * f * torch.abs(d - big_f) / (d * denom)
    coc_inf = float(np.float32(a * f) / np.float32(denom))
    return cfg.dof_max_coc * torch.clamp(coc_m / coc_inf, 0.0, 1.0)


def _dof_p(planes, view_depth: torch.Tensor, cfg: PostConfig):
    """CoC-blended 3-level blur pyramid (gather-free DoF)."""
    h, w = planes[0].shape
    coc = circle_of_confusion(view_depth[:h, :w], cfg)
    coc = torch.maximum(coc, _blur3_p(_blur3_p(coc)))
    t = torch.clamp(coc / max(cfg.dof_max_coc, 1e-4), 0.0, 1.0) * 3.0
    w1 = torch.clamp(t, 0.0, 1.0)
    w2 = torch.clamp(t - 1.0, 0.0, 1.0)
    w3 = torch.clamp(t - 2.0, 0.0, 1.0)
    outs = []
    for p in planes:
        l1 = _blur3_p(_down2_p(p))
        l2 = _blur3_p(_down2_p(l1))
        l3 = _blur3_p(_down2_p(l2))
        u1 = _up2_p(l1, h, w)
        u2 = _up2_p(_up2_p(l2, l1.shape[0], l1.shape[1]), h, w)
        u3 = _up2_p(_up2_p(_up2_p(
            l3, l2.shape[0], l2.shape[1]), l1.shape[0], l1.shape[1]), h, w)
        out = p + w1 * (u1 - p)
        out = out + w2 * (u2 - out)
        outs.append(out + w3 * (u3 - out))
    return outs


def depth_of_field(rgb: torch.Tensor, view_depth: torch.Tensor,
                   cfg: PostConfig) -> torch.Tensor:
    return _merge(_dof_p(_split(rgb), view_depth, cfg))


def camera_velocity(view_depth: torch.Tensor, fov_y, aspect,
                    view_to_world: torch.Tensor,
                    prev_world_to_view: torch.Tensor) -> torch.Tensor:
    """Per-pixel screen-space camera velocity in PIXELS [H, W, 2] (x, y):
    the view-space position from depth, through prev_world_to_view @
    view_to_world, reprojected and differenced."""
    h, w = view_depth.shape
    dev = view_depth.device
    # the renderer keeps the previous view matrix on the CPU: upload it
    # pinned, as a pageable copy would wait for the queued frame
    on_dev = lambda t: upload(t, dev) if t.device.type == "cpu" \
        else t.to(dev, f32)
    a = on_dev(prev_world_to_view)
    b = on_dev(view_to_world)
    # the 4x4 product in float32, k in order (the JAX package's HIGHEST)
    m = a[:, 0:1] * b[0:1, :]
    for k in range(1, 4):
        m = m + a[:, k:k + 1] * b[k:k + 1, :]
    tan_y = torch.tan(torch.as_tensor(fov_y, dtype=f32, device=dev) / 2.0)
    aspect = torch.as_tensor(aspect, dtype=f32, device=dev)
    xs = _coords(w, dev) * 2.0 - 1.0
    ys = _coords(h, dev) * 2.0 - 1.0
    vx = xs[None, :] * (tan_y * aspect) * view_depth
    vy = ys[:, None] * tan_y * view_depth
    vz = view_depth
    px = m[0, 0] * vx + m[0, 1] * vy + m[0, 2] * vz + m[0, 3]
    py = m[1, 0] * vx + m[1, 1] * vy + m[1, 2] * vz + m[1, 3]
    pz = torch.clamp(m[2, 0] * vx + m[2, 1] * vy + m[2, 2] * vz + m[2, 3],
                     min=1e-4)
    su = px / (pz * tan_y * aspect)
    sv = py / (pz * tan_y)
    return torch.stack([(su - xs[None, :]) * (w / 2.0),
                        (sv - ys[:, None]) * (h / 2.0)], dim=-1)


def _motion_blur_p(planes, velocity: torch.Tensor, strength: float):
    """Direction-quantized camera motion blur on a half-res image."""
    h, w = planes[0].shape
    vx = _down2_p(velocity[..., 0])
    vy = _down2_p(velocity[..., 1])
    mag = torch.sqrt(vx * vx + vy * vy)
    ang = torch.atan2(vy, torch.where(torch.abs(vx) < 1e-8,
                                      torch.full_like(vx, 1e-8), vx))
    bin_f = _mod(ang, math.pi) / (math.pi / 4.0)
    s_half = strength * torch.clamp(mag / 4.0, 0.0, 1.0)
    vel2 = velocity * velocity
    s_full = strength * torch.clamp(
        torch.sqrt(vel2[..., 0] + vel2[..., 1]) / 4.0, 0.0, 1.0)
    dirs = [(0, 1), (1, 1), (1, 0), (1, -1)]
    sels = []
    for i in range(4):
        e = torch.abs(bin_f - i)
        sels.append((torch.minimum(e, 4.0 - e) <= 0.5).to(f32))
    outs = []
    for p in planes:
        half = _down2_p(p)
        blurred = torch.zeros_like(half)
        for (dy, dx), sel in zip(dirs, sels):
            b = (half
                 + _shift2_p(half, dy, dx) + _shift2_p(half, -dy, -dx)
                 + _shift2_p(half, 2 * dy, 2 * dx)
                 + _shift2_p(half, -2 * dy, -2 * dx)) / 5.0
            blurred = blurred + sel * b
        out_half = half + s_half * (blurred - half)
        outs.append(p + s_full * (_up2_p(out_half, h, w) - p))
    return outs


def motion_blur(rgb: torch.Tensor, velocity: torch.Tensor, strength: float
                ) -> torch.Tensor:
    return _merge(_motion_blur_p(_split(rgb), velocity, strength))


# --------------------------------------------------------------------------- #
# Screen-space reflections (the march is K13)
# --------------------------------------------------------------------------- #

def _ssr_offsets(cfg: PostConfig) -> tuple:
    """Static per-bin (t_prev, t, oy, ox) march taps: log-spaced radii per
    quantized direction, deduplicated per rounded pixel offset. One tuple
    per (ssr_dirs, ssr_steps, ssr_max_px), built once: the march's wrappers
    key their device tables by it (ops/ssr.tap_table)."""
    return _ssr_offsets_of(max(int(cfg.ssr_dirs), 1),
                           max(int(cfg.ssr_steps), 1), float(cfg.ssr_max_px))


@functools.lru_cache(maxsize=8)
def _ssr_offsets_of(nb: int, ks: int, max_px: float) -> tuple:
    radii = [2.0 * (max_px / 2.0) ** (k / max(ks - 1, 1)) for k in range(ks)]
    bins = []
    for b in range(nb):
        theta = 2.0 * math.pi * b / nb
        dirx, diry = math.cos(theta), math.sin(theta)
        taps = []
        seen = set()
        t_prev = 0.0
        for t in radii:
            oy, ox = int(round(t * diry)), int(round(t * dirx))
            if (oy, ox) in seen or (oy == 0 and ox == 0):
                t_prev = t
                continue
            seen.add((oy, ox))
            taps.append((t_prev, t, oy, ox))
            t_prev = t
        bins.append(tuple(taps))
    return tuple(bins)


def _ssr_p(planes, view_depth: torch.Tensor, cfg: PostConfig):
    """Screen-space reflections with a direction-quantized march: the
    geometry (implicit normals, reflection vector, its screen direction
    bin and 1/z gradient) in plain torch, the march on K13
    (ops/ssr.ssr_march; under grad ops/ssr.SsrMarchFn, K15 its backward),
    the Fresnel x fade x intensity strength and the
    upsample in plain torch. Returns (refl_r, refl_g, refl_b, strength) at
    full res; the caller blends out = lerp(p, refl, strength)."""
    h, w = planes[0].shape
    ds = max(int(cfg.ssr_downsample), 1)
    n2 = max(int(round(math.log2(ds))), 0)
    dq = view_depth[:h, :w]
    cq = list(planes)
    for _ in range(n2):
        dq = _down2_p(dq)
        cq = [_down2_p(p) for p in cq]
    hq, wq = dq.shape
    dev = dq.device
    tan_y = math.tan(math.radians(cfg.ssr_fov_y_deg) / 2.0)
    asp = w / h

    xs = _coords(wq, dev) * 2.0 - 1.0
    ys = _coords(hq, dev) * 2.0 - 1.0
    gx = xs[None, :] * (tan_y * asp)
    gy = ys[:, None] * tan_y
    px_, py_, pz_ = gx * dq, gy * dq, dq

    def cdx(p):
        return (_shift2_p(p, 0, 1) - _shift2_p(p, 0, -1)) * 0.5

    def cdy(p):
        return (_shift2_p(p, 1, 0) - _shift2_p(p, -1, 0)) * 0.5

    ax_, ay_, az_ = cdx(px_), cdx(py_), cdx(pz_)
    bx_, by_, bz_ = cdy(px_), cdy(py_), cdy(pz_)
    nx = ay_ * bz_ - az_ * by_
    ny = az_ * bx_ - ax_ * bz_
    nz = ax_ * by_ - ay_ * bx_
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-12)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    flip = torch.where(nx * px_ + ny * py_ + nz * pz_ > 0.0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip

    ilen = torch.rsqrt(px_ * px_ + py_ * py_ + pz_ * pz_ + 1e-12)
    vx, vy, vz = px_ * ilen, py_ * ilen, pz_ * ilen
    vdn = vx * nx + vy * ny + vz * nz
    rx = vx - 2.0 * vdn * nx
    ry = vy - 2.0 * vdn * ny
    rz = vz - 2.0 * vdn * nz

    near = 0.05
    step = 0.25 * dq
    lim = torch.where(rz < -1e-6, (pz_ - near) / (-rz + 1e-9),
                      torch.full_like(rz, 1e9))
    step = torch.clamp(torch.minimum(step, 0.9 * lim), min=1e-3)
    qx, qy, qz = px_ + step * rx, py_ + step * ry, pz_ + step * rz
    qz = torch.clamp(qz, min=near)
    du = (qx / (qz * tan_y * asp) - xs[None, :]) * (wq / 2.0)
    dv = (qy / (qz * tan_y) - ys[:, None]) * (hq / 2.0)
    mag = torch.sqrt(du * du + dv * dv)
    valid = (mag > 1e-3).to(f32)
    g = (1.0 / qz - 1.0 / pz_) / torch.clamp(mag, min=1e-3)

    nb = max(int(cfg.ssr_dirs), 1)
    ang = torch.atan2(dv, torch.where(torch.abs(du) < 1e-8,
                                      torch.full_like(du, 1e-8), du))
    bin_idx = _mod(torch.round(ang / (2.0 * math.pi / nb)), float(nb))
    max_px = float(cfg.ssr_max_px)
    march = (dq, cq, 1.0 / pz_, g, bin_idx, valid, _ssr_offsets(cfg),
             cfg.ssr_thickness, max_px)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dq, *cq)):
        # K13 forward and its adjoint K15 backward (the colour planes'
        # gradient; the rest reach the march only through comparisons)
        rr_, rg_, rb_, hitw, hitt = ssr_ops.ssr_march_differentiable(*march)
    else:
        rr_, rg_, rb_, hitw, hitt = ssr_ops.ssr_march(*march)

    # strength: Schlick fresnel (f0 = 0.25) x distance fade x hit mask
    cosv = torch.clamp(-vdn, 0.0, 1.0)
    fres = 0.25 + 0.75 * _ipow(1.0 - cosv, 5)
    fade = torch.clamp(1.0 - cfg.ssr_distance_fade * hitt, 0.0, 1.0)
    strength = cfg.ssr_intensity * fres * fade * hitw

    outs = []
    for p in (rr_, rg_, rb_, strength):
        for i in range(n2):
            # the last step edge-pads to the exact full size (odd dims
            # floor through _down2_p, so doubling alone can land short)
            th = h if i == n2 - 1 else min(p.shape[0] * 2, h)
            tw = w if i == n2 - 1 else min(p.shape[1] * 2, w)
            p = _up2_p(p, th, tw)
        outs.append(_blur3_p(p))
    return outs


def screen_space_reflections(rgb: torch.Tensor, view_depth: torch.Tensor,
                             cfg: PostConfig) -> torch.Tensor:
    planes = _split(rgb)
    rr, rg, rb, k = _ssr_p(planes, view_depth, cfg)
    return _merge([p + k * (r - p) for p, r in zip(planes, (rr, rg, rb))])


# --------------------------------------------------------------------------- #
# SMAA
# --------------------------------------------------------------------------- #

def _shiftz_ax(p: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Shift by s along axis with ZERO fill (out[i] = p[i - s])."""
    if s == 0:
        return p
    n = p.shape[axis]
    lo, hi = (s, 0) if s > 0 else (0, -s)
    pad = (0, 0, lo, hi) if axis == 0 else (lo, hi)
    q = F.pad(p, pad)
    start = 0 if s > 0 else -s
    return q.narrow(axis, start, n)


def _runlen_capped(m: torch.Tensor, axis: int, max_d: int,
                   reverse: bool = False) -> torch.Tensor:
    """Inclusive trailing run length of nonzero m along axis, capped at
    max_d, in log2(max_d) doubling steps."""
    d = -1 if reverse else 1
    r = m
    s = 1
    while s < max_d:
        r = r + (r == s).to(r.dtype) * _shiftz_ax(r, axis, d * s)
        s *= 2
    return torch.clamp(r, max=float(max_d))


def _propagate_start(v0: torch.Tensor, m: torch.Tensor, axis: int,
                     max_d: int, reverse: bool = False) -> torch.Tensor:
    """Copy-from-run-start within each run of nonzero m (segmented scan
    unrolled by doubling)."""
    d = -1 if reverse else 1
    f = m * _shiftz_ax(m, axis, d)
    v = v0
    s = 1
    while s < max_d:
        vs = _shiftz_ax(v, axis, d * s)
        fs = _shiftz_ax(f, axis, d * s)
        v = f * vs + (1.0 - f) * v
        f = f * fs
        s *= 2
    return v


def _smaa_axis_weights(e_run, e_cross_a, e_cross_b, axis: int, max_d: int):
    """Blend weights (w_pos, w_neg) for one SMAA line orientation."""
    m = e_run
    d_fwd = _runlen_capped(m, axis, max_d) - 1.0
    d_bwd = _runlen_capped(m, axis, max_d, reverse=True) - 1.0
    cdir = torch.clamp(e_cross_a - e_cross_b, -1.0, 1.0)
    o_l = _propagate_start(cdir * m, m, axis, max_d)
    o_r = _propagate_start(cdir * m, m, axis, max_d, reverse=True)
    dtot = d_fwd + d_bwd + 1.0
    p = (d_fwd + 0.5) / (dtot + 1e-6)
    off = 0.5 * (o_l + (o_r - o_l) * p) * m
    return torch.clamp(off, min=0.0), torch.clamp(-off, min=0.0)


def _smaa_p(planes, cfg: PostConfig):
    """Subpixel morphological AA: luma edges, capped run lengths, the
    trapezoid area, a 4-neighbour blend (no diagonal patterns, no corner
    rounding, as in the JAX package)."""
    t = cfg.smaa_threshold
    luma = _luma_p(planes)
    e_left = (torch.abs(luma - _shift2_p(luma, 0, -1)) > t).to(f32)
    e_top = (torch.abs(luma - _shift2_p(luma, -1, 0)) > t).to(f32)
    w_up, w_dn_src = _smaa_axis_weights(
        e_top, _shift2_p(e_left, -1, 0), e_left, axis=1,
        max_d=cfg.smaa_max_search)
    w_lf, w_rt_src = _smaa_axis_weights(
        e_left, _shift2_p(e_top, 0, -1), e_top, axis=0,
        max_d=cfg.smaa_max_search)
    w_dn = _shift2_p(w_dn_src, 1, 0)
    w_rt = _shift2_p(w_rt_src, 0, 1)
    total = w_up + w_dn + w_lf + w_rt
    scale = torch.clamp(1.0 / torch.clamp(total, min=1e-6), max=1.0)
    w_up, w_dn, w_lf, w_rt = (w * scale for w in (w_up, w_dn, w_lf, w_rt))
    keep = 1.0 - torch.clamp(total, max=1.0)
    outs = []
    for p in planes:
        outs.append(keep * p
                    + w_up * _shift2_p(p, -1, 0) + w_dn * _shift2_p(p, 1, 0)
                    + w_lf * _shift2_p(p, 0, -1) + w_rt * _shift2_p(p, 0, 1))
    return outs


def smaa(rgb: torch.Tensor, cfg: PostConfig) -> torch.Tensor:
    return _merge(_smaa_p(_split(rgb), cfg))


def _luts_p(planes, luts):
    """Per-channel 1D LUTs as exact piecewise-linear tent sums."""
    outs = []
    for c, p in enumerate(planes):
        lut = [float(v) for v in luts[c]]
        k = len(lut)
        x = torch.clamp(p, 0.0, 1.0) * (k - 1)
        acc = torch.zeros_like(x)
        for i in range(k):
            acc = acc + torch.clamp(1.0 - torch.abs(x - i), min=0.0) * lut[i]
        outs.append(acc)
    return outs


def apply_channel_luts(rgb: torch.Tensor, luts) -> torch.Tensor:
    return _merge(_luts_p(_split(rgb), luts))


# --------------------------------------------------------------------------- #
# Auto exposure
# --------------------------------------------------------------------------- #

def log_luma_histogram(planes, bins: int = 64, ev_min: float = -9.0,
                       ev_max: float = 9.0, downsample: int = 4
                       ) -> torch.Tensor:
    """Normalized log2-luminance histogram [bins] of the box-downsampled
    luma: every pixel counts 1 in the bin its log-luma floors to (one
    compare against all bins, then a count per bin times 1/N, as jnp.mean
    computes it)."""
    luma = _luma_p(planes)
    for _ in range(max(downsample, 1).bit_length() - 1):
        luma = _down2_p(luma)
    ev = torch.log2(torch.clamp(luma, min=1e-8))
    x = torch.clamp((ev - ev_min) / (ev_max - ev_min), 0.0, 1.0) * (bins - 1)
    idx = torch.floor(x).reshape(1, -1)
    ids = torch.arange(bins, dtype=f32, device=idx.device)[:, None]
    return (idx == ids).to(f32).sum(dim=1) * (1.0 / idx.shape[1])


def filtered_average_luminance(hist: torch.Tensor, lo: float, hi: float,
                               ev_min: float = -9.0, ev_max: float = 9.0
                               ) -> torch.Tensor:
    """Percentile-filtered mean luminance over the histogram."""
    bins = hist.shape[0]
    cdf = torch.cumsum(hist, dim=0)
    cdf_prev = torch.cat([torch.zeros((1,), dtype=hist.dtype,
                                      device=hist.device), cdf[:-1]])
    mass = torch.clamp(torch.clamp(cdf, max=hi) - torch.clamp(cdf_prev,
                                                              min=lo),
                       min=0.0)
    ev = ev_min + (torch.arange(bins, dtype=f32, device=hist.device) + 0.5) \
        * ((ev_max - ev_min) / bins)
    mean_ev = torch.sum(mass * ev) / torch.clamp(torch.sum(mass), min=1e-8)
    return torch.exp2(mean_ev)


def adapt_exposure(prev_luma: torch.Tensor, target_luma: torch.Tensor,
                   dt: float, speed_up: float, speed_down: float
                   ) -> torch.Tensor:
    """Progressive eye adaptation: exponential approach with separate
    dark->light / light->dark speeds."""
    speed = torch.where(target_luma > prev_luma,
                        torch.full_like(target_luma, speed_up),
                        torch.full_like(target_luma, speed_down))
    t = 1.0 - torch.exp2(-dt * speed)
    return prev_luma + (target_luma - prev_luma) * t


def auto_exposure_step(planes, prev_luma, cfg: PostConfig,
                       dt: float = 1 / 60) -> tuple:
    """One auto-exposure update: (exposure_scale, new_adapted_luma), both
    0-d tensors on the planes' device. Pass exposure_scale to apply_post and
    carry new_adapted_luma to the next frame (seed with 1.0); dt=None snaps
    to the target."""
    hist = log_luma_histogram(planes, ev_min=cfg.ae_min_ev,
                              ev_max=cfg.ae_max_ev)
    avg = filtered_average_luminance(hist, cfg.ae_filtering[0],
                                     cfg.ae_filtering[1], cfg.ae_min_ev,
                                     cfg.ae_max_ev)
    avg = torch.clamp(avg, float(np.exp2(np.float32(cfg.ae_min_ev))),
                      float(np.exp2(np.float32(cfg.ae_max_ev))))
    if dt is None:
        new_luma = avg
    else:
        prev = torch.as_tensor(prev_luma, dtype=f32, device=avg.device)
        new_luma = adapt_exposure(prev, avg, dt, cfg.ae_speed_up,
                                  cfg.ae_speed_down)
    return cfg.ae_key / torch.clamp(new_luma, min=1e-6), new_luma


# --------------------------------------------------------------------------- #
# FXAA
# --------------------------------------------------------------------------- #

def _fxaa_p(planes, abs_threshold: float, rel_threshold: float):
    """Console FXAA with the edge direction quantized to 4 axes."""
    l = _luma_p(planes)
    sh = _shift2_p
    l_n, l_s = sh(l, -1, 0), sh(l, 1, 0)
    l_w, l_e = sh(l, 0, -1), sh(l, 0, 1)
    l_nw, l_ne = sh(l, -1, -1), sh(l, -1, 1)
    l_sw, l_se = sh(l, 1, -1), sh(l, 1, 1)
    l_min = torch.minimum(l, torch.minimum(torch.minimum(l_n, l_s),
                                           torch.minimum(l_w, l_e)))
    l_max = torch.maximum(l, torch.maximum(torch.maximum(l_n, l_s),
                                           torch.maximum(l_w, l_e)))
    contrast = l_max - l_min
    active = (contrast >= torch.clamp(rel_threshold * l_max,
                                      min=abs_threshold)).to(f32)
    dir_x = -((l_nw + l_ne) - (l_sw + l_se))
    dir_y = (l_nw + l_sw) - (l_ne + l_se)
    adx, ady = torch.abs(dir_x), torch.abs(dir_y)
    diag = (torch.minimum(adx, ady) > 0.414 * torch.maximum(adx, ady)
            ).to(f32)
    horiz = (adx >= ady).to(f32)
    d1 = (torch.sign(dir_x) * torch.sign(dir_y) >= 0).to(f32)
    l_avg = (l_n + l_s + l_w + l_e) * 0.25
    sub = torch.clamp(torch.abs(l_avg - l) / torch.clamp(contrast, min=1e-6),
                      0.0, 1.0)
    blend = sub * sub * 0.75 * active
    outs = []
    for p in planes:
        ax_h = (sh(p, 0, -1) + sh(p, 0, 1)) * 0.5
        ax_v = (sh(p, -1, 0) + sh(p, 1, 0)) * 0.5
        ax_d1 = (sh(p, -1, -1) + sh(p, 1, 1)) * 0.5
        ax_d2 = (sh(p, -1, 1) + sh(p, 1, -1)) * 0.5
        straight = horiz * ax_h + (1.0 - horiz) * ax_v
        diag_b = d1 * ax_d1 + (1.0 - d1) * ax_d2
        tgt = diag * diag_b + (1.0 - diag) * straight
        outs.append(p + blend * (tgt - p))
    return outs


def fxaa(rgb: torch.Tensor, abs_threshold: float = 0.0312,
         rel_threshold: float = 0.063) -> torch.Tensor:
    return _merge(_fxaa_p(_split(rgb), abs_threshold, rel_threshold))


# --------------------------------------------------------------------------- #
# Windowed 1D shift-warp (TAA, lens distortion)
# --------------------------------------------------------------------------- #

def _windowed_warp_axis(p: torch.Tensor, offset: torch.Tensor, k: int,
                        axis: int) -> torch.Tensor:
    """p resampled at position + offset along `axis` by tent weights over
    2k+1 static shifts; offsets clip to +-k."""
    off = torch.clamp(offset, -k, k)
    out = torch.zeros_like(p)
    for j in range(-k, k + 1):
        wt = torch.clamp(1.0 - torch.abs(off - j), min=0.0)
        sp = _shift2_p(p, j, 0) if axis == 0 else _shift2_p(p, 0, j)
        out = out + wt * sp
    return out


# --------------------------------------------------------------------------- #
# TAA
# --------------------------------------------------------------------------- #

def taa_step(planes_cur, planes_hist, velocity: torch.Tensor,
             cfg: PostConfig):
    """One TAA frame: history reprojected along -velocity (windowed warp),
    clamped to the current 3x3 neighbourhood, blended, sharpened. Returns
    (display_planes, new_history_planes); frame 0 passes planes_hist=None."""
    if planes_hist is None:
        return list(planes_cur), [p for p in planes_cur]
    k = int(cfg.taa_window)
    vx, vy = velocity[..., 0], velocity[..., 1]
    speed = torch.sqrt(vx * vx + vy * vy)
    blend = cfg.taa_stationary_blend + (
        cfg.taa_motion_blend - cfg.taa_stationary_blend
    ) * torch.clamp(speed / 4.0, 0.0, 1.0)
    outs, hists = [], []
    for c, p in enumerate(planes_cur):
        h = _windowed_warp_axis(planes_hist[c], -vx, k, axis=1)
        h = _windowed_warp_axis(h, -vy, k, axis=0)
        n_min, n_max = p, p
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                s = _shift2_p(p, dy, dx)
                n_min = torch.minimum(n_min, s)
                n_max = torch.maximum(n_max, s)
        h = torch.minimum(torch.maximum(h, n_min), n_max)
        out = p + blend * (h - p)
        hists.append(out)
        if cfg.taa_sharpness > 0.0:
            out = out + cfg.taa_sharpness * (out - _blur3_p(out))
        outs.append(out)
    return outs, hists


def temporal_antialiasing(rgb_cur: torch.Tensor, rgb_hist,
                          velocity: torch.Tensor, cfg: PostConfig):
    hist = None if rgb_hist is None else _split(rgb_hist)
    outs, hists = taa_step(_split(rgb_cur), hist, velocity, cfg)
    return _merge(outs), _merge(hists)


# --------------------------------------------------------------------------- #
# Lens distortion
# --------------------------------------------------------------------------- #

def lens_distortion_offsets(h: int, w: int, cfg: PostConfig, device="cpu"):
    """(dy, dx) source-sample displacement in PIXELS per output pixel for
    the engine's model (LensDistortion.cs:67-75)."""
    inten = cfg.lens_distortion
    amount = 1.6 * max(abs(inten), 1.0)
    theta = torch.tensor(min(160.0, amount), dtype=f32, device=device) \
        * (np.pi / 180)
    sigma = 2.0 * torch.tan(theta * 0.5)
    cx, cy = cfg.ld_center
    ys = _coords(h, device)
    xs = _coords(w, device)
    u = (xs[None, :] - 0.5) / cfg.ld_scale + 0.5
    v = (ys[:, None] - 0.5) / cfg.ld_scale + 0.5
    ru_x = max(cfg.ld_intensity_x, 1e-4) * (u - 0.5 - cx * 0.5)
    ru_y = max(cfg.ld_intensity_y, 1e-4) * (v - 0.5 - cy * 0.5)
    r = torch.sqrt(ru_x * ru_x + ru_y * ru_y)
    r_safe = torch.clamp(r, min=1e-6)
    if inten >= 0.0:
        scale = torch.tan(torch.clamp(r_safe * theta, 0.0, 1.55)) \
            / (r_safe * sigma)
    else:
        scale = torch.atan(r_safe * sigma) / (r_safe * theta)
    src_u = u + ru_x * (scale - 1.0)
    src_v = v + ru_y * (scale - 1.0)
    dx = (src_u - xs[None, :]) * w
    dy = (src_v - ys[:, None]) * h
    return dy, dx


def _lens_distort_p(planes, cfg: PostConfig):
    """Separable two-pass resample of the radial remap: x at dx(x, y), then
    y at dy(x, y), each a windowed shift-warp."""
    h, w = planes[0].shape
    dy, dx = lens_distortion_offsets(h, w, cfg, planes[0].device)
    k = int(cfg.ld_window)
    outs = []
    for p in planes:
        q = _windowed_warp_axis(p, dx, k, axis=1)
        outs.append(_windowed_warp_axis(q, dy, k, axis=0))
    return outs


def lens_distortion(rgb: torch.Tensor, cfg: PostConfig) -> torch.Tensor:
    return _merge(_lens_distort_p(_split(rgb), cfg))


# --------------------------------------------------------------------------- #
# Ambient occlusion
# --------------------------------------------------------------------------- #

def ambient_occlusion(view_depth: torch.Tensor, intensity: float,
                      radius_px: int = 8) -> torch.Tensor:
    """AO multiplier [H, W] in (0, 1] from two rings of 8 static-shift
    relative-depth taps."""
    d = view_depth
    occ = torch.zeros_like(d)
    n = 0
    for r in (max(radius_px // 2, 1), max(radius_px, 1)):
        for dy, dx in ((0, r), (0, -r), (r, 0), (-r, 0),
                       (r, r), (r, -r), (-r, r), (-r, -r)):
            dt = d - _shift2_p(d, dy, dx)
            s = torch.clamp(dt / (0.015 * d + 1e-3), 0.0, 1.0)
            fade = torch.clamp(1.0 - dt / (0.10 * d + 1e-3), 0.0, 1.0)
            occ = occ + s * fade
            n += 1
    return 1.0 - float(np.clip(np.float32(intensity), 0.0, 4.0)) \
        * torch.clamp(occ / n, 0.0, 1.0)


def multi_scale_ao(view_depth: torch.Tensor, intensity: float,
                   levels: int = 4, radius_px: int = 4) -> torch.Tensor:
    """Multi-scale AO multiplier [H, W]: the ring taps on each level of a
    depth pyramid, merged as 1 - prod(1 - occ_l), then one 3-tap blur."""
    h, w = view_depth.shape
    d = view_depth
    un = torch.ones((h, w), dtype=view_depth.dtype, device=d.device)
    for lv in range(max(levels, 1)):
        occ = 1.0 - ambient_occlusion(d, 1.0, radius_px)
        for i in range(lv):
            th = h if i == lv - 1 else min(occ.shape[0] * 2, h)
            tw = w if i == lv - 1 else min(occ.shape[1] * 2, w)
            occ = _up2_p(occ, th, tw)
        un = un * (1.0 - occ)
        d = _down2_p(d)
    total = _blur3_p(1.0 - un)
    return 1.0 - float(np.clip(np.float32(intensity), 0.0, 4.0)) \
        * torch.clamp(total, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# The chain
# --------------------------------------------------------------------------- #

def apply_post(image_rgba: torch.Tensor, cfg: PostConfig,
               view_depth: torch.Tensor = None,
               velocity: torch.Tensor = None,
               exposure_scale=None, dither_frame=0) -> torch.Tensor:
    """HDR composite [H, W, 4] -> display-ready [H, W, 3] in [0, 1].

    view_depth [H, W] enables SSR, DoF and AO; velocity [H, W, 2] in pixels
    (camera_velocity) enables motion blur; exposure_scale (from
    auto_exposure_step) multiplies cfg.exposure; dither_frame scrolls the
    final dither pattern."""
    return _merge(apply_post_planes([image_rgba[..., c] for c in range(3)],
                                    cfg, view_depth, velocity,
                                    exposure_scale, dither_frame))


def apply_post_planes(planes, cfg: PostConfig,
                      view_depth: torch.Tensor = None,
                      velocity: torch.Tensor = None,
                      exposure_scale=None, dither_frame=0):
    """Planar core of apply_post: 3 HDR [H, W] planes in, 3 display planes
    out."""
    exposure = cfg.exposure if exposure_scale is None \
        else cfg.exposure * exposure_scale
    planes = [p * exposure for p in planes[:3]]
    h, w = planes[0].shape
    dev = planes[0].device
    if cfg.lens_distortion != 0.0:
        planes = _lens_distort_p(planes, cfg)
    if cfg.ssr_intensity > 0.0 and view_depth is not None:
        rr, rg, rb, k = _ssr_p(planes, view_depth, cfg)
        planes = [p + k * (r - p) for p, r in zip(planes, (rr, rg, rb))]
    if cfg.dof_focus_distance > 0.0 and view_depth is not None:
        planes = _dof_p(planes, view_depth, cfg)
    if cfg.motion_blur > 0.0 and velocity is not None:
        planes = _motion_blur_p(planes, velocity, cfg.motion_blur)
    if cfg.chromatic_aberration > 0.0:
        planes = _ca_p(planes, cfg.chromatic_aberration)
    if cfg.bloom_strength > 0.0:
        bl = _bloom_p(planes, cfg.bloom_threshold, cfg.bloom_levels)
        planes = [p + cfg.bloom_strength * b for p, b in zip(planes, bl)]
    if cfg.vignette > 0.0:
        yy = _coords(h, dev) - 0.5
        xx = _coords(w, dev) - 0.5
        r2 = (xx[None, :] * xx[None, :] + yy[:, None] * yy[:, None]) * 2.0
        vig = 1.0 - cfg.vignette * r2
        planes = [p * vig for p in planes]
    if cfg.ao_intensity > 0.0 and view_depth is not None:
        if cfg.ao_multiscale:
            ao = multi_scale_ao(view_depth[:h, :w], cfg.ao_intensity,
                                cfg.ao_levels, cfg.ao_radius_px)
        else:
            ao = ambient_occlusion(view_depth[:h, :w], cfg.ao_intensity,
                                   cfg.ao_radius_px)
        planes = [p * ao for p in planes]
    if cfg.tonemap == "aces":
        planes = [aces_tonemap(p) for p in planes]
    if (cfg.grade_lift != (0.0, 0.0, 0.0) or cfg.grade_gamma != (1.0, 1.0, 1.0)
            or cfg.grade_gain != (1.0, 1.0, 1.0) or cfg.saturation != 1.0
            or cfg.contrast != 1.0):
        planes = _grade_p(planes, cfg)
    if cfg.grade_luts is not None:
        planes = _luts_p(planes, cfg.grade_luts)
    if cfg.grain > 0.0:
        n = _grain_noise(h, w, cfg.grain_seed, dev)
        mask = 1.0 - torch.clamp(_luma_p(planes), 0.0, 1.0) * 0.5
        gn = cfg.grain * n * mask
        planes = [p + gn for p in planes]
    planes = [torch.clamp(p, 0.0, 1.0) ** (1.0 / cfg.gamma) for p in planes]
    if cfg.smaa:
        planes = _smaa_p(planes, cfg)
    if cfg.fxaa:
        planes = _fxaa_p(planes, cfg.fxaa_abs_threshold,
                         cfg.fxaa_rel_threshold)
    if cfg.dithering:
        pix = torch.stack(torch.meshgrid(
            torch.arange(w, dtype=f32, device=dev),
            torch.arange(h, dtype=f32, device=dev), indexing="xy"), dim=-1)
        ign = interleaved_gradient_noise(pix, dither_frame)
        planes = [torch.clamp(p + (ign - 0.5) * (1.0 / 255.0), 0.0, 1.0)
                  for p in planes]
    return planes

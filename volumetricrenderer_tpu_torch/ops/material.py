"""Media evaluation at world positions: sigma_s, sigma_a, phase g and the
procedural fBm factor.

Plain-torch twins of `volumetricrenderer_tpu/ops/pallas/material.py`
(`_hash3`, `_grad_dot`, `_fade`, `_perlin_single`, `perlin_planes`,
`phase_g_plane`, `noise_factor_planes`, `material_planes`); the CUDA
counterparts are the functions of the same names in `csrc/common.cuh`.
The Perlin hash is uint32 arithmetic: here on int32 tensors, whose products
and sums wrap to the same 32 bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

ROW = 20  # floats per packed medium row
M32 = 0xFFFFFFFF


def media_foldable(media: Sequence) -> bool:
    """True when every medium can be evaluated without a texture gather.
    Texture media fold into the fused frame only with their factor sampled
    at the radiance bake's low grid outside the kernels
    (ops/visibility.bake_noise_channels; renderer.fuses_frame)."""
    return all(m.noise_tex is None for m in media)


def noise_src(m) -> int:
    """0 = no noise, 1 = procedural fBm, 2 = texture."""
    if m.noise_mode == "procedural":
        return 1
    return 2 if m.noise_tex is not None else 0


def pack_media(media: Sequence, time_x) -> Tuple[torch.Tensor, tuple]:
    """[M, 20] table and the per-medium statics.

    Row: sigma_s(3) sigma_a g tiling(3) offset(3 = scroll*time_x)
         height_falloff height_base box_min(3) box_max(3) softness.
    Static: (noise_src, octaves, period, seed, is_box, additive)."""
    rows = []
    static = []
    tx = float(np.float32(time_x))      # float32 time, as the reference
    for m in media:
        rows.append(torch.cat([
            m.scattering_coef, m.absorption_coef[None], m.phase_g[None],
            m.noise_tiling, m.noise_scroll * tx,
            m.height_falloff[None], m.height_base[None],
            m.box_min, m.box_max, m.box_softness[None]]))
        static.append((noise_src(m), int(m.noise_octaves),
                       int(m.noise_period), int(m.noise_seed),
                       m.volume_type == "box", m.blend_type == "additive"))
    return torch.stack(rows), tuple(static)


def _s32(c: int) -> int:
    """The uint32 constant c as the int32 value with the same bits."""
    c &= M32
    return c - (1 << 32) if c >= 1 << 31 else c


def _hash3(ix, iy, iz, seed: int) -> torch.Tensor:
    """uint32 lattice hash of integer lattice planes -> low 4 bits. int32
    tensors hold the uint32 bits: products and sums wrap modulo 2^32 either
    way, and the two right shifts are made logical by masking off the
    sign's copies."""
    i32 = lambda a: a.to(torch.int32)
    h = i32(ix) * _s32(0x8DA6B343) + i32(iy) * _s32(0xD8163841) \
        + i32(iz) * _s32(0xCB1AB31F) + _s32(int(seed) * 0x9E3779B9)
    h = h ^ ((h >> 13) & 0x7FFFF)
    h = h * _s32(0x85EBCA6B)
    h = h ^ ((h >> 16) & 0xFFFF)
    return h & 15


def _grad_dot(h, dx, dy, dz):
    """Branchless 12-edge gradient dot."""
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _perlin_single(px, py, pz, period: int, seed: int):
    """Periodic Perlin noise at coordinate planes."""
    p0x, p0y, p0z = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - p0x, py - p0y, pz - p0z
    i0x = p0x.to(torch.int32)
    i0y = p0y.to(torch.int32)
    i0z = p0z.to(torch.int32)
    ux, uy, uz = _fade(fx), _fade(fy), _fade(fz)
    if period & (period - 1) == 0:
        wrap = lambda a: a & (period - 1)
    else:
        wrap = lambda a: torch.remainder(a, period)

    def corner(dx, dy, dz):
        h = _hash3(wrap(i0x + dx), wrap(i0y + dy), wrap(i0z + dz), seed)
        return _grad_dot(h, fx - dx, fy - dy, fz - dz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + ux * (n100 - n000)
    nx10 = n010 + ux * (n110 - n010)
    nx01 = n001 + ux * (n101 - n001)
    nx11 = n011 + ux * (n111 - n011)
    nxy0 = nx00 + uy * (nx10 - nx00)
    nxy1 = nx01 + uy * (nx11 - nx01)
    return nxy0 + uz * (nxy1 - nxy0)


def perlin_planes(ux, uy, uz, octaves: int, period: int, seed: int):
    """Tileable fBm Perlin in [0, 1]."""
    total = 0.0
    amp = 1.0
    norm = 0.0
    per = period
    for o in range(octaves):
        fper = float(per)
        total = total + amp * _perlin_single(ux * fper, uy * fper, uz * fper,
                                             per, seed + o)
        norm += amp
        amp *= 0.5
        per *= 2
    return torch.clamp(0.5 + 0.5 * (total / norm) * 1.5, 0.0, 1.0)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _box_mask(q, wx, wy, wz):
    soft = torch.clamp(q(19), min=1e-6)
    lo = torch.minimum(torch.minimum(
        _smoothstep(q(13), q(13) + soft, wx),
        _smoothstep(q(14), q(14) + soft, wy)),
        _smoothstep(q(15), q(15) + soft, wz))
    hi = torch.minimum(torch.minimum(
        _smoothstep(-q(16), -(q(16) - soft), -wx),
        _smoothstep(-q(17), -(q(17) - soft), -wy)),
        _smoothstep(-q(18), -(q(18) - soft), -wz))
    return lo * hi


def phase_g_plane(med, media_static: tuple, wx, wy, wz):
    """Phase g only (no noise or height factor on g)."""
    g = torch.zeros_like(wx)
    for mi, (_src, _oct, _per, _seed, is_box, additive) \
            in enumerate(media_static):
        q = lambda i: med[mi, i]
        mask = _box_mask(q, wx, wy, wz) if is_box else torch.ones_like(wx)
        if additive:
            g = g + q(4) * mask
        else:
            g = g * (1.0 - mask) + q(4) * mask
    return g


def noise_factor_planes(med, media_static: tuple, wx, wy, wz):
    """The procedural fBm factor of each noise-bearing medium, in order.
    A texture medium raises: its factor is a sample of its texture, which
    the table does not hold (ops/visibility.bake_noise_channels)."""
    out = []
    for mi, (src, octaves, period, seed, *_rest) in enumerate(media_static):
        if not src:
            continue
        if src != 1:
            raise NotImplementedError(
                "a texture-noise medium in the fBm bake: its factor comes "
                "from ops/visibility.bake_noise_channels")
        q = lambda i: med[mi, i]
        out.append(perlin_planes(wx * q(5) + q(8), wy * q(6) + q(9),
                                 wz * q(7) + q(10), octaves, period, seed))
    return out


def material_planes(med, media_static: tuple, wx, wy, wz, noise_planes=None):
    """(sigma_s r, g, b, sigma_a, g) at world positions. noise_planes: the
    upsampled low-rate noise factors, one per noise-bearing medium in media
    order (procedural or texture); without them the Perlin is evaluated
    here, which a texture medium cannot be."""
    sr = sg = sb = sa = g = torch.zeros_like(wx)
    noise_i = 0
    for mi, (src, octaves, period, seed, is_box, additive) \
            in enumerate(media_static):
        q = lambda i: med[mi, i]
        factor = torch.ones_like(wx)
        if src:
            if noise_planes is not None:
                factor = factor * noise_planes[noise_i]
                noise_i += 1
            else:
                if src != 1:
                    raise NotImplementedError(
                        "a texture-noise medium without its noise planes: "
                        "its factor is a sample of its texture")
                factor = factor * perlin_planes(
                    wx * q(5) + q(8), wy * q(6) + q(9), wz * q(7) + q(10),
                    octaves, period, seed)
        factor = factor * torch.exp(-torch.clamp(q(11), min=0.0)
                                    * torch.clamp(wy - q(12), min=0.0))
        mask = _box_mask(q, wx, wy, wz) if is_box else torch.ones_like(wx)
        a_r, a_g, a_b = q(0) * factor, q(1) * factor, q(2) * factor
        a_a = q(3) * factor
        if additive:
            sr = sr + a_r * mask
            sg = sg + a_g * mask
            sb = sb + a_b * mask
            sa = sa + a_a * mask
            g = g + q(4) * mask
        else:
            inv = 1.0 - mask
            sr = sr * inv + a_r * mask
            sg = sg * inv + a_g * mask
            sb = sb * inv + a_b * mask
            sa = sa * inv + a_a * mask
            g = g * inv + q(4) * mask
    return sr, sg, sb, sa, g


def pack_heightfield(geom) -> torch.Tensor:
    """[1, 6] row: amp, base, tiling (2), offset (2)."""
    return torch.cat([geom.hf_amp[None], geom.hf_base[None], geom.hf_tiling,
                      geom.hf_offset])[None].to(torch.float32)


def heightfield_static(geom) -> tuple:
    """(octaves, period, seed, steps, far) of the terrain march."""
    return (geom.hf_octaves, geom.hf_period, geom.hf_seed, geom.hf_steps,
            geom.hf_far)


def heightfield_band(hf, hf_static: tuple, wy, ldy, max_t):
    """The march interval (lo, hi) of rays from height wy along unit
    directions of y component ldy: where they cross the terrain's height
    band [base, base + amp], clamped to [1e-4, min(max_t, far)]; empty
    (hi <= lo) where they cannot cross it. Tensors of the broadcast shape
    of wy and ldy."""
    far = hf_static[4]
    amp = hf[0, 0]
    base = hf[0, 1]
    hmax = base + amp
    eps = 1e-4
    shape = torch.broadcast_shapes(wy.shape, torch.as_tensor(ldy).shape)
    wy = wy.expand(shape)
    ldy = torch.as_tensor(ldy, device=wy.device).expand(shape)
    cap = torch.clamp(torch.as_tensor(max_t, dtype=torch.float32,
                                      device=wy.device),
                      max=float(np.float32(far))).expand(shape)
    horiz = ldy.abs() < 1e-7
    safe = torch.where(horiz, torch.full_like(ldy, 1e-7), ldy)
    ta = (hmax - wy) / safe
    tb = (base - wy) / safe
    in_band = (wy >= base) & (wy <= hmax)
    epsv = torch.full_like(wy, eps)
    lo = torch.where(horiz, torch.where(in_band, epsv, cap),
                     torch.minimum(ta, tb))
    hi = torch.where(horiz, torch.where(in_band, cap, torch.zeros_like(wy)),
                     torch.maximum(ta, tb))
    lo = torch.minimum(torch.maximum(lo, epsv), cap)
    hi = torch.minimum(torch.maximum(hi, epsv), cap)
    return lo, hi


def heightfield_below(hf, hf_static: tuple, lo, hi, i: int, wx, wy, wz, ldx,
                      ldy, ldz):
    """bool: is march sample i of `steps`, at the midpoint t = lo + (hi -
    lo) * (i + 0.5) / steps, below the terrain?"""
    octaves, period, seed, steps, _ = hf_static
    t = lo + (hi - lo) * ((i + 0.5) / steps)
    px = wx + t * ldx
    py = wy + t * ldy
    pz = wz + t * ldz
    u = px * hf[0, 2] + hf[0, 4]
    v = pz * hf[0, 3] + hf[0, 5]
    h = hf[0, 1] + hf[0, 0] * perlin_planes(u, v, torch.zeros_like(u),
                                            octaves, period, seed)
    return py < h


def heightfield_occluded(hf, hf_static: tuple, wx, wy, wz, ldx, ldy, ldz,
                         max_t):
    """bool: does the ray (w, unit ld) cross below the terrain at one of
    `steps` midpoint samples of its band (heightfield_band)? hf [1, 6]
    (pack_heightfield), hf_static (octaves, period, seed, steps, far); ld*
    tensors or scalars broadcasting against w*. The march of
    ops/raycast.occluded's terrain arm and of csrc/common.cuh
    `heightfield_occluded`."""
    lo, hi = heightfield_band(hf, hf_static, wy, ldy, max_t)
    occ = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for i in range(hf_static[3]):
        occ |= heightfield_below(hf, hf_static, lo, hi, i, wx, wy, wz, ldx,
                                 ldy, ldz)
    return occ & (hi > lo)

"""The index forms of the fused frame's kernels K1, K2, K3 and K9
(csrc/bake_radiance.cu, csrc/shadow_scatter.cu, csrc/integrate_blend.cu,
csrc/bake_visibility.cu), of the staged frame's K5, K6, K7 and K8
(csrc/shadow_blend.cu, csrc/scatter.cu, csrc/dir_shadow.cu,
csrc/integrate.cu) and of the history and shadow-map frames' K10, K11 and
K12 (csrc/temporal_blend.cu, csrc/windowed_warp.cu, csrc/pcf_shadow.cu):
each kernel refuses only what it indexes, and K2, K3 and K5-K12 take a wide
form (64-bit indices, the slices, rows or (sun, slice) pairs launched in
parts of at most 65535) past their narrow one; K10 and K11 judge each
launch of a channel group. The wrappers'
form mirrors at their edges by arithmetic, the wrappers' arguments on meta
tensors against the entry point each launches (the launch stubbed), and
the parts of a launch-grid axis. Plain Python and torch on the CPU; no
JAX."""

import dataclasses

import pytest
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_ds
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import integrate as t_int
from volumetricrenderer_tpu_torch.ops import pcf_shadow as t_pcf
from volumetricrenderer_tpu_torch.ops import scatter as t_sca
from volumetricrenderer_tpu_torch.ops import shadow_blend as t_sb
from volumetricrenderer_tpu_torch.ops import temporal as t_tmp
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import warp as t_wp

RAD, RAY, BAKED = t_sca.LOCAL_RADIANCE, t_sca.LOCAL_RAY, t_sca.LOCAL_BAKED
EDGE = 2 ** 31 - 1


@pytest.fixture(scope="module")
def tables():
    """A fused frame's tables (the radiance bake at ss = 4, one sun, four
    local lights, the light schedule packed too) at 16x15x16."""
    cfg = dataclasses.replace(vt.FULL_CONFIG, volume_width=16,
                              volume_height=15, volume_depth=16,
                              image_width=128, image_height=120)
    r = vt.VolumetricRenderer(cfg, device="cpu")
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    t = r.frame_tables(r.init_state(1), scene, 0.0)[0]
    return dataclasses.replace(
        t, order=torch.zeros((16, 4), dtype=torch.int32),
        count=torch.zeros(16, dtype=torch.int32))


def _with(t, grid=None, n_dir=None, n_lights=None, meta=False):
    """t at another grid, sun count or light count (meta tables)."""
    kw = {}
    if grid is not None:
        kw["grid_whd"] = grid
    if n_dir is not None:
        kw["n_dir"] = n_dir
    if n_lights is not None:
        kw["lights"] = torch.empty((n_lights, 16), device="meta")
    if meta:
        kw["spar"] = t.spar.to("meta")
    return dataclasses.replace(t, **kw)


def test_past_int32_at_its_edge():
    """2^31 - 1 floats take a 32-bit index, 2^31 do not."""
    assert cuda.past_int32("x", EDGE) is None
    assert cuda.past_int32("x", 2, 2 ** 30 - 1) is None
    assert "2^31" in cuda.past_int32("x", 2 ** 31)
    assert "2^31" in cuda.past_int32("x", 2, 2 ** 30)


# (grid, suns, local source, form): the [max(4, Nd), D, H, W] planes at the
# largest size under 2^31 floats and at 2^31; the radiance's 3 + n_noise
# channels and the baked visibility's NL channels of the low volume at the
# same edge; the schedule [D, NL]; 65535 and 65536 slices
K2_CASES = [
    ((2048, 2047, 128), 1, RAD, "narrow"),     # 4 x 536,608,768 floats
    ((2048, 2048, 128), 1, RAD, "wide"),       # 2^31
    ((1024, 1024, 511), 4, RAY, "narrow"),
    ((1024, 1024, 512), 4, RAY, "wide"),       # 4 suns: 2^31
    ((1024, 1024, 409), 5, BAKED, "narrow"),   # 5 suns: 2,144,337,920
    ((1024, 1024, 410), 5, BAKED, "wide"),
    ((8, 8, 65535), 1, RAD, "narrow"),
    ((8, 8, 65536), 1, RAD, "wide"),
    ((8, 8, 65536), 1, RAY, "wide"),
]


@pytest.mark.parametrize("grid,n_dir,local,form", K2_CASES)
def test_k2_form_at_its_edges(tables, grid, n_dir, local, form):
    """K2's narrow form up to 2^31 - 1 floats of planes and 65535 slices,
    the wide form past them, in every local source."""
    assert t_ff.k2_form(_with(tables, grid, n_dir), local) == form


@pytest.mark.parametrize("n_lights,local,form", [
    # the low grid of 2048 x 2048 x 128 at ss = 4: 512 x 512 x 32 samples
    (511, BAKED, "narrow"), (512, BAKED, "wide"),
    (512, RAD, "narrow"), (512, RAY, "narrow")])
def test_k2_form_reads_only_its_low_channels(tables, n_lights, local, form):
    """Only the baked source reads NL low channels: 512 lights' visibility
    volume of 2^31 floats takes the wide form there alone; the radiance
    reads 3 + n_noise channels and the rays none."""
    t = _with(tables, (2048, 1024, 128), n_lights=n_lights)
    assert t.low_dims == (512, 256, 32)
    assert t_ff.k2_form(t, local) == form


@pytest.mark.parametrize("n_lights,local,form", [
    (32768, RAY, "narrow"), (32769, RAY, "wide"), (32769, RAD, "narrow")])
def test_k2_form_schedule(tables, n_lights, local, form):
    """The per-light loops index the schedule [D, NL] in 32 bits: past
    2^31 - 1 entries (65535 slices x 32769 lights) they take the wide form;
    the radiance source never reads the schedule."""
    t = _with(tables, (16, 15, 65535), n_lights=n_lights)
    assert t_ff.k2_form(t, local) == form


@pytest.mark.parametrize("grid,form", [
    ((1024, 1024, 511), "narrow"), ((1024, 1024, 512), "wide"),   # 2^31
    ((8, 65535, 16), "narrow"), ((8, 65536, 16), "wide"),         # rows
    ((16, 9, 65664), "narrow")])    # slices: a loop of each block
def test_k3_form_at_its_edges(tables, grid, form):
    """K3's narrow form up to 2^31 - 1 floats of [4, D, H, W] planes and
    65535 rows (a row a launch-grid y index), the wide form past them; the
    slice count limits neither."""
    assert t_ff.k3_form(_with(tables, grid)) == form


@pytest.mark.parametrize("grid,n_lights,form", [
    ((2048, 1024, 128), 511, "narrow"),   # [NL, 32, 256, 512] volume
    ((2048, 1024, 128), 512, "wide"),     # 2^31 floats
    ((240, 135, 128), 32896, "narrow"),   # FULL_CONFIG's low grid
    ((240, 135, 128), 32897, "wide"),
    ((8, 8, 65536), 4, "narrow")])        # a 1-D grid: any slice count
def test_k9_form_at_its_edges(tables, grid, n_lights, form):
    """K9's narrow form up to a visibility volume of 2^31 - 1 floats, the
    wide form past it."""
    assert t_vis.k9_form(_with(tables, grid, n_lights=n_lights)) == form


# (grid, suns, form): K5's and K7's histories / volumes [max(4, Nd), D, H,
# W] at the largest size under 2^31 floats and at 2^31, 65535 and 65536
# slices; the low volume is not theirs to index
K5_K7_CASES = [
    ((2048, 2047, 128), 1, "narrow"),   # 4 x 536,608,768 floats
    ((2048, 2048, 128), 1, "wide"),     # 2^31
    ((1024, 1024, 409), 5, "narrow"),   # 5 suns: 2,144,337,920
    ((1024, 1024, 410), 5, "wide"),
    ((240, 135, 128), 517, "narrow"),   # FULL_CONFIG: 517 suns' histories
    ((240, 135, 128), 518, "wide"),     # 2,148,364,800 floats
    ((8, 8, 65535), 1, "narrow"),
    ((8, 8, 65536), 1, "wide"),
]


@pytest.mark.parametrize("kernel", ["K5", "K7"])
@pytest.mark.parametrize("grid,n_dir,form", K5_K7_CASES)
def test_k5_k7_form_at_their_edges(tables, kernel, grid, n_dir, form):
    """K5's and K7's narrow forms up to 2^31 - 1 floats of planes and 65535
    slices, the wide forms past them; a low volume past 2^31 floats (512
    lights' visibility at 2048 x 1024 x 128) does not move them."""
    mirror = t_sb.k5_form if kernel == "K5" else t_ds.k7_form
    assert mirror(_with(tables, grid, n_dir)) == form
    big_low = _with(tables, (2048, 1024, 128), n_lights=512)
    assert mirror(big_low) == "narrow"


# (grid, suns, lights, local source, form): the planes and slices as K5's;
# each local source's low channels (the radiance's 3 + n_noise, the baked
# visibility's NL, the rays' none) and the per-light loops' schedule [D, NL]
K6_CASES = [
    ((2048, 2047, 128), 1, 4, RAD, "narrow"),
    ((2048, 2048, 128), 1, 4, RAD, "wide"),
    ((1024, 1024, 511), 4, 4, RAY, "narrow"),
    ((1024, 1024, 512), 4, 4, RAY, "wide"),
    ((1024, 1024, 409), 5, 4, BAKED, "narrow"),
    ((1024, 1024, 410), 5, 4, BAKED, "wide"),
    ((8, 8, 65535), 1, 4, BAKED, "narrow"),
    ((8, 8, 65536), 1, 4, RAD, "wide"),
    ((8, 8, 65536), 1, 4, RAY, "wide"),
    ((8, 8, 65536), 1, 4, BAKED, "wide"),
    ((2048, 1024, 128), 1, 511, BAKED, "narrow"),   # [511, 32, 256, 512]
    ((2048, 1024, 128), 1, 512, BAKED, "wide"),     # 2^31 floats
    ((2048, 1024, 128), 1, 512, RAD, "narrow"),
    ((2048, 1024, 128), 1, 512, RAY, "narrow"),
    ((240, 135, 128), 1, 32896, BAKED, "narrow"),   # FULL_CONFIG's low grid
    ((240, 135, 128), 1, 32897, BAKED, "wide"),
    ((16, 15, 65535), 1, 32768, RAY, "narrow"),     # the schedule [D, NL]
    ((16, 15, 65535), 1, 32769, RAY, "wide"),
    ((16, 15, 65535), 1, 32769, RAD, "narrow"),
]


@pytest.mark.parametrize("grid,n_dir,n_lights,local,form", K6_CASES)
def test_k6_form_at_its_edges(tables, grid, n_dir, n_lights, local, form):
    """K6's narrow form up to 2^31 - 1 floats of planes, of the low
    channels its local source reads and of the per-light loops' schedule,
    and 65535 slices; the wide form past them, in every local source."""
    t = _with(tables, grid, n_dir, n_lights=n_lights)
    assert t_sca.k6_form(t, local) == form
    if local == RAD or n_lights <= 16:
        assert t_sca.k6_form(t, local) == t_ff.k2_form(t, local)


@pytest.mark.parametrize("grid,form", [
    ((2048, 2047, 128), "narrow"), ((2048, 2048, 128), "wide"),   # 2^31
    ((1024, 1024, 511), "narrow"), ((1024, 1024, 512), "wide"),
    ((8, 8, 65536), "narrow"), ((16, 9, 65664), "narrow"),        # slices
    ((1024, 1024, 520), "wide")])                                 # k8_wide
def test_k8_form_at_its_edges(tables, grid, form):
    """K8's narrow form up to 2^31 - 1 floats of [4, D, H, W] planes, the
    wide form past them; its slices are a loop of each block and its tiles
    a 1-D grid, so the slice count moves neither."""
    assert t_int.k8_form(_with(tables, grid)) == form


def test_check_tile_indices_is_the_slice_tiles_narrow_rule(tables):
    """check_tile_indices, the rule K5 and K7 share, at K5's tile: the
    narrow form where tile_planes_why finds nothing, the wide one past it,
    nothing past 65535 row tiles."""
    for grid, want in (((2048, 2047, 128), "narrow"),
                       ((2048, 2048, 128), "wide"),
                       ((8, 8, 65536), "wide")):
        t = _with(tables, grid)
        assert t_sca.check_tile_indices(t) == want
        assert (t_sca.tile_planes_why(t) is None) == (want == "narrow")
    t = _with(tables, (16, 16 * 65535 + 1, 1))
    with pytest.raises(ValueError, match="K5's wide form.*row tiles"):
        t_sca.check_tile_indices(t, "K5")


def test_k1_bound_of_its_own(tables):
    """K1 writes its low volume at 64-bit offsets on a 1-D grid: planes,
    low volumes and slice counts that the other kernels' narrow forms
    refuse pass its check; the cull table [NL, DL] of 2^31 entries does
    not."""
    for grid, n_lights in (((2048, 2048, 128), 4), ((8, 8, 65536), 4),
                           ((240, 135, 128), 40000)):
        t_ff.check_k1_indices(_with(tables, grid, n_lights=n_lights))
    t = _with(tables, (16, 15, 2 ** 18), n_lights=2 ** 15)
    assert t.low_dims[2] == 2 ** 16
    with pytest.raises(ValueError, match="K1.*2\\^31"):
        t_ff.check_k1_indices(t)


@pytest.mark.parametrize("n", [1, 16, 65535, 65536, 65664, 131070, 131071,
                               200001])
def test_grid_parts_cover_each_index_once(n):
    """The wide forms' parts cover [0, n) exactly once, in order, each at
    most 65535."""
    parts = cuda.grid_parts(n)
    assert all(0 < c <= cuda.MAX_GRID_Z for _, c in parts)
    assert [a for a, _ in parts] == list(range(0, n, cuda.MAX_GRID_Z))
    assert sum(c for _, c in parts) == n
    assert all(a + c == b for (a, c), (b, _) in zip(parts, parts[1:]))


@pytest.mark.parametrize("grid", [(2048, 2048, 128), (8, 8, 65536)])
def test_staged_kernels_still_refuse(tables, grid, monkeypatch):
    """K5, K6 and K7 forced into their narrow forms (32-bit indices: the
    shared predicate check_tile_indices) still refuse these grids, naming
    the kernel, before any launch; their size rules take the wide forms
    there."""
    calls = _stub_launch(monkeypatch)
    w, h, d = grid
    t = _with(tables, grid, meta=True)
    shadow = torch.empty((1, d, h, w), device="meta")
    bake = torch.empty((3 + t.n_noise,) + t.low_dims[::-1], device="meta")
    for kernel, call in (
            ("K5", lambda f: t_sb.dir_shadow_blend(t, shadow, form=f)),
            ("K6", lambda f: t_sca.scatter_local(t, shadow, bake, form=f)),
            ("K7", lambda f: t_ds.dir_shadow(t, form=f))):
        with pytest.raises(ValueError,
                           match=f"{kernel}'s narrow form.*(2\\^31|65535)"):
            call("narrow")
    assert calls == []
    assert t_sb.k5_form(t) == t_sca.k6_form(t, RAD) == t_ds.k7_form(t) \
        == "wide"


class _Library:
    """A stand-in for a kernel's loaded library: any entry point, which
    keeps the argument types cuda._declare gives it."""

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


def _stub_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda, "check_cuda", lambda *t, **kw: None)
    monkeypatch.setattr(cuda, "ptr", lambda t: None)
    monkeypatch.setattr(cuda, "launch", lambda name, *args, entry="":
                        calls.append((name, entry, args)))
    return calls


def _declared(name, entry):
    lib = _Library()
    cuda._declare(lib, name)
    return getattr(lib, entry).argtypes


# (kernel, grid, lights, forced form, the form argument the launch gets)
LAUNCH_CASES = [
    ("K2 radiance", (8, 8, 65536), 4, None, 1),
    ("K2 radiance", (16, 15, 16), 4, None, 0),
    ("K2 radiance", (16, 15, 16), 4, "wide", 1),
    ("K2 rays", (2048, 2048, 128), 4, None, 1),
    ("K2 baked", (240, 135, 128), 32897, None, 1),
    ("K3", (8, 65536, 16), 4, None, 1),
    ("K3", (1024, 1024, 512), 4, None, 1),
    ("K3", (16, 15, 16), 4, "wide", 1),
    ("K3", (16, 15, 16), 4, "narrow", 0),
    ("K9", (240, 135, 128), 32897, None, 1),
    ("K9", (8, 8, 65536), 4, None, 0),
    ("K9", (16, 15, 16), 4, "wide", 1),
    ("K1", (8, 8, 65536), 4, None, None),
    ("K1", (2048, 2048, 128), 300, None, None),
    ("K5", (8, 8, 65536), 4, None, 1),
    ("K5", (240, 135, 128), 4, None, 0),
    ("K5", (16, 15, 16), 4, "wide", 1),
    ("K6 radiance", (8, 8, 65536), 4, None, 1),
    ("K6 radiance", (16, 15, 16), 4, None, 0),
    ("K6 radiance", (16, 15, 16), 4, "wide", 1),
    ("K6 rays", (2048, 2048, 128), 4, None, 1),
    ("K6 baked", (240, 135, 128), 32897, None, 1),
    ("K6 baked", (240, 135, 128), 16, None, 0),
    ("K6 planes", (2048, 2048, 128), 4, None, 1),
    ("K6 planes", (16, 15, 16), 4, "narrow", 0),
    ("K7", (2048, 2048, 128), 4, None, 1),
    ("K7", (16, 15, 16), 4, None, 0),
    ("K7", (16, 15, 16), 4, "wide", 1),
    ("K8", (1024, 1024, 520), 4, None, 1),
    ("K8", (8, 8, 65536), 4, None, 0),
    ("K8", (16, 15, 16), 4, "wide", 1),
]


@pytest.mark.parametrize("kernel,grid,n_lights,forced,form_arg",
                         LAUNCH_CASES)
def test_wrappers_launch_past_32_bits(tables, kernel, grid, n_lights,
                                      forced, form_arg, monkeypatch):
    """The wrappers no longer refuse the tables past the narrow forms: each
    launches its source's form-taking entry point (K1 its one entry) with
    the declared argument count and the form argument last before the
    stream, the size rule's or the forced one."""
    calls = _stub_launch(monkeypatch)
    w, h, d = grid
    t = _with(tables, grid, n_lights=n_lights, meta=True)
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    name, entry = {"K1": ("bake_radiance", "vr_bake_radiance"),
                   "K3": ("integrate_blend", "vr_integrate_blend_form"),
                   "K5": ("shadow_blend", "vr_shadow_blend_form"),
                   "K7": ("dir_shadow", "vr_dir_shadow_form"),
                   "K8": ("integrate", "vr_integrate_form"),
                   "K9": ("bake_visibility", "vr_bake_visibility_form")}.get(
        kernel, ("scatter", "vr_scatter_form") if kernel.startswith("K6")
        else ("shadow_scatter", "vr_shadow_scatter_form"))
    if kernel == "K1":
        t_ff.bake_radiance(t)
    elif kernel == "K3":
        t_ff.integrate_blend(t, meta(4, d, h, w), meta(4, d, h, w),
                             form=forced)
    elif kernel == "K9":
        t_vis.bake_visibility(t, form=forced)
    elif kernel == "K5":
        t_sb.dir_shadow_blend(t, meta(1, d, h, w), form=forced)
    elif kernel == "K7":
        t_ds.dir_shadow(t, form=forced)
    elif kernel == "K8":
        t_int.accumulate(t, meta(4, d, h, w), form=forced)
    elif kernel == "K6 planes":
        t_sca.scatter_local(t, meta(1, d, h, w), meta(3, dl, hl, wl),
                            material=(meta(4, d, h, w), meta(1, d, h, w)),
                            form=forced)
    else:
        source = kernel.split()[1]
        low = {"radiance": meta(3 + t.n_noise, dl, hl, wl),
               "baked": meta(n_lights, dl, hl, wl)}.get(source)
        is_baked = source == "baked"
        fn = t_sca.scatter_local if kernel.startswith("K6") \
            else t_ff.shadow_scatter
        fn(t, meta(1, d, h, w), None if is_baked else low,
           low if is_baked else None, form=forced)
    (got_name, got_entry, args), = calls
    assert (got_name, got_entry or "vr_" + got_name) == (name, entry)
    assert len(args) + 1 == len(_declared(name, entry))
    if form_arg is not None:
        assert args[-1] == form_arg


@pytest.mark.parametrize("kernel,grid,n_lights", [
    ("K2", (8, 8, 65536), 4), ("K3", (8, 65536, 16), 4),
    ("K9", (240, 135, 128), 32897), ("K5", (2048, 2048, 128), 4),
    ("K6", (240, 135, 128), 32897), ("K6", (8, 8, 65536), 4),
    ("K7", (8, 8, 65536), 4), ("K8", (2048, 2048, 128), 4)])
def test_forced_narrow_form_past_its_edge_is_refused(tables, kernel, grid,
                                                     n_lights, monkeypatch):
    """Forcing the narrow form on tables past it raises ValueError, naming
    the kernel and its form, before any launch."""
    calls = _stub_launch(monkeypatch)
    w, h, d = grid
    t = _with(tables, grid, n_lights=n_lights, meta=True)
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match=f"{kernel}'s narrow form"):
        if kernel == "K2":
            t_ff.shadow_scatter(t, meta(1, d, h, w),
                                meta(3 + t.n_noise, dl, hl, wl),
                                form="narrow")
        elif kernel == "K3":
            t_ff.integrate_blend(t, meta(4, d, h, w), meta(4, d, h, w),
                                 form="narrow")
        elif kernel == "K5":
            t_sb.dir_shadow_blend(t, meta(1, d, h, w), form="narrow")
        elif kernel == "K6":
            t_sca.scatter_local(t, meta(1, d, h, w), None,
                                meta(n_lights, dl, hl, wl), form="narrow")
        elif kernel == "K7":
            t_ds.dir_shadow(t, form="narrow")
        elif kernel == "K8":
            t_int.accumulate(t, meta(4, d, h, w), form="narrow")
        else:
            t_vis.bake_visibility(t, form="narrow")
    assert calls == []


def test_past_the_wide_forms_is_refused_before_the_launch(tables,
                                                          monkeypatch):
    """What a wide form cannot index is refused by the kernel's name before
    any launch: K3 past 2^31 - 1 column tiles (its bare launch error
    before), K2 past 65535 tiles of 16 rows, K9's lights table of 2^31
    floats."""
    calls = _stub_launch(monkeypatch)
    meta = lambda *s: torch.empty(s, device="meta")
    t = _with(tables, (2 ** 35, 1, 1), meta=True)
    with pytest.raises(ValueError, match="K3.*column tiles.*2\\^31"):
        t_ff.integrate_blend(t, meta(4, 1, 1, 2 ** 35),
                             meta(4, 1, 1, 2 ** 35))
    t = _with(tables, (16, 16 * 65535 + 1, 1), meta=True)
    wl, hl, dl = t.low_dims
    with pytest.raises(ValueError, match="K2.*row tiles.*65535"):
        t_ff.shadow_scatter(t, meta(1, 1, 16 * 65535 + 1, 16),
                            meta(3 + t.n_noise, dl, hl, wl))
    with pytest.raises(ValueError, match="K9.*lights table.*2\\^31"):
        t_vis.bake_visibility(_with(tables, n_lights=2 ** 27, meta=True))
    with pytest.raises(ValueError, match="K3: form 'huge'"):
        t_ff.k3_form(tables, "huge")
    assert calls == []


def test_staged_past_the_wide_forms_is_refused_before_the_launch(
        tables, monkeypatch):
    """What K5's, K6's, K7's or K8's wide form cannot index is refused by
    the kernel's name before any launch: K5 and K7 past 65535 tiles of 16
    rows, K6's baked tiles past 65535 tiles of 8 rows, its runs past a
    slice of 2^31 froxels, its lights table of 2^31 floats, K8 past 2^31 -
    1 tiles of its 1-D grid."""
    calls = _stub_launch(monkeypatch)
    meta = lambda *s: torch.empty(s, device="meta")
    t = _with(tables, (16, 16 * 65535 + 1, 1), meta=True)
    wl, hl, dl = t.low_dims
    shadow = meta(1, 1, 16 * 65535 + 1, 16)
    with pytest.raises(ValueError, match="K5's wide form.*row tiles.*65535"):
        t_sb.dir_shadow_blend(t, shadow)
    with pytest.raises(ValueError, match="K7's wide form.*row tiles.*65535"):
        t_ds.dir_shadow(t)
    assert t_sca.k6_form(t, RAD) == "narrow"    # runs: no row tiles
    t = _with(tables, (16, 8 * 65535 + 1, 1), n_lights=4, meta=True)
    wl, hl, dl = t.low_dims
    with pytest.raises(ValueError, match="K6's wide form.*row tiles.*65535"):
        t_sca.scatter_local(t, meta(1, 1, 8 * 65535 + 1, 16), None,
                            meta(4, dl, hl, wl))
    t = _with(tables, (2 ** 16, 2 ** 15, 1), meta=True)
    wl, hl, dl = t.low_dims
    with pytest.raises(ValueError, match="K6's wide form.*froxels.*2\\^31"):
        t_sca.scatter_local(t, meta(1, 1, 2 ** 15, 2 ** 16),
                            meta(3 + t.n_noise, dl, hl, wl))
    with pytest.raises(ValueError, match="K6's wide form.*lights table"):
        t_sca.k6_form(_with(tables, n_lights=2 ** 27), RAY)
    t = _with(tables, (2 ** 30, 2 ** 8, 1), meta=True)    # 2^33 tiles
    with pytest.raises(ValueError, match="K8's wide form.*tiles.*2\\^31"):
        t_int.accumulate(t, meta(4, 1, 2 ** 8, 2 ** 30))
    with pytest.raises(ValueError, match="K6: form 'huge'"):
        t_sca.k6_form(tables, RAD, "huge")
    assert calls == []


# ---- the history and shadow-map frames' K10, K11 and K12 ------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pcf(grid, nd, s2=64, nc=4):
    """K12's tables for nd suns on `grid` and their atlases, as meta
    tensors."""
    w, h, d = grid
    t = t_pcf.PcfTables(
        par=_meta(nd, 24), coef=_meta(nd, d, nc, 8),
        order=_meta(nd, d, nc, dtype=torch.int32),
        count=_meta(nd, d, dtype=torch.int32), spheres=_meta(nd, nc, 4),
        grid_whd=grid, h_glob=h)
    return t, _meta(nd, s2, s2)


# one launch's [C, D, H, W] volume (a channel group) and its form: 2^31 - 1
# and 2^31 floats, 65535 and 65536 slices, FULL_CONFIG and DEEP
K10_K11_CASES = [
    ((1, 1, 1, EDGE), "narrow"),
    ((2, 1, 1, 2 ** 30), "wide"),
    ((1, 1, 2, 2 ** 30), "wide"),
    ((4, 128, 2048, 2047), "narrow"),
    ((4, 128, 2048, 2048), "wide"),
    ((1, 65535, 8, 8), "narrow"),
    ((1, 65536, 8, 8), "wide"),
    ((4, 128, 135, 240), "narrow"),      # FULL_CONFIG's accumulation
    ((4, 65664, 9, 16), "wide"),         # DEEP: deep_history's blends
    ((4, 520, 1024, 1024), "wide"),      # k10_k11_wide: 2,181,038,080
]


@pytest.mark.parametrize("kernel", ["K10", "K11"])
@pytest.mark.parametrize("shape,form", K10_K11_CASES)
def test_k10_k11_form_at_their_edges(kernel, shape, form):
    """K10's and K11's narrow forms up to 2^31 - 1 floats of a launch's
    volume and 65535 slices, the wide forms past them; forcing the narrow
    form past its edge is refused by the kernel's name."""
    mirror = t_tmp.k10_form if kernel == "K10" else t_wp.k11_form
    assert mirror(shape) == form
    assert mirror(shape, "wide") == "wide"
    if form == "wide":
        with pytest.raises(ValueError, match=f"{kernel}'s narrow form.*"
                           "(2\\^31|65535)"):
            mirror(shape, "narrow")


def test_k11_judges_each_channel_group(monkeypatch):
    """K11 launches 4 channels at a time, and each launch indexes its own
    group: an [8, D, H, W] volume past 2^31 floats whose groups hold 2^30
    each takes the narrow form in both launches (the whole volume was
    refused before); a [5, D, H, W] volume whose first group passes 2^31
    floats launches that group wide and its last channel narrow."""
    calls = _stub_launch(monkeypatch)
    d, h, w = 128, 1024, 2048
    assert cuda.past_int32("the volume", 8, d, h, w) is not None
    tgt = _meta(d, h, w)
    t_wp.windowed_warp(_meta(8, d, h, w), tgt, tgt, tgt, 4)
    assert [(a[5], a[-1]) for _, _, a in calls] == [(4, 0), (4, 0)]
    calls.clear()
    w = 4096
    tgt = _meta(d, h, w)
    t_wp.windowed_warp(_meta(5, d, h, w), tgt, tgt, tgt, 4)
    assert [(a[5], a[-1]) for _, _, a in calls] == [(4, 1), (1, 0)]
    assert t_wp.channel_groups(5) == [(0, 4), (4, 1)]


def test_k10_weight_groups_each_narrow(monkeypatch):
    """K10's weight mode over 520 suns' shadows [520, 128, 135, 240] (past
    2^31 floats: many_suns_map_wide) launches 130 groups of 4 channels,
    each under 2^31 floats and narrow; the alpha mode on DEEP's 65,664
    slices launches wide."""
    calls = _stub_launch(monkeypatch)
    vol = _meta(520, 128, 135, 240)
    assert vol.numel() > EDGE
    t_tmp.temporal_blend(_meta(1, 24), vol, vol, (240, 135, 128), 135, 4,
                         "weight")
    assert len(calls) == 130
    assert {(name, entry, a[4], a[-1]) for name, entry, a in calls} == {
        ("temporal_blend", "vr_temporal_blend_form", 4, 0)}
    calls.clear()
    vol = _meta(4, 65664, 9, 16)
    t_tmp.temporal_blend(_meta(1, 24), vol, vol, (16, 9, 65664), 9, 4,
                         "alpha")
    assert [(a[4], a[-1]) for _, _, a in calls] == [(4, 1)]


# (grid, suns, atlas side, form): the volumes, the atlases and the
# (sun, slice) pairs of the launch grid at their edges
K12_CASES = [
    ((EDGE, 1, 1), 1, 64, "narrow"),
    ((2 ** 30, 2, 1), 1, 64, "wide"),
    ((16, 15, 16), 1, 46340, "narrow"),     # 2,147,395,600 texels
    ((16, 15, 16), 1, 46341, "wide"),
    ((8, 8, 65535), 1, 64, "narrow"),
    ((8, 8, 65536), 1, 64, "wide"),
    ((240, 135, 128), 511, 64, "narrow"),   # 65,408 pairs
    ((240, 135, 128), 512, 64, "wide"),     # 65,536
    ((16, 9, 65664), 1, 1024, "wide"),      # deep_map_full_rate
    ((240, 135, 128), 520, 1024, "wide"),   # many_suns_map_wide
    ((120, 135, 64), 1, 1024, "narrow"),    # map_dir, low rate
]


@pytest.mark.parametrize("grid,nd,s2,form", K12_CASES)
def test_k12_form_at_its_edges(grid, nd, s2, form):
    """K12's narrow form up to 2^31 - 1 floats of volumes and atlases and
    65535 (sun, slice) pairs (511 suns at 128 slices, 512 past), the wide
    form past them; forcing the narrow form past its edge is refused by
    name."""
    t, atlas = _pcf(grid, nd, s2)
    assert t_pcf.k12_form(t, atlas) == form
    if form == "wide":
        with pytest.raises(ValueError, match="K12's narrow form.*"
                           "(2\\^31|65535)"):
            t_pcf.k12_form(t, atlas, "narrow")


# (kernel, the [C, D, H, W] volume or (grid, suns), forced form, the form
# argument of each launch)
HISTORY_MAP_LAUNCHES = [
    ("K10 alpha", (4, 65664, 9, 16), None, [1]),
    ("K10 alpha", (4, 128, 135, 240), None, [0]),
    ("K10 alpha", (4, 128, 135, 240), "wide", [1]),
    ("K10 weight", (6, 65664, 9, 16), None, [1, 1]),
    ("K10 weight", (1, 128, 135, 240), "narrow", [0]),
    ("K11", (4, 65664, 9, 16), None, [1]),
    ("K11", (4, 128, 135, 240), None, [0]),
    ("K11", (6, 128, 135, 240), "wide", [1, 1]),
    ("K12", ((16, 9, 65664), 1), None, [1]),
    ("K12", ((240, 135, 128), 520), None, [1]),
    ("K12", ((120, 135, 64), 1), None, [0]),
    ("K12", ((120, 135, 64), 2), "wide", [1]),
]


@pytest.mark.parametrize("kernel,shape,forced,form_args",
                         HISTORY_MAP_LAUNCHES)
def test_history_map_wrappers_launch_past_32_bits(kernel, shape, forced,
                                                  form_args, monkeypatch):
    """K10's, K11's and K12's wrappers launch their source's form-taking
    entry point, with the declared argument count and the form argument
    last before the stream: the size rule's for each launch, or the forced
    one."""
    calls = _stub_launch(monkeypatch)
    if kernel == "K12":
        t, atlas = _pcf(*shape)
        t_pcf.pcf_shadow(t, atlas, form=forced)
        name = "pcf_shadow"
    elif kernel == "K11":
        c, d, h, w = shape
        tgt = _meta(d, h, w)
        t_wp.windowed_warp(_meta(*shape), tgt, tgt, tgt, 4, form=forced)
        name = "windowed_warp"
    else:
        c, d, h, w = shape
        vol = _meta(*shape)
        t_tmp.temporal_blend(_meta(1, 24), vol, vol, (w, h, d), h, 4,
                             kernel.split()[1], form=forced)
        name = "temporal_blend"
    entry = f"vr_{name}_form"
    assert [(n, e) for n, e, _ in calls] == [(name, entry)] * len(form_args)
    assert all(len(a) + 1 == len(_declared(name, entry)) for _, _, a in calls)
    assert [a[-1] for _, _, a in calls] == form_args


def test_history_map_past_the_wide_forms_is_refused_before_the_launch(
        monkeypatch):
    """What K10's, K11's or K12's wide form cannot index is refused by the
    kernel's name before any launch: more than 65535 tiles of 16 rows on
    the launch grid's y axis, and K12's per-sun cascade table [D, C, 8] of
    2^31 floats (its in-sun index stays 32-bit); an unknown form too."""
    calls = _stub_launch(monkeypatch)
    h = 16 * 65535 + 1
    vol, tgt = _meta(1, 1, h, 16), _meta(1, h, 16)
    with pytest.raises(ValueError, match="K10's wide form.*row tiles.*65535"):
        t_tmp.temporal_blend(_meta(1, 24), vol, vol, (16, h, 1), h, 4,
                             "weight")
    with pytest.raises(ValueError, match="K11's wide form.*row tiles.*65535"):
        t_wp.windowed_warp(vol, tgt, tgt, tgt, 4)
    t, atlas = _pcf((16, h, 1), 1)
    with pytest.raises(ValueError, match="K12's wide form.*row tiles.*65535"):
        t_pcf.pcf_shadow(t, atlas)
    assert t_pcf.k12_form(*_pcf((16, h - 1, 1), 1)) == "narrow"
    t, atlas = _pcf((1, 1, 2 ** 26), 1)       # 2^26 x 4 x 8 = 2^31
    with pytest.raises(ValueError, match="K12's wide form.*cascade table"):
        t_pcf.pcf_shadow(t, atlas)
    assert t_pcf.k12_form(*_pcf((1, 1, 2 ** 26 - 1), 1)) == "wide"
    with pytest.raises(ValueError, match="K12: form 'huge'"):
        t_pcf.k12_form(*_pcf((16, 15, 16), 1), "huge")
    with pytest.raises(ValueError, match="K10: form 'huge'"):
        t_tmp.k10_form((1, 16, 15, 16), "huge")
    assert calls == []


@pytest.mark.parametrize("grid,nd,part", [((37, 21, 2), 3, 4),
                                          ((16, 15, 16), 5, 7),
                                          ((16, 9, 5), 2, 3)])
def test_k12_wide_parts_cover_each_froxel_once(grid, nd, part):
    """K12's wide form launches its flat (sun, slice) axis of nd x D
    blocks in parts (65535 on the card, `part` here); a block's flat index
    is its part's first plus blockIdx.z, split into (sun, slice) after
    that, its output at ((flat H) + y) W + x, as csrc/pcf_shadow.cu
    reckons them: every froxel of every sun once, in the narrow form's
    place."""
    w, h, d = grid
    gx, gy, _ = t_pcf.k12_grid(grid, nd)
    rows = t_pcf.K12_ROWS_PER_THREAD
    ty_n = t_pcf.K12_TILE[1] // rows
    seen = torch.zeros(nd * d * h * w, dtype=torch.int64)
    for b0 in range(0, nd * d, part):
        bz = b0 + torch.arange(min(part, nd * d - b0))
        sun, z = bz // d, bz - (bz // d) * d
        assert bool(((sun * d + z) == bz).all())
        by, bx, j, ty, tx = torch.meshgrid(
            torch.arange(gy), torch.arange(gx), torch.arange(rows),
            torch.arange(ty_n), torch.arange(t_pcf.K12_TILE[0]),
            indexing="ij")
        x = (bx * t_pcf.K12_TILE[0] + tx).reshape(-1)
        y = (by * t_pcf.K12_TILE[1] + ty + ty_n * j).reshape(-1)
        keep = (x < w) & (y < h)
        flat = ((bz[:, None] * h + y[None]) * w + x[None])[:, keep]
        seen += torch.bincount(flat.reshape(-1), minlength=seen.numel())
    assert bool((seen == 1).all())


# ---- the forms past a block's shared memory: K2, K5 and K7 keep the suns'
# inverse directions in device memory (gen_global), K1 takes its fBm
# channels in chunks

def _stub_launch_keeping(monkeypatch):
    """_stub_launch, keeping the tensors whose pointers were taken (the
    tables', then the launch's) in order."""
    calls, seen = _stub_launch(monkeypatch), []
    monkeypatch.setattr(cuda, "ptr", lambda t: seen.append(t))
    return calls, seen


# (kernel, suns, fBm channels, lights, forced form, entry point, the index
# form argument, what the last argument before it is)
SHARED_EDGE_CASES = [
    ("K2 radiance", 18436, 1, 4, None, "vr_shadow_scatter_global", 0,
     "suns"),
    ("K2 radiance", 18435, 1, 4, None, "vr_shadow_scatter_form", 0, None),
    ("K2 radiance", 9, 9, 4, "gen_global", "vr_shadow_scatter_global", 0,
     "suns"),
    ("K2 radiance", 9, 9, 4, ("wide", "gen_global"),
     "vr_shadow_scatter_global", 1, "suns"),
    ("K2 rays", 9, 9, 4, "gen_global", "vr_shadow_scatter_global", 0,
     "suns"),
    ("K2 baked", 9, 9, 4, ("gen_global", "wide"),
     "vr_shadow_scatter_global", 1, "suns"),
    ("K2 baked", 18436, 0, 4, None, "vr_shadow_scatter_global", 0, "suns"),
    ("K5", 18436, 0, 4, None, "vr_shadow_blend_global", 0, "suns"),
    ("K5", 18435, 0, 4, None, "vr_shadow_blend_form", 0, None),
    ("K5", 9, 0, 4, ("wide", "gen_global"), "vr_shadow_blend_global", 1,
     "suns"),
    ("K7", 19286, 0, 4, None, "vr_dir_shadow_global", 0, "suns"),
    ("K7", 19285, 0, 4, None, "vr_dir_shadow_form", 0, None),
    ("K7", 9, 0, 4, ("gen_global", "wide"), "vr_dir_shadow_global", 1,
     "suns"),
    ("K1", 1, 426, 16, None, "vr_bake_radiance", None, None),
    ("K1", 1, 425, 16, None, "vr_bake_radiance", None, None),
    ("K1", 1, 426, 16, "chunked", "vr_bake_radiance_chunked", 425, None),
    ("K1", 1, 422, 32, "chunked", "vr_bake_radiance_chunked", 421, None),
    ("K1", 1, 9, 16, "chunked", "vr_bake_radiance_chunked", 9, None),
]


@pytest.mark.parametrize("kernel,n_dir,n_noise,n_lights,forced,entry,"
                         "form_arg,before", SHARED_EDGE_CASES)
def test_wrappers_launch_past_shared_memory(tables, kernel, n_dir, n_noise,
                                            n_lights, forced, entry,
                                            form_arg, before, monkeypatch):
    """No sun or fBm channel count is refused: past a block's shared
    memory K2, K5 and K7 launch their gen_global entry point (the size
    rule's, or forced with `form=`) with the declared argument count and a
    [n_dir, 3] buffer for the suns' inverse directions before the index
    form argument; K1's one entry takes its chunked form by its own rule,
    and forced chunked launches its chunked entry, the staged channels
    last."""
    calls, seen = _stub_launch_keeping(monkeypatch)
    t = _with(tables, n_dir=n_dir, n_lights=n_lights, meta=True)
    t = dataclasses.replace(t, n_noise=n_noise)
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    prev = meta(n_dir, d, h, w)
    if kernel == "K1":
        name = "bake_radiance"
        t_ff.bake_radiance(t, form=forced)
    elif kernel == "K5":
        name = "shadow_blend"
        t_sb.dir_shadow_blend(t, prev, form=forced)
    elif kernel == "K7":
        name = "dir_shadow"
        t_ds.dir_shadow(t, form=forced)
    else:
        name = "shadow_scatter"
        source = kernel.split()[1]
        low = {"radiance": meta(3 + n_noise, dl, hl, wl),
               "baked": meta(n_lights, dl, hl, wl)}.get(source)
        t_ff.shadow_scatter(t, prev, None if source == "baked" else low,
                            low if source == "baked" else None, form=forced)
    (got_name, got_entry, args), = calls
    assert (got_name, got_entry or "vr_" + got_name) == (name, entry)
    assert len(args) + 1 == len(_declared(name, entry))
    if form_arg is not None:
        assert args[-1] == form_arg
    # the buffer of the suns' inverse directions: the launch's last pointer
    assert (tuple(seen[-1].shape) == (n_dir, 3)) == (before == "suns")


@pytest.mark.parametrize("kernel,forced,match", [
    ("K2", "general", "K2's .* shared memory"),
    ("K5", "general", "K5's .* shared memory"),
    ("K7", ("narrow", "general"), "K7's .* shared memory"),
    ("K2", ("narrow", "wide"), "K2: form"),
    ("K5", "chunked", "K5: form"),
    ("K1", "gen_global", "K1: form"),
    ("K1", "general", "K1's general form")])
def test_forced_form_past_shared_memory_is_refused(tables, kernel, forced,
                                                   match, monkeypatch):
    """Forcing the general form (the suns after the region) past a block's
    shared memory, or a form the kernel does not have, raises ValueError
    naming the kernel before any launch."""
    calls, _ = _stub_launch_keeping(monkeypatch)
    n_dir = 19286
    t = _with(tables, n_dir=n_dir, n_lights=16, meta=True)
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match=match):
        if kernel == "K1":
            t_ff.bake_radiance(dataclasses.replace(t, n_noise=426),
                               form=forced)
        elif kernel == "K2":
            t_ff.shadow_scatter(t, meta(n_dir, d, h, w),
                                meta(3 + t.n_noise, dl, hl, wl),
                                form=forced)
        elif kernel == "K5":
            t_sb.dir_shadow_blend(t, meta(n_dir, d, h, w), form=forced)
        else:
            t_ds.dir_shadow(t, form=forced)
    assert calls == []


@pytest.mark.parametrize("k,refused", [(158, False), (159, True), (4, False),
                                       (200, True)])
def test_k3_refuses_a_window_past_shared_memory(tables, k, refused):
    """K3's offsets grow with the reprojection window: from k = 159 its
    dynamic shared memory no longer fits beside its 20,992 static bytes
    (`refused`: its launcher's cudaFuncSetAttribute would fail). There the
    mirror (ops/frame_fused.k3_window_form) names the region_global form,
    the offsets in device memory, and up to k = 158 region_shared; either
    way the wrapper goes on to refuse only the meta tensors (not on CUDA),
    as region_global forced at any k does. Forcing region_shared past the
    edge is refused by name before any launch."""
    assert t_ff.K3_STATIC_SHARED == 20992
    assert t_ff.k3_shared_bytes(k) == 128 * (70 + 10 * k)
    t = dataclasses.replace(_with(tables, meta=True), k=k)
    w, h, d = t.grid_whd
    planes = torch.empty((4, d, h, w), device="meta")
    assert t_ff.k3_window_form(k) == ("region_global" if refused
                                      else "region_shared")
    for form in (None, "region_global", ("wide", "region_global")):
        with pytest.raises(ValueError, match="CUDA"):
            t_ff.integrate_blend(t, planes, planes, form=form)
    with pytest.raises(ValueError,
                       match="K3's .* shared memory" if refused else "CUDA"):
        t_ff.integrate_blend(t, planes, planes, form="region_shared")


# ---- the region forms past a block's shared memory: K2, K5 and K10 read
# their reprojection offsets from device memory from k = 52, K3 from
# k = 159 (region_global), each in its wide index form

# (kernel, reprojection window, forced form, entry point)
REGION_CASES = [
    ("K2 radiance", 52, None, "vr_shadow_scatter_region"),
    ("K2 radiance", 51, None, "vr_shadow_scatter_form"),
    ("K2 rays", 4, "region_global", "vr_shadow_scatter_region"),
    ("K2 baked", 400, ("wide", "region_global", "gen_global"),
     "vr_shadow_scatter_region"),
    ("K5", 52, None, "vr_shadow_blend_region"),
    ("K5", 51, None, "vr_shadow_blend_form"),
    ("K5", 4, ("region_global", "gen_global"), "vr_shadow_blend_region"),
    ("K10 weight", 52, None, "vr_temporal_blend_region"),
    ("K10 alpha", 400, None, "vr_temporal_blend_region"),
    ("K10 alpha", 51, None, "vr_temporal_blend_form"),
    ("K10 weight", 4, ("region_global", "wide"), "vr_temporal_blend_region"),
    ("K3", 159, None, "vr_integrate_blend_region"),
    ("K3", 158, None, "vr_integrate_blend_form"),
    ("K3", 4, "region_global", "vr_integrate_blend_region"),
]


@pytest.mark.parametrize("kernel,k,forced,entry", REGION_CASES)
def test_wrappers_launch_region_global(tables, kernel, k, forced, entry,
                                       monkeypatch):
    """No reprojection window is refused by K2, K5, K10 or K3: past the
    edge of their shared memory (or forced with `form=`) each launches its
    region_global entry point with the declared argument count and a
    [4, D, H, W] plane for the offsets as its last pointer (K2 and K5: the
    [n_dir, 3] buffer of the suns' inverse directions before it); K10's
    9 weight channels are three launches that share one plane, the first
    filling it. One window less launches the shared form's entry."""
    calls, seen = _stub_launch_keeping(monkeypatch)
    t = dataclasses.replace(_with(tables, meta=True), k=k)
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    prev = meta(t.n_dir, d, h, w)
    if kernel == "K5":
        t_sb.dir_shadow_blend(t, prev, form=forced)
    elif kernel == "K3":
        planes = meta(4, d, h, w)
        t_ff.integrate_blend(t, planes, planes, form=forced)
    elif kernel.startswith("K10"):
        mode = kernel.split()[1]
        vol = meta(9 if mode == "weight" else 4, d, h, w)
        t_tmp.temporal_blend(meta(1, 24), vol, vol, (w, h, d), h, k, mode,
                             form=forced)
    else:
        source = kernel.split()[1]
        low = {"radiance": meta(3 + t.n_noise, dl, hl, wl),
               "baked": meta(4, dl, hl, wl)}.get(source)
        t_ff.shadow_scatter(t, prev, None if source == "baked" else low,
                            low if source == "baked" else None, form=forced)
    name = {"K2": "shadow_scatter", "K5": "shadow_blend",
            "K10": "temporal_blend", "K3": "integrate_blend"}[
        kernel.split()[0]]
    n_calls = 3 if kernel == "K10 weight" else 1
    assert [(c[0], c[1]) for c in calls] == [(name, entry)] * n_calls
    for _, _, args in calls:
        assert len(args) + 1 == len(_declared(name, entry))
    if not entry.endswith("_region"):
        return
    plane = [s_ for s_ in seen if tuple(s_.shape) == (4, d, h, w)
             and s_.dtype == torch.float32 and s_ is not prev]
    if kernel.startswith("K10"):
        # bpar, prev, cur, out, plane per launch: fill on the first
        assert [a[5] for _, _, a in calls] == [1] + [0] * (n_calls - 1)
        assert all(seen[5 * i + 4] is seen[4] for i in range(n_calls))
        assert tuple(seen[4].shape) == (4, d, h, w)
    else:
        assert seen[-1] is plane[-1]
    if kernel.split()[0] in ("K2", "K5"):
        assert tuple(seen[-2].shape) == (t.n_dir, 3)


@pytest.mark.parametrize("kernel,forced,match", [
    ("K2", ("narrow", "region_global"), "K2's region_global form has no "
     "narrow"),
    ("K2", ("general", "region_global"), "K2's general form cannot take"),
    ("K5", ("fixed", "region_global"), "K5's fixed form cannot take"),
    ("K5", "region_shared", "K5's region does not fit"),
    ("K10", "region_shared", "K10's region does not fit"),
    ("K10", ("narrow", "region_global"), "K10's region_global form has no "
     "narrow"),
    ("K3", "region_shared", "K3's .* shared memory"),
    ("K3", ("region_global", "narrow"), "K3's region_global form has no "
     "narrow"),
    ("K3", ("region_global", "region_shared"), "K3: form")])
def test_forced_region_form_is_refused(tables, kernel, forced, match,
                                       monkeypatch):
    """At k = 200, past every edge: forcing the region_shared form, the
    narrow index form or a sun form other than gen_global with
    region_global, or two region forms, raises ValueError naming the
    kernel before any launch."""
    calls, _ = _stub_launch_keeping(monkeypatch)
    t = dataclasses.replace(_with(tables, meta=True), k=200)
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match=match):
        if kernel == "K2":
            t_ff.shadow_scatter(t, meta(t.n_dir, d, h, w),
                                meta(3 + t.n_noise, dl, hl, wl),
                                form=forced)
        elif kernel == "K5":
            t_sb.dir_shadow_blend(t, meta(t.n_dir, d, h, w), form=forced)
        elif kernel == "K10":
            vol = meta(4, d, h, w)
            t_tmp.temporal_blend(meta(1, 24), vol, vol, (w, h, d), h, 200,
                                 "alpha", form=forced)
        else:
            planes = meta(4, d, h, w)
            t_ff.integrate_blend(t, planes, planes, form=forced)
    assert calls == []

"""The port's screen-space ops against the reference package's, on the same
inputs: the shared dither hash (``ops.ssao._pixel_hash_bits``), SSAO and its
blur, the screen-trace helpers, contact shadows, the atmosphere's sky, SSR,
volumetric fog, decals and the lens flare's probe and lobes.

Inputs: the G-buffer of the deferred golden scene (tests/test_golden.py's
cube over the ground) rendered by the port at 64×32, with a numpy-seeded
HDR plane, seeded roughness and metalness, and seeded ray directions and
parameters; each reference function is compiled once per case with
``jax.jit``, as the reference's frame compiles it (XLA's CPU backend then
contracts multiply-adds into fused multiply-adds, which the port rounds
apart: ROADMAP §3, "FMA").

Tolerances (each test states its own): the hash bit-equal; the blur, the
decal blend, the flare probe and lobes within atol 1e-6 to 1e-5; the sky
within rtol 1e-3 + atol 1e-5 on every ray, horizon rays included (the
planet-scale subtractions are rounded as fused multiply-adds,
``ops.atmosphere._fma``: rounded apart, 7% of the rays through the horizon
miss by up to 370%);
the marches within atol 1e-6 (SSR and fog + rtol 1e-6), contact shadows
equal: on these inputs no tap index or step verdict flips between the two
roundings.

The SPMD cases of these passes are test_torch_screenspace_spmd.py's.
"""

import numpy as np
import pytest
import torch

import jax

from zenith_tpu_torch.ops import atmosphere as tatmo
from zenith_tpu_torch.ops import contact as tcontact
from zenith_tpu_torch.ops import screentrace as ttrace
from zenith_tpu_torch.ops import ssao as tssao
from zenith_tpu_torch.ops import ssr as tssr
from zenith_tpu_torch.ops import volumetric as tvol
from zenith_tpu_torch.renderer import decal as tdecal
from zenith_tpu_torch.renderer import flare as tflare

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 64, 32


@pytest.fixture(scope="module")
def gbuf():
    """The port's deferred golden scene at 64×32: G-buffer planes, camera
    and sun, plus a seeded HDR plane and seeded material planes."""
    from zenith_tpu_torch.rendergraph import CompileOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import RhiCore
    from zenith_tpu_torch.sandbox.scene import deferred_frame, golden_scene

    device = RhiCore(CPU).create_render_device()
    scene, cam = golden_scene(device)
    renderer = DeferredRenderer(scene)
    names = ("albedo", "normal", "pos", "depth", "sun_shadow")
    compiled, _, _, _ = deferred_frame(device, renderer, cam, W, H,
                                       CompileOptions(tile_h=8, tile_w=128), exports=names)
    g = {k: compiled.value(renderer.gbuffer_handles[k]).numpy() for k in names}
    rng = np.random.default_rng(2026)
    g["hdr"] = rng.uniform(0.0, 3.0, (H, W, 4)).astype(np.float32)
    g["albedo"] = g["albedo"].copy()
    g["albedo"][..., 3] = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    g["normal"] = g["normal"].copy()
    g["normal"][..., 3] = rng.uniform(0.0, 0.7, (H, W)).astype(np.float32)
    g["view_proj"] = np.asarray(cam.render_view_projection, np.float32)
    g["inv_vp"] = np.asarray(cam.render_inv_view_projection, np.float32)
    g["cam"] = np.asarray(cam.location, np.float32)
    from zenith_tpu_torch.core import mathtypes as m
    from zenith_tpu_torch.renderer.forward import sun_view_projection

    g["sun_dir"] = m.normalize(np.asarray(scene.sun.direction, np.float32))
    g["light_vp"] = np.asarray(sun_view_projection(scene.sun), np.float32)
    g["bias"] = np.float32(scene.sun.shadow_bias)
    assert (g["depth"] > 0).mean() > 0.3
    return g


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("h, w, row0, seed", [(32, 64, 0, None), (17, 29, 5, None),
                                              (16, 16, 1000, 7), (8, 8, 3, 4_000_000_000),
                                              (4, 300, 70000, 123456789)])
def test_pixel_hash_bits_are_the_reference_bits(h, w, row0, seed):
    from zenith_tpu.ops.ssao import _pixel_hash_bits

    ref = np.asarray(jax.jit(lambda r, s: _pixel_hash_bits(h, w, r, s))(
        np.uint32(row0), None if seed is None else np.uint32(seed)))
    port = tssao._pixel_hash_bits(h, w, row0, seed, device=CPU).numpy()
    np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64))
    if seed is not None:  # a device-valued seed and row0 give the same bits
        port_t = tssao._pixel_hash_bits(h, w, torch.tensor(row0), torch.tensor(seed),
                                         device=CPU).numpy()
        np.testing.assert_array_equal(port_t, port)


def test_hash_angle_and_hemisphere_kernel_equal_the_reference():
    from zenith_tpu.ops.ssao import _pixel_hash_angle, hemisphere_kernel

    np.testing.assert_array_equal(tssao._pixel_hash_angle(H, W, device=CPU).numpy(),
                                  np.asarray(jax.jit(lambda: _pixel_hash_angle(H, W))()))
    for k, seed in ((12, 11), (7, 3)):
        np.testing.assert_array_equal(tssao.hemisphere_kernel(k, seed), hemisphere_kernel(k, seed))


@pytest.mark.parametrize("radius, bias, intensity", [(4.0, 0.04, 1.0), (9.0, 0.2, 1.7)])
def test_ssao_occlusion_and_blur_match(gbuf, radius, bias, intensity):
    """Raw AO and the blur within atol 1e-6 (measured: 6e-8)."""
    from zenith_tpu.ops.ssao import hemisphere_kernel, ssao_blur, ssao_occlusion

    kern = hemisphere_kernel(12)
    pos, nrm, dep = gbuf["pos"][..., :3], gbuf["normal"][..., :3], gbuf["depth"]
    ref = np.asarray(jax.jit(lambda p, n, d, vp: ssao_occlusion(
        p, n, d, vp, kern, radius=radius, bias=bias, intensity=intensity))(
        pos, nrm, dep, gbuf["view_proj"]))
    port = tssao.ssao_occlusion(_t(pos), _t(nrm), _t(dep), _t(gbuf["view_proj"]), kern,
                                radius=radius, bias=bias, intensity=intensity).numpy()
    assert (ref < 0.999).sum() >= 15  # the cube's foot and edges occlude
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)
    for taps, tol in ((4, 5e-4), (2, 1e-2)):
        rb = np.asarray(jax.jit(lambda a, d: ssao_blur(a, d, taps=taps, depth_tol=tol))(ref, dep))
        pb = tssao.ssao_blur(_t(ref), _t(dep), taps=taps, depth_tol=tol).numpy()
        np.testing.assert_allclose(pb, rb, atol=1e-6, rtol=0)


def test_screentrace_helpers_match(gbuf):
    """The packed plane bit-equal; projected coordinates within 1e-3 px,
    validity and tap indices equal on all but 0.5% of the points; the radial
    gap within 1e-4 units (1e-3 relative on the far ground) where the indices
    agree."""
    from zenith_tpu.ops.screentrace import pack_tap_plane, project_to_screen, tap_radial_gap

    rng = np.random.default_rng(5)
    pos, dep = gbuf["pos"][..., :3], gbuf["depth"]
    q = (pos + rng.normal(0.0, 3.0, pos.shape)).astype(np.float32)
    flat = np.asarray(jax.jit(pack_tap_plane)(pos, dep))
    np.testing.assert_array_equal(ttrace.pack_tap_plane(_t(pos), _t(dep)).numpy(), flat)
    rsx, rsy, rin, ridx = (np.asarray(a) for a in jax.jit(
        lambda q, vp: project_to_screen(q, vp, H, W))(q, gbuf["view_proj"]))
    sx, sy, inside, idx = (a.numpy() for a in ttrace.project_to_screen(
        _t(q), _t(gbuf["view_proj"]), H, W))
    np.testing.assert_allclose(sx, rsx, atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(sy, rsy, atol=1e-3, rtol=1e-5)
    assert (inside != rin).mean() <= 0.005 and (idx != ridx).mean() <= 0.005
    assert 0.2 < rin.mean() < 1.0
    rdep, rgap = (np.asarray(a) for a in jax.jit(
        lambda f, i, q, c: tap_radial_gap(f, i, q, c, (H, W)))(flat, ridx, q, gbuf["cam"]))
    sdep, gap = (a.numpy() for a in ttrace.tap_radial_gap(_t(flat), _t(ridx).long(), _t(q),
                                                           _t(gbuf["cam"]), (H, W)))
    np.testing.assert_array_equal(sdep, rdep)
    np.testing.assert_allclose(gap, rgap, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("sun, strength, dist, thick, steps", [
    ((0.05, -0.05, 1.0), 0.85, 3.0, 1.0, 8), ((0.9, 0.3, 0.3), 1.0, 10.0, 5.0, 5)])
def test_contact_shadow_factor_matches(gbuf, sun, strength, dist, thick, steps):
    """Equal at every pixel."""
    from zenith_tpu.ops.contact import contact_shadow_factor

    pos, dep = gbuf["pos"][..., :3], gbuf["depth"]
    sun = np.asarray(sun, np.float32)
    sun /= np.linalg.norm(sun)
    ref = np.asarray(jax.jit(lambda p, d, s, c, vp: contact_shadow_factor(
        p, d, p, d, s, c, vp, strength=strength, max_dist=dist, thickness=thick,
        steps=steps))(pos, dep, sun, gbuf["cam"], gbuf["view_proj"]))
    port = tcontact.contact_shadow_factor(_t(pos), _t(dep), _t(pos), _t(dep), _t(sun),
                                          _t(gbuf["cam"]), _t(gbuf["view_proj"]),
                                          strength=strength, max_dist=dist, thickness=thick,
                                          steps=steps).numpy()
    assert (ref < 1.0).sum() >= 10  # some pixels are contact-shadowed
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("cam_height, sun", [(25.0, (0.8, -0.55, 0.1)),
                                             (112.0, (0.45, -0.35, 0.55)),
                                             (2.0, (0.1, 0.2, 0.05))])
def test_sky_radiance_matches_through_the_horizon(cam_height, sun):
    """Every ray within rtol 1e-3 + atol 1e-5: rays dense through the
    horizon, steep ground hits and rays through the sun disk's edge
    included. The ray-sphere terms subtract numbers near 4e13 in float32;
    the port rounds those multiply-adds as fused, and the disk window as
    the compiled reference folds it (ops.atmosphere). Rounded apart, 7% of
    the horizon rays at 25 m miss by up to 370%, and the disk's edge by 8%.
    The atol covers steep ground hits from 2 m up, whose 5-14 m march
    cancels |b| ~ 2e6 in float32 (radiance ~1e-4, relative error ~5%)."""
    from zenith_tpu.ops.atmosphere import Atmosphere, sky_radiance

    rng = np.random.default_rng(17)
    el = np.concatenate([np.linspace(-0.4, 0.6, 1500), np.linspace(-0.006, 0.002, 1500)])
    az = rng.uniform(-np.pi, np.pi, el.shape)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    s = np.asarray(sun, np.float64)
    s = (s / np.linalg.norm(s)).astype(np.float32)
    d[:40] = s + rng.normal(0, 2e-3, (40, 3))  # rays through the sun disk's edge
    d[:40] /= np.linalg.norm(d[:40], axis=-1, keepdims=True)
    cfg = Atmosphere(mie_g=0.7, sun_intensity=20.0)
    params = cfg.packed(cam_height)
    ref = np.asarray(jax.jit(lambda a, b, c: sky_radiance(a, b, c, cfg))(d, s, params))
    port = tatmo.sky_radiance(_t(d), _t(s), _t(params), tatmo.Atmosphere(
        mie_g=0.7, sun_intensity=20.0)).numpy()
    assert np.isfinite(port).all() and ref.max() > 1.0
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-5)
    assert tatmo.Atmosphere().__zenith_capture_key__() == Atmosphere().__zenith_capture_key__()
    np.testing.assert_array_equal(tatmo.Atmosphere().packed(0.5), Atmosphere().packed(0.5))


@pytest.mark.parametrize("jitter, params", [(True, (1.0, 150.0, 2.0, 0.6)),
                                            (False, (0.7, 60.0, 20.0, 0.9))])
def test_ssr_reflect_matches(gbuf, jitter, params):
    """Within atol 1e-6 + rtol 1e-6 (measured: 4e-7 on values up to 3)."""
    from zenith_tpu.ops.ssr import ssr_reflect

    p = np.asarray(params, np.float32)
    args = (gbuf["hdr"], gbuf["albedo"], gbuf["normal"], gbuf["pos"][..., :3], gbuf["depth"],
            gbuf["cam"], gbuf["view_proj"], p)
    ref = np.asarray(jax.jit(lambda *a: ssr_reflect(*a, 12, 4, jitter))(*args))
    port = tssr.ssr_reflect(*(_t(a) for a in args), 12, 4, jitter).numpy()
    assert np.abs(ref - gbuf["hdr"]).max() > 1e-3  # reflections were added
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shafts", [True, False])
def test_volumetric_sun_matches(gbuf, shafts):
    """Within atol 1e-6 + rtol 1e-6 (measured: 6e-7 on values up to 3.5),
    with shafts (16 shadow-map taps a pixel) and without."""
    from zenith_tpu.ops.volumetric import volumetric_sun
    from zenith_tpu_torch.renderer.volumetric import view_rays

    dirs = view_rays(_t(gbuf["inv_vp"]), _t(gbuf["cam"]), H, W)
    dirs = (dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True))).numpy()
    params = np.asarray([0.02, 0.0, 25.0, 0.6, 150.0, 0.9, 0.08, 0.0], np.float32)
    color = np.asarray([2.0, 1.8, 1.5], np.float32)
    sm = gbuf["sun_shadow"] if shafts else None
    lvp = gbuf["light_vp"] if shafts else None
    args = (gbuf["hdr"], gbuf["pos"][..., :3], gbuf["depth"], gbuf["cam"], dirs,
            gbuf["sun_dir"], color, params)
    ref = np.asarray(jax.jit(lambda sm, lvp, *a: volumetric_sun(
        *a, shadow_map=sm, light_vp=lvp, shadow_bias=gbuf["bias"], steps=16))(sm, lvp, *args))
    port = tvol.volumetric_sun(*(_t(a) for a in args), shadow_map=None if sm is None else _t(sm),
                               light_vp=None if lvp is None else _t(lvp),
                               shadow_bias=float(gbuf["bias"]), steps=16).numpy()
    assert np.abs(ref - gbuf["hdr"]).max() > 1e-2  # fog was added
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("textured", [False, True])
def test_apply_decal_matches(gbuf, textured):
    """Within atol 1e-6, solid and textured (bilinear over an RGBA texture)."""
    from zenith_tpu.renderer.decal import Decal, apply_decal

    rng = np.random.default_rng(9)
    tex = rng.uniform(0.0, 1.0, (16, 16, 4)).astype(np.float32) if textured else None
    d = Decal("d", position=(2.0, -10.0, 0.1), size=(30.0, 20.0, 40.0), up=(0.3, 1.0, 0.0),
              forward=(0.1, 0.05, -1.0), color=(0.9, 0.3, 0.2, 0.8), normal_fade=0.35)
    mat = d.world_to_decal()
    td = tdecal.Decal("d", position=d.position, size=d.size, up=d.up, forward=d.forward,
                      color=d.color, normal_fade=d.normal_fade)
    np.testing.assert_array_equal(td.world_to_decal(), mat)
    np.testing.assert_array_equal(tdecal.stacked_decal_colors([td]),
                                  np.asarray([d.color], np.float32))
    col = np.asarray(d.color, np.float32)
    args = (gbuf["albedo"][..., :3], gbuf["pos"][..., :3], gbuf["normal"][..., :3], mat, col)
    ref = np.asarray(jax.jit(lambda t, *a: apply_decal(*a, t, 0.35))(tex, *args))
    port = tdecal.apply_decal(*(_t(a) for a in args), None if tex is None else _t(tex),
                              0.35).numpy()
    assert np.abs(ref - gbuf["albedo"][..., :3]).max() > 0.1  # the decal lands
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)


SUN_UVS = [(0.0, 0.0), (1.0, 1.0), (0.999, 0.02), (0.03, 0.97), (0.5, 0.0), (0.5, 1.0),
           (0.0, 0.5), (1.0, 0.5), (0.52, 0.47), (-0.2, 1.3)]


@pytest.mark.parametrize("sun_uv", SUN_UVS, ids=lambda uv: f"{uv[0]}-{uv[1]}")
def test_flare_probe_and_lobes_match(gbuf, sun_uv):
    """The probe's window at every border and corner (clamped as the
    reference clamps its dynamic slice) within 1e-6; the ghosts, halo and
    streak within 1e-5 + rtol 1e-5."""
    from zenith_tpu.renderer.flare import LensFlare, _apply_flare, _probe_visibility

    rgb = gbuf["hdr"][..., :3] * 0.5
    rgb[:4] += 2.0  # a bright band at the top, so the probe's value moves
    uv = np.asarray(sun_uv, np.float32)
    cfg = LensFlare()
    ref_v = np.asarray(jax.jit(lambda r, u: _probe_visibility(r, u, cfg))(rgb, uv))
    port_v = tflare._probe_visibility(_t(rgb), _t(uv), tflare.LensFlare()).numpy()
    np.testing.assert_allclose(port_v, ref_v, atol=1e-6, rtol=0)
    vis = np.float32(0.8)
    col = np.asarray((1.0, 0.92, 0.8), np.float32)
    ref = np.asarray(jax.jit(lambda r, u, v: _apply_flare(r, u, v, col, cfg, 0, H))(rgb, uv, vis))
    port = tflare._apply_flare(_t(rgb), _t(uv), _t(vis), col, tflare.LensFlare(), 0, H).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)

"""Textured materials in the port against the reference package: the
screen-space derivatives and the derivative-built normal map
(``ops.shade``), anisotropic sampling (``ops.sampling``), the textured
G-buffer fragment stage with its four material atlases, the sandbox's
procedural textures and textured scene, ``SceneObject.from_mesh_with_material``,
and whole frames: the textured golden, a full-material-set deferred frame
carried across from the reference's scene, and ``MeshRenderer``.

Tolerances: ``dfdx``/``dfdy`` bit-equal; ``perturb_normal``, anisotropic
sampling and the G-buffer fragment stage within atol 1e-5 on the same
inputs; the sandbox textures and the uploaded material textures bit-equal.
Frames: the encoded frame ≤ 1 LSB with < 1% of values differing (against
``textured_scene_128x64.npy`` and against the JAX frame, the reference's own
golden tolerance); the HDR frame atol 1e-5 + rtol 1e-5 (XLA's CPU backend
contracts multiply-adds into FMAs, the port rounds every product: ROADMAP
§3), except on the normal-mapped ground: there the G-buffer normal within
atol 1e-4 and the HDR frame within atol 1e-3 + rtol 1e-3. The test holds
the reason too: on the 100-unit ground the two rasters' world positions
each lie within 1e-4 units of a float64 ray cast (2e-6 of the ground's
extent; measured 4.5e-5 and 4.4e-5) and differ from each other by up to
5e-5, rounding only; the map's tangent frame is the screen-space
difference of neighbouring positions, which cancels their leading digits,
so that difference alone moves perturb_normal's result by more than 1e-5
(perturb_normal itself agrees to 4e-7 on equal inputs), and the glossy lit
colour by up to ~2e-4 relative.
``MeshRenderer``'s linear frame atol 1e-5 + rtol 1e-5.

Each JAX frame is rendered once per module (fixtures); the textured golden
frame is compared with the golden, not with a JAX render.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.ops import sampling as tsampling
from zenith_tpu_torch.ops import shade as tshade
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.rhi import Format as TFormat, RhiCore as TCore, encode_present
from zenith_tpu_torch.rhi.sampler import SamplerConfig as TSampler
from zenith_tpu_torch.sandbox import scene as tscene

sys.path.insert(0, str(Path(__file__).parent))
torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
GOLDEN = Path(__file__).parent / "golden" / "textured_scene_128x64.npy"


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


# -- ops ------------------------------------------------------------------------


def test_screen_space_derivatives_are_bit_equal():
    from zenith_tpu.ops import shade as jshade

    rng = np.random.default_rng(0)
    for shape in ((9, 13, 3), (5, 7, 2), (6, 4)):
        x = rng.normal(size=shape).astype(np.float32) * 100
        for fn in ("dfdx", "dfdy"):
            t = getattr(tshade, fn)(torch.from_numpy(x)).numpy()
            j = np.asarray(getattr(jshade, fn)(jnp.asarray(x)))
            assert t.shape == j.shape == shape
            np.testing.assert_array_equal(t, j)


def _planes(h=16, w=16):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    world = np.stack([xs / 4.0, ys / 4.0, np.zeros_like(xs)], -1)
    uv = np.stack([xs / w, ys / h], -1)
    n = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), (h, w, 3)).copy()
    return n, world, uv


def _bumpy():
    """A curved, perspective-like surface under a random normal map."""
    rng = np.random.default_rng(5)
    h, w = 24, 32
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 1.0 + ys / h * 3.0
    world = np.stack([xs * depth / 8, ys * depth / 6, np.sin(xs / 5) * 2], -1)
    n = np.stack([-np.cos(xs / 5) * 0.4, np.zeros_like(xs), np.ones_like(xs)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = np.stack([(xs / w) ** 1.3, ys / h * (0.5 + xs / w)], -1)
    sample = rng.uniform(0.2, 0.8, (h, w, 3))
    sample[..., 2] = rng.uniform(0.7, 1.0, (h, w))
    return (n.astype(np.float32), world.astype(np.float32), uv.astype(np.float32),
            sample.astype(np.float32))


def _perturb_case(case):
    n, world, uv = _planes()
    if case == "flat":
        return n, world, uv, np.broadcast_to(np.float32([0.5, 0.5, 1.0]), n.shape).copy()
    if case == "tilted":
        return n, world, uv, np.broadcast_to(np.float32([0.85, 0.5, 0.85]), n.shape).copy()
    if case == "degenerate-uv":
        return (n, world, np.zeros_like(uv),
                np.broadcast_to(np.float32([0.9, 0.1, 0.5]), n.shape).copy())
    return _bumpy()


@pytest.mark.parametrize("case", ["flat", "tilted", "degenerate-uv", "curved"])
def test_perturb_normal_matches_the_reference(case):
    from zenith_tpu.ops.shade import perturb_normal as jperturb

    n, world, uv, sample = _perturb_case(case)
    t = tshade.perturb_normal(*(torch.from_numpy(a) for a in (n, world, uv, sample))).numpy()
    j = np.asarray(jperturb(*(jnp.asarray(a) for a in (n, world, uv, sample))))
    np.testing.assert_allclose(t, j, atol=1e-5)
    if case in ("flat", "degenerate-uv"):
        np.testing.assert_allclose(t, n, atol=1e-5)  # the geometric normal kept
    if case == "tilted":
        assert t[8, 8, 0] > 0.2 and t[8, 8, 2] > 0.5


def _checker_mips(n=64):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    base = np.stack([c, 1 - c * 0.5, c * 0.25, np.ones_like(c)], -1).astype(np.float32)
    mips = [base]
    while min(mips[-1].shape[:2]) > 1:
        cur = mips[-1]
        hh, ww = cur.shape[0] // 2, cur.shape[1] // 2
        mips.append(cur[:hh * 2, :ww * 2].reshape(hh, 2, ww, 2, -1).mean((1, 3))
                    .astype(np.float32))
    return mips


def _uv_image(kind):
    """The UV images of tests/test_fixedfunc.py's anisotropic cases
    (isotropic grid, footprint stretched 8:1 in u) and an oblique ramp
    whose footprint turns and grows across the image."""
    if kind == "isotropic":
        u = (np.arange(16, dtype=np.float32) + 0.5) / 16
        return np.stack(np.meshgrid(u, u), -1)
    if kind == "stretched":
        u = (np.arange(8, dtype=np.float32) + 0.5) / 8
        v = (np.arange(32, dtype=np.float32) + 0.5) / (32 * 4)
        return np.stack(np.meshgrid(u, v, indexing="xy"), -1)
    ys, xs = np.mgrid[0:40, 0:56].astype(np.float32)
    return np.stack([(xs / 56) ** 1.5 * 3.0, ys / 40 * (0.2 + 2.5 * xs / 56)], -1)


@pytest.mark.parametrize("max_aniso", [4.0, 8.0])
@pytest.mark.parametrize("kind", ["isotropic", "stretched", "oblique"])
def test_anisotropic_sampling_matches_the_reference(kind, max_aniso):
    from zenith_tpu.ops import sampling as jsampling
    from zenith_tpu.rhi.sampler import SamplerConfig as JSampler

    mips = _checker_mips()
    uv = _uv_image(kind).astype(np.float32)
    j = np.asarray(jsampling.sample_texture(tuple(jnp.asarray(m) for m in mips),
                                            jnp.asarray(uv),
                                            JSampler.anisotropic(max_aniso)))
    t = tsampling.sample_texture(tuple(torch.from_numpy(m) for m in mips), torch.from_numpy(uv),
                                 TSampler.anisotropic(max_aniso)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    direct = tsampling.sample_2d_aniso(tsampling.pack_mips([torch.from_numpy(m) for m in mips]),
                                       torch.from_numpy(uv),
                                       TSampler.anisotropic(max_aniso), 64, 64)
    np.testing.assert_array_equal(direct.numpy(), t)
    if kind == "stretched":  # the probes keep detail that trilinear blurs away
        tri = tsampling.sample_texture(tuple(torch.from_numpy(m) for m in mips),
                                       torch.from_numpy(uv), TSampler.linear())
        assert t[1:, 1:].std() > tri.numpy()[1:, 1:].std()


# -- the G-buffer's material set --------------------------------------------------


def _solid(color, size=8):
    return np.broadcast_to(np.asarray(color, np.float32), (size, size, 4)).copy()


_MAPS = {
    "base": {"BaseAtlas": ([_checker_mips(16)[0]], None)},
    "mra": {"BaseAtlas": ([None], None), "MraAtlas": ([_solid((1.0, 0.25, 0.75, 1.0))], None)},
    "emissive": {"BaseAtlas": ([None], None),
                 "EmissiveAtlas": ([_solid((0.0, 1.0, 0.3, 1.0))], None)},
    "normal": {"BaseAtlas": ([None], None), "NormalAtlas": ([_solid((0.85, 0.5, 0.65, 1.0))], 1)},
}


@pytest.mark.parametrize("case", sorted(_MAPS))
def test_gbuffer_material_set_matches_the_reference(case):
    """The fragment stage with atlased maps (tests/test_materials.py's
    base, MRA, emissive and normal cases) on the same varyings and atlases
    in both packages."""
    from zenith_tpu.renderer import deferred as jdef
    from zenith_tpu.rhi.atlas import build_atlas as jatlas
    from zenith_tpu.rhi.formats import Format as JFormat
    from zenith_tpu.rhi.resource import Texture as JTexture
    from zenith_tpu.rhi.shader import FragmentBuiltins as JBuiltins
    from zenith_tpu_torch.renderer import deferred as tdef
    from zenith_tpu_torch.rhi.atlas import build_atlas as tatlas
    from zenith_tpu_torch.rhi.resource import Texture as TTexture
    from zenith_tpu_torch.rhi.shader import FragmentBuiltins as TBuiltins

    maps = _MAPS[case]
    flags = dict(use_normal="NormalAtlas" in maps, use_mra="MraAtlas" in maps,
                 use_emissive="EmissiveAtlas" in maps)
    h, w = 12, 16
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    vary = {"normal": np.broadcast_to(np.float32([0.1, 0.0, 1.0]), (h, w, 3)).copy(),
            "world_pos": np.stack([xs, ys * 1.5, xs * 0.1], -1).astype(np.float32),
            "uv": np.stack([xs / w, ys / h], -1).astype(np.float32)}
    front = np.ones((h, w), bool)
    front[:, :3] = False
    jres = {"BaseColor": jnp.asarray([0.9, 0.8, 0.7, 1.0]),
            "MatParams": jnp.asarray([0.5, 0.8, 2.0, 0.0])}
    tres = {"BaseColor": torch.tensor([0.9, 0.8, 0.7, 1.0]),
            "MatParams": torch.tensor([0.5, 0.8, 2.0, 0.0])}
    for name, (pixels, levels) in maps.items():
        ja = jatlas("a", [None if p is None else JTexture.from_numpy("t", p, JFormat.RGBA32F)
                          for p in pixels], mip_levels=levels)
        ta = tatlas("a", [None if p is None else TTexture.from_numpy("t", p, TFormat.RGBA32F,
                                                                      device=CPU)
                          for p in pixels], mip_levels=levels, device=CPU)
        np.testing.assert_array_equal(ta.transforms, ja.transforms)
        jres[name] = tuple(ja.texture.mips) if ja.texture.mips else ja.texture.array
        tres[name] = tuple(ta.texture.mips) if ta.texture.mips else ta.texture.array
        jres[jdef._UVX_NAME[name]] = jnp.asarray(ja.transforms[0])
        tres[tdef._UVX_NAME[name]] = torch.from_numpy(ta.transforms[0])
    jout = jdef._make_gbuffer_fs(True, **flags)(
        {k: jnp.asarray(v) for k, v in vary.items()}, jres,
        JBuiltins(frag_coord=jnp.zeros((h, w, 2)), depth=jnp.ones((h, w)),
                  front_facing=jnp.asarray(front), resolution=(w, h)))
    tout = tdef._make_gbuffer_fs(True, **flags)(
        {k: torch.from_numpy(v) for k, v in vary.items()}, tres,
        TBuiltins(frag_coord=torch.zeros((h, w, 2)), depth=torch.ones((h, w)),
                  front_facing=torch.from_numpy(front), resolution=(w, h)))
    assert sorted(tout) == ["0_albedo", "1_normal", "2_pos"]
    for k in tout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)
    if case == "mra":
        assert tout["0_albedo"][4, 4, 3] == pytest.approx(0.5 * 0.75, abs=1e-3)
    if case == "emissive":
        assert tout["2_pos"][4, 4, 3] == pytest.approx(2.0 * (0.7152 + 0.3 * 0.0722), abs=1e-3)


# -- sandbox textures, scenes and material uploads ----------------------------------


@pytest.mark.parametrize("name, args", [("checker_texture", (64, 8)),
                                        ("bump_normal_texture", (32, 4)),
                                        ("mra_stripe_texture", (32, 4)),
                                        ("brushed_texture", (32,))])
def test_sandbox_textures_equal_the_reference(name, args):
    import zenith_tpu.sandbox.scene as jscene

    kw = {"rng": np.random.default_rng(3)} if name == "brushed_texture" else {}
    jt = getattr(jscene, name)(*args, **kw)
    kw = {"rng": np.random.default_rng(3)} if name == "brushed_texture" else {}
    tt = getattr(tscene, name)(*args, device=CPU, **kw)
    assert tt.desc.format.value == jt.desc.format.value
    assert tt.desc.mip_levels == jt.desc.mip_levels
    for t, j in zip(tt.mips or [tt.array], jt.mips or [jt.array]):
        assert t.device == CPU
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_textured_standin_scene_draws_from_rng_in_build_scenes_order():
    """The brushed texture consumes the generator before the lights are
    placed, as build_scene's does; the ground carries build_scene's
    textured factors and maps."""
    dev = TCore(CPU).create_render_device()
    tex_scene, _ = tscene.build_standin_scene(dev, 6, np.random.default_rng(42), textured=True)
    rng = np.random.default_rng(42)
    rng.uniform(size=(256, 1))
    rng.uniform(size=(256, 256))  # brushed_texture(256)'s draws
    plain, _ = tscene.build_standin_scene(dev, 6, rng)
    for a, b in zip(tex_scene.point_lights, plain.point_lights):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    gun, ground = tex_scene.objects
    assert gun.base_color_texture.desc.name == "brushed" and gun.normal_texture is None
    assert (ground.metallic, ground.base_color) == (0.6, (0.9, 0.9, 0.95, 1.0))
    assert [t.desc.name for t in (ground.base_color_texture, ground.normal_texture,
                                  ground.mra_texture)] == ["checker", "bumps", "mra.stripes"]
    r = TDeferred(tex_scene)
    assert (r.textured, r.use_normal, r.use_mra, r.use_emissive) == (True, True, True, False)
    assert all(a.texture.array.device == CPU for a in r._atlases.values())


def _write_triangle_gltf(root: Path):
    from test_torch_asset import _write_gltf

    path = root / "content" / "mesh" / "cerberus"
    path.mkdir(parents=True)
    _write_gltf(path / "scene.gltf", with_image=False)


def test_build_scene_loads_content_and_raises_without_it(tmp_path, monkeypatch):
    from zenith_tpu_torch import asset

    asset.initialize()
    dev = TCore(CPU).create_render_device()
    monkeypatch.setenv("ZENITH_CONTENT", str(tmp_path))
    monkeypatch.setenv("ZENITH_CACHE", str(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError):
        tscene.build_scene(dev, 4, np.random.default_rng(0))
    _write_triangle_gltf(tmp_path)
    scene = tscene.build_scene(dev, 4, np.random.default_rng(0), textured=True, skybox=False)
    gun = scene.objects[0]
    assert gun.name == "cerberus" and gun.base_color_texture is not None
    assert scene.skybox is None and len(scene.point_lights) == 4
    # The skinned tentacle and the morphed blob are ported (item 21.9).
    animated = tscene.build_scene(dev, 4, np.random.default_rng(0), skinned=True,
                                  morph=True).objects
    assert [o.name for o in animated[-2:]] == ["tentacle", "blob"]
    assert animated[-2].skin is not None and animated[-1].morph_deltas is not None
    # The instanced rocks are ported.
    rocks = tscene.build_scene(dev, 4, np.random.default_rng(0), instances=3).objects[-1]
    assert rocks.name == "rocks" and rocks.instance_count == 3


def test_build_scene_equals_the_reference_from_the_baked_cache(monkeypatch):
    """The repository carries the cerberus mesh baked (cache/mesh/cerberus),
    so both packages' build_scene load it through their asset managers: the
    same mesh, lights, materials and textures (textured mode)."""
    import zenith_tpu.asset as jasset
    from zenith_tpu.rhi import RhiCore
    from zenith_tpu.sandbox.scene import build_scene as jbuild
    from zenith_tpu_torch import asset

    root = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(root)
    monkeypatch.setenv("ZENITH_CACHE", str(root / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    jasset.initialize()
    asset.initialize()
    jscene = jbuild(RhiCore().create_render_device(), 5, np.random.default_rng(42), textured=True)
    tscene_ = tscene.build_scene(TCore(CPU).create_render_device(), 5,
                                 np.random.default_rng(42), textured=True)
    for a, b in zip(tscene_.point_lights, jscene.point_lights):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    for t, j in zip(tscene_.objects, jscene.objects):
        assert (t.name, t.metallic, t.roughness, t.base_color, t.entry_budget) == \
            (j.name, j.metallic, j.roughness, j.base_color, j.entry_budget)
        np.testing.assert_array_equal(t.model_matrix, j.model_matrix)
        np.testing.assert_array_equal(t.vertex_buffer.array.numpy(),
                                      np.asarray(j.vertex_buffer.array))
        for field in ("base_color_texture", "normal_texture", "mra_texture"):
            tt, jt = getattr(t, field), getattr(j, field)
            assert (tt is None) == (jt is None)
            if tt is not None:
                np.testing.assert_array_equal(tt.host_linear(), np.asarray(jt.host_linear()))
    assert tscene_.objects[0].tri_count == 33543


def test_from_mesh_with_material_uploads_as_the_reference():
    """Colour and emissive maps sRGB with mips, normal and MRA linear, the
    normal map without mips; every level bit-equal to the reference's
    upload and on the caller's device."""
    from zenith_tpu.asset import AssetUrl as JUrl
    from zenith_tpu.asset import Material as JMaterial
    from zenith_tpu.asset import TextureAsset as JTex
    from zenith_tpu.renderer.scene import SceneObject as JObject
    from zenith_tpu.rhi import RhiCore
    from zenith_tpu_torch.renderer import SceneObject
    from zenith_tpu_torch.sandbox.scene import cube_mesh

    rng = np.random.default_rng(8)
    px = {s: rng.integers(0, 255, (16, 8, 4)).astype(np.uint8) for s in JMaterial._TEX_SLOTS}
    jmat = JMaterial(JUrl("m/cube.mat"), (0.9, 0.5, 0.3, 1.0), 0.25, 0.75, (0.5, 0.1, 0.0),
                     **{s: JTex(JUrl(f"m/{s}.tex"), p) for s, p in px.items()})
    tmat = interop.material_from(jmat)
    assert tmat.url.path == "m/cube.mat" and tmat.emissive_factor == (0.5, 0.1, 0.0)
    mesh = cube_mesh()
    from zenith_tpu.asset import Mesh as JMesh

    jobj = JObject.from_mesh_with_material(
        RhiCore().create_render_device(),
        JMesh(JUrl("m/cube.mesh"), mesh.vertices, mesh.indices), jmat, "cube")
    tobj = SceneObject.from_mesh_with_material(TCore(CPU).create_render_device(), mesh, tmat,
                                               "cube")
    assert (tobj.base_color, tobj.metallic, tobj.roughness, tobj.emissive) == \
        (jobj.base_color, jobj.metallic, jobj.roughness, jobj.emissive)
    for field, fmt, levels in (("base_color_texture", "rgba8_srgb", 4),
                               ("normal_texture", "rgba8_unorm", 1),
                               ("mra_texture", "rgba8_unorm", 4),
                               ("emissive_texture", "rgba8_srgb", 4)):
        t, j = getattr(tobj, field), getattr(jobj, field)
        assert (t.desc.format.value, t.desc.mip_levels) == (fmt, levels) == \
            (j.desc.format.value, j.desc.mip_levels)
        for a, b in zip(t.mips or [t.array], j.mips or [j.array]):
            assert a.device == CPU
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- frames -------------------------------------------------------------------------


def _port_frame(scene, camera, exports=()):
    device = TCore(CPU).create_render_device()
    renderer = TDeferred(scene)
    compiled, out, hdr, _ = tscene.deferred_frame(device, renderer, camera, W, H,
                                                  TOptions(tile_h=8, tile_w=128),
                                                  exports=("hdr",) + tuple(exports))
    img = encode_present(compiled.value(out), TFormat.RGBA8_SRGB).numpy()
    planes = {k: compiled.value(renderer.gbuffer_handles[k]).numpy() for k in exports}
    return renderer, img, compiled.value(hdr).numpy(), planes


def test_textured_frame_matches_the_golden():
    """tests/test_golden.py::_render_textured_frame through the port: the
    base atlas (brushed panel, checker ground), mip-mapped sampling."""
    scene, cam = tscene.textured_golden_scene(TCore(CPU).create_render_device())
    renderer, img, _, _ = _port_frame(scene, cam)
    assert renderer.textured and list(renderer._atlases) == ["BaseAtlas"]
    mx, frac = _lsb(img, np.load(GOLDEN))
    assert mx <= 1 and frac < 0.01, (mx, frac)


@pytest.fixture(scope="module")
def full_material_frames():
    """The reference's full-material-set scene (the golden's panel with an
    emissive map, a 100-unit ground with checker, bump normal and MRA maps,
    none of it near-clipped) rendered by the reference, and the same scene
    carried across by interop and rendered by the port."""
    from test_renderers import OPTS, make_camera

    from zenith_tpu.renderer import DeferredRenderer, DirectionalLight, PostProcess, Scene
    from zenith_tpu.renderer import SceneObject
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, Texture, TextureDesc
    from zenith_tpu.rhi import encode_present as jencode
    from zenith_tpu.sandbox.scene import (
        brushed_texture,
        bump_normal_texture,
        checker_texture,
        mra_stripe_texture,
    )

    device = RhiCore().create_render_device()
    ground = SceneObject.quad(device, "ground", size=100.0, z=0.0,
                              base_color=(0.9, 0.9, 0.95, 1.0), metallic=0.6, roughness=0.9,
                              base_color_texture=checker_texture(64, 8),
                              normal_texture=bump_normal_texture(64, 8),
                              mra_texture=mra_stripe_texture(64, 8))
    emissive = Texture.from_numpy("emissive.rings", tscene.emissive_pixels(64),
                                  Format.RGBA8_SRGB, generate_mips=True)
    panel = SceneObject.quad(device, "panel", size=30.0, z=12.0,
                             base_color=(0.9, 0.6, 0.4, 1.0), metallic=0.6, roughness=0.4,
                             base_color_texture=brushed_texture(64, rng=np.random.default_rng(7)),
                             emissive=(2.0, 2.0, 2.0), emissive_texture=emissive)
    scene = Scene(objects=[panel, ground],
                  sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.5,
                                       shadow_map_size=128, shadow_extent=60.0),
                  ambient=(0.05, 0.05, 0.05))
    renderer = DeferredRenderer(scene)
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    renderer.render_to(builder, hdr, make_camera(), W, H)
    PostProcess().render_to(builder, hdr, out)
    for h in (out, hdr, renderer.gbuffer_handles["pos"], renderer.gbuffer_handles["normal"]):
        builder.export(h)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    jax_frame = (np.asarray(jencode(compiled.value(out), Format.RGBA8_SRGB)),
                 np.asarray(compiled.value(hdr)),
                 np.asarray(compiled.value(renderer.gbuffer_handles["pos"])),
                 np.asarray(compiled.value(renderer.gbuffer_handles["normal"])))
    port_scene = interop.scene_from(scene, CPU)
    return port_scene, jax_frame, _port_frame(port_scene, make_camera(), ("pos", "normal"))


def _ground_hits(cam, h, w):
    """Each pixel centre's camera ray hit with the z = 0 plane, in float64."""
    ys, xs = np.mgrid[0:h, 0:w]
    ndc = np.stack([(xs + 0.5) / w * 2 - 1, (ys + 0.5) / h * 2 - 1,
                    np.full(xs.shape, 0.5), np.ones(xs.shape)], -1)
    p = ndc @ np.asarray(cam.render_inv_view_projection, np.float64).T
    eye = np.asarray(cam.location, np.float64)
    d = p[..., :3] / p[..., 3:4] - eye
    return eye + (-eye[2] / d[..., 2])[..., None] * d


def _normal_shift_from_positions(pos_a, pos_b, ground):
    """How far perturb_normal's result moves between two position planes
    alone: the same up normal, UV (the ground's, from ``pos_b``) and tilted
    map sample, over ground pixels whose right and lower neighbours are
    ground too."""
    a = torch.from_numpy(np.ascontiguousarray(pos_a[..., :3]))
    b = torch.from_numpy(np.ascontiguousarray(pos_b[..., :3]))
    n = torch.zeros_like(b)
    n[..., 2] = 1.0
    uv = b[..., :2] / 100.0 + 0.5
    sample = torch.tensor([0.8, 0.3, 0.7]).expand_as(b)
    d = (tshade.perturb_normal(n, a, uv, sample) - tshade.perturb_normal(n, b, uv, sample)).abs()
    inner = ground.copy()
    inner[:-1] &= ground[1:]
    inner[:, :-1] &= ground[:, 1:]
    return float(d.numpy()[inner].max())


def test_full_material_frame_matches_the_reference(full_material_frames):
    from test_renderers import make_camera

    port_scene, (jimg, jhdr, jpos, jnormal), (renderer, img, hdr, planes) = full_material_frames
    assert (renderer.textured, renderer.use_normal, renderer.use_mra,
            renderer.use_emissive) == (True, True, True, True)
    assert list(renderer._atlases) == ["BaseAtlas", "NormalAtlas", "MraAtlas", "EmissiveAtlas"]
    mx, frac = _lsb(img, jimg)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    # The ground (z = 0, the normal-mapped surface) and everything else.
    ground = (np.abs(jpos[..., 2]) < 1e-3) & (np.abs(jpos).sum(-1) > 0)
    assert 0.3 < ground.mean() < 0.9
    np.testing.assert_allclose(hdr[~ground], jhdr[~ground], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(planes["normal"][ground], jnormal[ground], atol=1e-4)
    np.testing.assert_allclose(hdr[ground], jhdr[ground], atol=1e-3, rtol=1e-3)
    # The looser limits' reason: the ground's positions differ by rounding
    # only (both near the float64 ray cast), and that difference alone, through
    # the map's tangent frame, moves the normal past 1e-5.
    hit = _ground_hits(make_camera(), H, W)
    np.testing.assert_allclose(planes["pos"][..., :3][ground], hit[ground], atol=1e-4, rtol=0)
    np.testing.assert_allclose(jpos[..., :3][ground], hit[ground], atol=1e-4, rtol=0)
    assert np.abs(planes["pos"][ground] - jpos[ground]).max() > 1e-5
    assert _normal_shift_from_positions(planes["pos"], jpos, ground) > 1e-5
    # The maps really act: the normal map bends the ground's normals and the
    # emissive map lights the panel.
    n = planes["normal"][ground][:, :3]
    assert (np.abs(n[:, 0]) > 0.1).mean() > 0.05
    panel = np.abs(jpos[..., 2] - 12.0) < 1e-3
    emissive = planes["pos"][panel][:, 3]
    assert panel.mean() > 0.02 and emissive.max() > 0.5 and emissive.std() > 0.1


def test_carried_textures_keep_their_mips(full_material_frames):
    port_scene = full_material_frames[0]
    panel, ground = port_scene.objects
    assert panel.base_color_texture.desc.mip_levels == 7 and len(panel.base_color_texture.mips) == 7
    assert ground.normal_texture.mips is None and ground.mra_texture.mips is None
    assert panel.emissive_texture.desc.mip_levels == 7
    assert ground.base_color_texture.array.device == CPU


def test_textured_glass_over_untextured_opaque_keeps_the_opaque_pass_untextured():
    """The divergence of ROADMAP §3 ("Glass"): the reference's opaque pass
    samples the white fallback cells when only a translucent object carries a
    map; the port's stays untextured (the same frame, held by
    tests/test_torch_glass.py). An opaque map turns textured mode on, and
    the atlases are then built over every object, as the reference's."""
    from zenith_tpu_torch.renderer import Scene, SceneObject

    dev = TCore(CPU).create_render_device()
    tex = tscene.checker_texture(16, 4, device=CPU)
    pane = SceneObject.quad(dev, "pane", translucent=True, base_color=(1, 1, 1, 0.5),
                            base_color_texture=tex, normal_texture=tex)
    ground = SceneObject.quad(dev, "ground")
    assert not TDeferred(Scene(objects=[ground, pane])).textured
    r = TDeferred(Scene(objects=[dataclasses.replace(ground, mra_texture=tex), pane]))
    assert (r.textured, r.use_normal, r.use_mra) == (True, True, True)
    assert r._atlases["BaseAtlas"].transforms.shape == (2, 4)


@pytest.fixture(scope="module")
def mesh_frames():
    """MeshRenderer on a checker-textured cube over the reference's
    test_renderers.py camera, in both packages (8x128 tiles). The renderer
    samples level 0 bilinearly (``sample_2d``), so the texture has no
    mips."""
    from test_renderers import OPTS, make_camera, make_cube

    from zenith_tpu.renderer.mesh import MeshRenderer as JMesh
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, Texture, TextureDesc
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder as TBuilder
    from zenith_tpu_torch.renderer import MeshRenderer
    from zenith_tpu_torch.rhi import PipelineCache as TCache, Texture as TTexture
    from zenith_tpu_torch.rhi import TextureDesc as TDesc

    yy, xx = np.mgrid[0:32, 0:32]
    cell = ((xx // 4 + yy // 4) % 2).astype(np.uint8)
    checker = np.stack([200 - 110 * cell, 202 - 110 * cell, 208 - 104 * cell,
                        np.full_like(cell, 255)], -1).astype(np.uint8)
    cube = make_cube(size=16.0, z0=4.0)
    model = np.array([[0.8, -0.6, 0, 0], [0.6, 0.8, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                     np.float32)
    jdev = RhiCore().create_render_device()
    jr = JMesh(jdev, cube, base_color_factor=(0.9, 0.8, 0.7, 1.0),
               base_color_texture=Texture.from_numpy("checker", checker, Format.RGBA8_SRGB),
               model_matrix=model)
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("c", W, H, Format.RGBA32F))
    depth = builder.create(TextureDesc.depth("d", W, H))
    jr.render_to(builder, color, depth, make_camera())
    builder.export(color)
    compiled = builder.build().compile(jdev, PipelineCache(), OPTS)
    compiled.execute(jdev)
    jcolor = np.asarray(compiled.value(color))

    tdev = TCore(CPU).create_render_device()
    from zenith_tpu_torch.asset import AssetUrl, Mesh

    tcube = Mesh(AssetUrl(str(cube.url)), cube.vertices, cube.indices)
    tr = MeshRenderer(tdev, tcube, base_color_factor=(0.9, 0.8, 0.7, 1.0),
                      base_color_texture=TTexture.from_numpy("checker", checker,
                                                             TFormat.RGBA8_SRGB, device=CPU),
                      model_matrix=model)
    tb = TBuilder()
    tcolor = tb.create(TDesc.color("c", W, H, TFormat.RGBA32F))
    tdepth = tb.create(TDesc.depth("d", W, H))
    tr.render_to(tb, tcolor, tdepth, make_camera())
    tb.export(tcolor)
    from zenith_tpu_torch.ops.raster import raster_segmented

    launches = raster_segmented.launches
    tc = tb.build().compile(tdev, TCache(), TOptions(tile_h=8, tile_w=128))
    tc.execute(tdev)
    return jcolor, tc.value(tcolor).numpy(), raster_segmented.launches - launches


def test_mesh_renderer_matches_the_reference(mesh_frames):
    jcolor, tcolor, launches = mesh_frames
    assert launches == 0  # CPU tensors take the plain version, not the kernel
    np.testing.assert_allclose(tcolor, jcolor, atol=1e-5, rtol=1e-5)
    mx, frac = _lsb(encode_present(torch.from_numpy(tcolor), TFormat.RGBA8_SRGB).numpy(),
                    encode_present(torch.tensor(jcolor), TFormat.RGBA8_SRGB).numpy())
    assert mx <= 1 and frac < 0.01
    covered = np.abs(tcolor[..., :3] - np.float32([0.05, 0.06, 0.08])).sum(-1) > 1e-3
    assert 0.05 < covered.mean() < 0.8  # the cube is drawn, textured and lit
    assert tcolor[covered][:, :3].std() > 0.05

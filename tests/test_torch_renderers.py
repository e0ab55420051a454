"""tests/test_renderers.py on the port: the feature renderers' twelve cases
(the shadowed forward renderer, its MSAA and wireframe, the deferred
renderer's skybox, point lights, background, wireframe and textured
G-buffer, the post chain's bounds and bloom, and visibility toggled with
and without a rebuild), each with the reference's own semantic checks on
the port's frames. The scene is built by the same translation of
test_renderers.build_test_scene on the port's API (a cube over a ground
quad, a sun with a 128² shadow map), and two frames are held against the
reference package's on the same scene: the shadowed forward frame and the
deferred frame with 8 point lights.

Tolerances: the reference's own (each check states it); against the JAX
frames the encoded frame ≤ 1 LSB with < 1% of values differing (the golden
tolerance: the near-clipped ground's positions differ by XLA's FMA
contraction, ROADMAP §3).
"""

import math

import numpy as np
import pytest
import torch

from zenith_tpu_torch.asset import AssetUrl
from zenith_tpu_torch.asset.render_types import Mesh as MeshAsset
from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.core.mathtypes import Degree, Radians
from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
from zenith_tpu_torch.renderer import (
    DeferredRenderer,
    DirectionalLight,
    ForwardShadowRenderer,
    PointLight,
    PostProcess,
    Scene,
    SceneObject,
)
from zenith_tpu_torch.rhi import (
    Format,
    PipelineCache,
    RhiCore,
    Texture,
    TextureDesc,
    encode_present,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)


def make_cube(size=10.0, z0=10.0):
    """test_renderers.make_cube: an axis-aligned cube as a Mesh asset (z-up
    world), wound CW-on-screen."""
    s = size / 2.0
    cz = z0 + s
    faces, idx = [], []
    defs = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(-s, s, -s), (s, s, -s), (s, -s, -s), (-s, -s, -s)]),
        ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
        ((-1, 0, 0), [(-s, s, -s), (-s, -s, -s), (-s, -s, s), (-s, s, s)]),
        ((0, 1, 0), [(s, s, -s), (-s, s, -s), (-s, s, s), (s, s, s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    for f, (n, quad) in enumerate(defs):
        base = 4 * f
        for px, py, pz in quad:
            faces.append([px, py, pz + cz, *n, 0.0, 0.0])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return MeshAsset(AssetUrl("test/cube.mesh"), np.asarray(faces, np.float32),
                     np.asarray(idx, np.int32))


@pytest.fixture
def device():
    return RhiCore(CPU).create_render_device()


def make_camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def build_test_scene(device, num_lights=0, sun_intensity=2.5):
    cube = SceneObject.from_mesh(
        device, make_cube(size=14.0, z0=8.0), "cube",
        base_color=(0.8, 0.2, 0.2, 1.0), metallic=0.0, roughness=0.5, bin_capacity=64,
    )
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0,
                              base_color=(0.4, 0.4, 0.4, 1.0), roughness=0.9)
    lights = [
        PointLight(position=(20.0 * math.cos(a), 20.0 * math.sin(a), 12.0),
                   color=(1.0, 0.8, 0.5), intensity=300.0, radius=60.0)
        for a in np.linspace(0, 2 * math.pi, num_lights, endpoint=False)
    ]
    return Scene(
        objects=[cube, ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=sun_intensity,
                             shadow_map_size=128, shadow_extent=60.0),
        point_lights=lights,
        ambient=(0.05, 0.05, 0.05),
    )


def run_graph(device, build_fn):
    builder = RenderGraphBuilder()
    out_handle = build_fn(builder)
    builder.export(out_handle)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return compiled.value(out_handle).numpy()


def _jax_frame(kind, num_lights=0, sun_intensity=2.5):
    """The reference's frame of test_renderers' scene: "forward" (the
    shadowed forward renderer) or "deferred"."""
    import test_renderers as tr

    from zenith_tpu.rhi import RhiCore as JCore

    device = JCore().create_render_device()
    scene = tr.build_test_scene(device, num_lights=num_lights, sun_intensity=sun_intensity)
    cam = tr.make_camera()

    def build(builder):
        color = builder.create(tr.TextureDesc.color("rt", W, H))
        if kind == "forward":
            depth = builder.create(tr.TextureDesc.depth("ds", W, H))
            tr.ForwardShadowRenderer(scene).render_to(builder, color, depth, cam)
        else:
            tr.DeferredRenderer(scene).render_to(builder, color, cam, W, H)
        return color

    return tr.run_graph(device, build)


def _assert_lsb(img, jimg):
    enc = [encode_present(torch.from_numpy(np.array(a)), Format.RGBA8_SRGB).numpy()
           for a in (img, jimg)]
    d = np.abs(enc[0].astype(np.int16) - enc[1].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def _px_of(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


# -- TestForwardShadow -----------------------------------------------------------------


def test_shadow_darkens_occluded_ground(device):
    scene = build_test_scene(device)
    renderer = ForwardShadowRenderer(scene)
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        depth = builder.create(TextureDesc.depth("ds", W, H))
        renderer.render_to(builder, color, depth, cam)
        return color

    img = run_graph(device, build)
    assert img.shape == (H, W, 4)
    # Ground under the cube (shadowed) vs ground to the side at similar
    # depth (lit).
    sy, sx = _px_of(cam, (0.0, 0.0, 0.0))
    ly, lx = _px_of(cam, (40.0, 0.0, 0.0))
    assert img[ly, lx, :3].sum() > img[sy, sx, :3].sum() * 1.5
    _assert_lsb(img, _jax_frame("forward"))


def test_cube_visible_and_background_clear(device):
    scene = build_test_scene(device)
    renderer = ForwardShadowRenderer(scene)
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        depth = builder.create(TextureDesc.depth("ds", W, H))
        renderer.render_to(builder, color, depth, cam, clear_color=(0, 0, 1, 1))
        return color

    img = run_graph(device, build)
    # Sky (top rows) = clear blue; cube (centre) = reddish.
    np.testing.assert_allclose(img[2, 2, :3], [0, 0, 1], atol=1e-5)
    center = img[H // 2, W // 2, :3]
    assert center[0] > center[2]


def test_forward_msaa_softens_silhouettes_only(device):
    """ForwardShadowRenderer(msaa=4): silhouette pixels change, the
    interior stays put."""
    scene = build_test_scene(device)
    cam = make_camera()

    def render(renderer):
        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            renderer.render_to(builder, color, depth, cam)
            return color

        return run_graph(device, build)

    img1 = render(ForwardShadowRenderer(scene))
    img4 = render(ForwardShadowRenderer(scene, msaa=4))
    assert np.isfinite(img4).all()
    changed = np.abs(img4[..., :3] - img1[..., :3]).max(axis=-1) > 5e-3
    assert changed.any(), "4x MSAA changed nothing"
    assert changed.mean() < 0.15, changed.mean()


# -- TestWireframe ------------------------------------------------------------------------


def test_forward_wireframe_outlines_only(device):
    scene = build_test_scene(device)
    cam = make_camera()

    def build_with(renderer):
        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            renderer.render_to(builder, color, depth, cam, clear_color=(0, 0, 1, 1))
            return color
        return build

    filled = run_graph(device, build_with(ForwardShadowRenderer(scene)))
    wire = run_graph(device, build_with(ForwardShadowRenderer(scene, wireframe=True)))
    filled_cube = (filled[..., 0] > filled[..., 2]).sum()
    wire_cube = (wire[..., 0] > wire[..., 2]).sum()
    assert 0 < wire_cube < 0.6 * filled_cube, (wire_cube, filled_cube)
    c = wire[H // 2, W // 2, :3]
    assert c[2] > c[0]  # the face centre shows the clear colour


def test_deferred_wireframe_outlines_only(device):
    scene = build_test_scene(device, num_lights=2)
    cam = make_camera()

    def build_with(renderer):
        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            return color
        return build

    filled = run_graph(device, build_with(DeferredRenderer(scene)))
    wire = run_graph(device, build_with(DeferredRenderer(scene, wireframe=True)))
    filled_lum, wire_lum = filled[..., :3].sum(-1), wire[..., :3].sum(-1)
    bg = filled_lum[2, 2]
    filled_cov = (filled_lum > bg + 0.05).sum()
    wire_cov = (wire_lum > bg + 0.05).sum()
    assert 0 < wire_cov < 0.6 * filled_cov, (wire_cov, filled_cov)


# -- TestDeferred -----------------------------------------------------------------------


def test_skybox_background_cube_sampled(device):
    """Background pixels sample the scene's cube map by view ray."""
    from zenith_tpu_torch.ops.sampling import sample_cube

    faces = np.zeros((6, 8, 8, 4), np.float32)
    for f in range(6):
        faces[f, :, :, :3] = (f + 1) / 6.0 * np.array([1.0, 0.5, 0.25], np.float32)
        faces[f, :, :, f % 3] = 1.0
    sky = Texture.from_numpy_layers("sky", faces, Format.RGBA32F, cube=True, device=CPU)
    scene = build_test_scene(device, sun_intensity=0.0)
    scene.skybox = sky
    renderer = DeferredRenderer(scene, shadows=False)
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        renderer.render_to(builder, color, cam, W, H)
        return color

    img = run_graph(device, build)
    inv_vp = np.linalg.inv(np.asarray(cam.render_view_projection, np.float64))
    px, py = 2, 2
    p = inv_vp @ np.array([(px + 0.5) / W * 2 - 1, (py + 0.5) / H * 2 - 1, 0.5, 1.0])
    d = (p[:3] / p[3]) - np.asarray(cam.location, np.float64)
    expected = sample_cube(torch.from_numpy(faces),
                           torch.tensor(d[None, :], dtype=torch.float32)).numpy()[0]
    np.testing.assert_allclose(img[py, px, :3], expected[:3], atol=1e-4)


def test_point_lights_add_energy(device):
    cam = make_camera()

    def render(num_lights):
        renderer = DeferredRenderer(build_test_scene(device, num_lights=num_lights,
                                                     sun_intensity=0.5))

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            return color

        return run_graph(device, build)

    img0, img8 = render(0), render(8)
    assert img8[..., :3].sum() > img0[..., :3].sum() * 1.2
    np.testing.assert_allclose(img0[2, 2, :3], img8[2, 2, :3], atol=1e-5)
    _assert_lsb(img8, _jax_frame("deferred", num_lights=8, sun_intensity=0.5))


def test_gbuffer_background_vs_coverage(device):
    renderer = DeferredRenderer(build_test_scene(device), shadows=False)
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        renderer.render_to(builder, color, cam, W, H, background=(1, 0, 1))
        return color

    img = run_graph(device, build)
    np.testing.assert_allclose(img[1, 1, :3], [1, 0, 1], atol=1e-5)
    assert not np.allclose(img[H // 2, W // 2, :3], [1, 0, 1])


# -- TestPost -------------------------------------------------------------------------------


def test_tonemap_bounds_and_bloom(device):
    hdr = np.zeros((H, W, 4), np.float32)
    hdr[..., 3] = 1.0
    hdr[H // 2, W // 2, :3] = 50.0
    hdr[:, :, :3] += 0.2
    tex = Texture(TextureDesc.color("hdr", W, H), torch.from_numpy(hdr))

    def build(builder):
        src = builder.import_resource(tex)
        dst = builder.create(TextureDesc.color("ldr", W, H))
        PostProcess().render_to(builder, src, dst)
        return dst

    img = run_graph(device, build)
    assert img[..., :3].max() <= 1.0 + 1e-5
    # The hot pixel's neighbour picked up bloom, far away did not.
    assert img[H // 2 + 3, W // 2, :3].sum() > img[4, 8, :3].sum() + 1e-3


# -- TestTexturedDeferred ---------------------------------------------------------------------


def test_checker_albedo_modulates(device):
    """A UV-checkered ground modulates the albedo through import → bind →
    sample."""
    n = 64
    yy, xx = np.mgrid[0:n, 0:n]
    cell = (((yy // 2) + (xx // 2)) % 2).astype(np.uint8)
    px = np.zeros((n, n, 4), np.uint8)
    px[..., :3] = (cell * 255)[..., None]
    px[..., 3] = 255
    checker = Texture.from_numpy("chk", px, Format.RGBA8_UNORM, device=CPU)
    white = Texture.from_numpy("white", np.full((1, 1, 4), 255, np.uint8), Format.RGBA8_UNORM,
                               device=CPU)
    cube = SceneObject.from_mesh(device, make_cube(size=14.0, z0=8.0), "cube",
                                 base_color=(1, 1, 1, 1), bin_capacity=64,
                                 base_color_texture=white)
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0, base_color=(1, 1, 1, 1),
                              base_color_texture=checker)
    scene = Scene(objects=[cube, ground],
                  sun=DirectionalLight(direction=(0.0, 0.0, 1.0), intensity=2.0,
                                       cast_shadows=False),
                  ambient=(0.1, 0.1, 0.1))
    renderer = DeferredRenderer(scene, shadows=False)
    assert renderer.textured
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        renderer.render_to(builder, color, cam, W, H)
        return color

    img = run_graph(device, build)
    row = img[H - 6, :, :3].sum(-1)
    ground_px = row[row > 0.01]
    assert ground_px.std() > 0.2 * ground_px.mean()


# -- TestVisibilityToggle ---------------------------------------------------------------------


def test_hide_without_recompile(device):
    """SceneObject.visible=False removes the object and its shadow without
    a new frame function: visibility rides the model-matrix dynamic."""
    from zenith_tpu_torch.rendergraph import frame_program_cache_size

    scene = build_test_scene(device)
    renderer = DeferredRenderer(scene)
    cam = make_camera()

    def build(builder):
        color = builder.create(TextureDesc.color("rt", W, H))
        renderer.render_to(builder, color, cam, W, H)
        return color

    shown = run_graph(device, build)
    programs = frame_program_cache_size()
    scene.objects[0].visible = False
    hidden = run_graph(device, build)
    assert frame_program_cache_size() == programs
    scene.objects[0].visible = True
    shown_again = run_graph(device, build)
    assert frame_program_cache_size() == programs
    cy, cx = H // 2, W // 2
    assert not np.allclose(shown[cy, cx], hidden[cy, cx])
    np.testing.assert_allclose(shown_again, shown, atol=1e-6)
    # The cube's shadow on the ground is gone too.
    sy, sx = _px_of(cam, (0.0, 0.0, 0.0))
    assert hidden[sy, sx, :3].sum() > shown[sy, sx, :3].sum() * 1.2
    assert np.isfinite(hidden).all()


def test_retained_visibility_via_models_dynamic(device):
    """Retained execution: frame_dynamics(include_models=True) carries
    visibility through the stacked model-matrix dynamic; the same compiled
    frame function re-runs with the object hidden."""
    scene = build_test_scene(device)
    renderer = DeferredRenderer(scene)
    cam = make_camera()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    builder.export(color)
    renderer.render_to(builder, color, cam, W, H)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    shown = compiled.value(color).numpy()
    scene.objects[0].visible = False
    compiled.execute(device, dynamics=renderer.frame_dynamics(cam, include_models=True))
    hidden = compiled.value(color).numpy()
    cy, cx = H // 2, W // 2
    assert not np.allclose(shown[cy, cx], hidden[cy, cx])
    assert np.isfinite(hidden).all()

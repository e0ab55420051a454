"""Instancing in the port against the reference package: twins of
tests/test_instancing.py's five cases. TestInstancedScene's deferred cases
(the ``shadow.inst`` and ``gbuffer.inst`` nodes) on test_renderers.py's
cube and ground at 128×64, the scenes built by the reference and carried
across by zenith_tpu_torch.interop; its forward case (``shadow.inst`` and
``forward.inst``) and TestInstancing's two ``draw_indexed`` cases on the
port alone, with the reference's own oracle (N instances equal N separate
draws or objects).

Tolerances: the reference's own between instanced and separate objects
(HDR atol 2e-3; depth equal and colour atol 2e-6 between one instanced
draw and separate draws); against the JAX frame, the encoded frame ≤ 1 LSB with < 1%
of values differing (the golden tolerance) and the HDR at test_torch_
deferred.py's rtol 1e-2 / atol 1e-3 (world positions on the near-clipped
ground round apart, ROADMAP §3 "FMA").
"""

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.rendergraph import RenderGraphBuilder as TBuilder
from zenith_tpu_torch.rhi import Format as TFormat
from zenith_tpu_torch.rhi import PipelineCache as TCache
from zenith_tpu_torch.rhi import RhiCore as TCore
from zenith_tpu_torch.rhi import TextureDesc as TDesc
from zenith_tpu_torch.rhi import encode_present

torch.set_num_threads(1)
CPU = torch.device("cpu")
OFFSETS = np.array([[-18.0, 0.0, 0.0], [0.0, 6.0, 0.0], [18.0, 0.0, 4.0]], np.float32)


def _jax_scenes():
    """The reference test's three scenes: one instanced cube, the same
    cubes as three objects (each over the ground), and an all-instanced
    scene with no plain object."""
    from test_renderers import make_cube

    from zenith_tpu.core import mathtypes as m
    from zenith_tpu.renderer import DirectionalLight, Scene, SceneObject
    from zenith_tpu.rhi import RhiCore

    device = RhiCore().create_render_device()
    cube_kwargs = dict(base_color=(0.8, 0.25, 0.2, 1.0), metallic=0.1, roughness=0.5,
                       bin_capacity=64)
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0,
                              base_color=(0.4, 0.4, 0.42, 1.0), roughness=0.9)
    sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.5, shadow_map_size=128,
                           shadow_extent=70.0)
    inst = SceneObject.from_mesh(device, make_cube(size=8.0, z0=4.0), "cube",
                                 instance_offsets=OFFSETS, **cube_kwargs)
    separate = [SceneObject.from_mesh(device, make_cube(size=8.0, z0=4.0), f"cube{k}",
                                      model_matrix=m.mat4_translation(OFFSETS[k]),
                                      **cube_kwargs)
                for k in range(3)]
    only = SceneObject.from_mesh(
        device, make_cube(size=10.0, z0=2.0), "only", base_color=(0.7, 0.3, 0.2, 1.0),
        bin_capacity=64, instance_offsets=np.array([[-12.0, 0.0, 0.0], [12.0, 0.0, 0.0]],
                                                   np.float32))
    only_sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.0, shadow_map_size=128,
                                shadow_extent=60.0)
    return {
        "instanced": Scene(objects=[inst, ground], sun=sun, ambient=(0.05,) * 3),
        "separate": Scene(objects=[*separate, ground], sun=sun, ambient=(0.05,) * 3),
        "all-instanced": Scene(objects=[only], sun=only_sun, ambient=(0.1,) * 3),
    }


def _jax_frame(scene):
    from test_renderers import H, OPTS, W, make_camera

    from zenith_tpu.renderer import DeferredRenderer
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

    device = RhiCore().create_render_device()
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("rt", W, H))
    builder.export(out)
    DeferredRenderer(scene).render_to(builder, out, make_camera(), W, H)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(compiled.value(out))


def _port_frame(scene, camera, renderer=None):
    """The port's HDR frame and the names of its nodes."""
    device = TCore(CPU).create_render_device()
    renderer = renderer or TDeferred(scene)
    builder = TBuilder()
    out = builder.create(TDesc.color("rt", 128, 64))
    builder.export(out)
    renderer.render_to(builder, out, camera, 128, 64)
    nodes = [n.name for n in builder.nodes]
    compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    return compiled.value(out).numpy(), nodes


@pytest.fixture(scope="module")
def frames():
    from test_renderers import make_camera

    jscenes = _jax_scenes()
    out = {}
    for name, jscene in jscenes.items():
        port, nodes = _port_frame(interop.scene_from(jscene, CPU), make_camera())
        out[name] = {"port": port, "nodes": nodes}
        if name != "separate":  # the oracle of the instanced frame, on the port
            out[name]["jax"] = _jax_frame(jscene)
    return out


def _lsb(a, b):
    ea, eb = (encode_present(torch.from_numpy(np.array(x)), TFormat.RGBA8_SRGB).numpy()
              .astype(np.int16) for x in (a, b))
    d = np.abs(ea - eb)
    return int(d.max()), float((d > 0).mean())


def test_instanced_deferred_matches_separate_objects(frames):
    """One object with three instance offsets renders as three separate
    objects at translated model matrices (the reference's oracle)."""
    inst, sep = frames["instanced"]["port"], frames["separate"]["port"]
    assert inst[..., :3].std() > 0.02  # cubes visible
    np.testing.assert_allclose(inst, sep, atol=2e-3)
    assert frames["instanced"]["nodes"] == ["shadow", "shadow.inst", "gbuffer", "gbuffer.inst",
                                            "lighting"]


@pytest.mark.parametrize("name", ["instanced", "all-instanced"])
def test_frame_matches_the_jax_frame(frames, name):
    port, ref = frames[name]["port"], frames[name]["jax"]
    assert port.shape == ref.shape == (64, 128, 4)
    mx, frac = _lsb(port, ref)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    np.testing.assert_allclose(port, ref, rtol=1e-2, atol=1e-3)


def test_all_instanced_scene_renders(frames):
    """A scene whose only object is instanced clears the plain passes and
    draws the instances (reference regression: an empty batch)."""
    assert frames["all-instanced"]["port"][..., :3].std() > 0.01


def test_retained_frame_with_moved_instances_equals_a_rebuild():
    """``frame_dynamics(include_models=True)`` carries the instance
    offsets: a retained frame after the instances moved equals a rebuild."""
    from test_renderers import make_camera

    scene = interop.scene_from(_jax_scenes()["instanced"], CPU)
    renderer = TDeferred(scene)
    device = TCore(CPU).create_render_device()
    builder = TBuilder()
    out = builder.create(TDesc.color("rt", 128, 64))
    builder.export(out)
    cam = make_camera()
    renderer.render_to(builder, out, cam, 128, 64)
    compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    first = compiled.value(out).clone()
    scene.objects[0].instance_offsets = OFFSETS + np.float32([0.0, 0.0, 6.0])
    compiled.execute(device, dynamics=renderer.frame_dynamics(cam, include_models=True))
    moved = compiled.value(out).numpy()
    assert not np.array_equal(moved, first.numpy())
    rebuilt, _ = _port_frame(scene, cam)
    np.testing.assert_array_equal(moved, rebuilt)


def test_device_resident_offsets_need_the_unported_velocity_plane():
    """With velocity=None the renderer turns its velocity plane on for
    instance offsets held as a device tensor, which animate the scene, and
    leaves it off for host offsets (reference deferred.py:598-604)."""
    scene = interop.scene_from(_jax_scenes()["instanced"], CPU)
    assert not TDeferred(scene).velocity
    scene.objects[0].instance_offsets = torch.from_numpy(OFFSETS)
    renderer = TDeferred(scene)
    assert renderer.velocity and renderer.scene_animated


def _inst_pipeline(vs, fs, depth: bool):
    from zenith_tpu_torch.rhi import Format, Shader
    from zenith_tpu_torch.rhi.pipeline import (
        GraphicPipeline,
        GraphicPipelineDesc,
        GraphicShaderInput,
    )
    from zenith_tpu_torch.rhi.state import (
        ColorAttachmentDesc,
        CullMode,
        DepthStencilDesc,
        GraphicPipelineAttachments,
        GraphicPipelineState,
        RasterizationState,
        VertexLayout,
    )

    return GraphicPipeline(GraphicPipelineDesc(
        shader_input=GraphicShaderInput(Shader.vertex(f"{vs.__name__}.vs", vs),
                                        Shader.fragment("inst.fs", fs),
                                        VertexLayout.from_fields(("position", 4))),
        state=GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z() if depth else DepthStencilDesc()),
        attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,),
                                               depth_format=Format.D32F if depth else None),
        color_attachment_descs=(ColorAttachmentDesc(),),
    ))


def _inst_fs(varyings, res, builtins):
    c = varyings["color"]
    return torch.cat([c, torch.ones_like(c[..., :1])], -1)


def test_instanced_equals_separate_draws():
    """TestInstancing::test_instanced_equals_separate_draws: five instances
    through one draw (per-instance offset and colour) equal five separate
    draws with the offsets baked in."""
    from zenith_tpu_torch.ops import TileGrid, clear_color, clear_depth
    from zenith_tpu_torch.ops.draw import draw_indexed

    grid = TileGrid(width=128, height=32, tile_h=8, tile_w=128)

    def vs(attrs, res):
        p = attrs["position"]
        off = attrs.get("offset", torch.zeros((p.shape[0], 4)))
        col = attrs.get("inst_color", torch.ones((p.shape[0], 3)))
        return {"position": p + off, "color": col}

    pipeline = _inst_pipeline(vs, _inst_fs, depth=True)
    vb = torch.tensor([[-0.15, -0.3, 0.5, 1.0], [0.15, 0.3, 0.5, 1.0],
                       [-0.15, 0.3, 0.5, 1.0]])
    ib = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    n_inst = 5
    offs = np.zeros((n_inst, 4), np.float32)
    offs[:, 0] = np.linspace(-0.7, 0.7, n_inst)  # spread along x
    offs[:, 2] = np.linspace(0.1, 0.3, n_inst)  # distinct depths
    cols = np.eye(3)[np.arange(n_inst) % 3].astype(np.float32)

    colors, depth, stats = draw_indexed(
        [clear_color(32, 128, (0, 0, 0, 1), CPU)], clear_depth(32, 128, 0.0, CPU), pipeline,
        vb, ib, {}, grid, instance_count=n_inst,
        instance_data={"offset": torch.from_numpy(offs), "inst_color": torch.from_numpy(cols)})
    inst_img, inst_z = colors[0].numpy(), depth.numpy()
    assert int(stats.bin_overflow) == 0

    colors = [clear_color(32, 128, (0, 0, 0, 1), CPU)]
    depth = clear_depth(32, 128, 0.0, CPU)
    for i in range(n_inst):
        def vs_i(attrs, res, c=cols[i]):
            p = attrs["position"]
            return {"position": p, "color": torch.from_numpy(c).expand(p.shape[0], 3)}

        colors, depth, _ = draw_indexed(colors, depth, _inst_pipeline(vs_i, _inst_fs, True),
                                        vb + torch.from_numpy(offs[i])[None, :], ib, {}, grid)
    np.testing.assert_array_equal(inst_z, depth.numpy())
    np.testing.assert_allclose(inst_img, colors[0].numpy(), atol=2e-6)
    assert (inst_img[..., 0] > 0.5).any() and (inst_img[..., 1] > 0.5).any()


def test_instance_index_builtin():
    """TestInstancing::test_instance_index_builtin: the gl_InstanceIndex
    analog reaches the vertex stage (instance 1, red, sits right of
    instance 0, green)."""
    from zenith_tpu_torch.ops import TileGrid, clear_color
    from zenith_tpu_torch.ops.draw import draw_indexed

    def vs(attrs, res):
        p = attrs["position"]
        ii = attrs["instance_index"]  # (Nv, 1)
        return {"position": p + torch.cat([ii * 0.4 - 0.4, torch.zeros_like(p[:, :3])], 1),
                "color": torch.cat([ii, 1.0 - ii, torch.zeros_like(ii)], -1)
                .expand(p.shape[0], 3)}

    vb = torch.tensor([[0.0, -0.4, 0.5, 1.0], [0.2, 0.4, 0.5, 1.0], [-0.2, 0.4, 0.5, 1.0]])
    colors, _, _ = draw_indexed(
        [clear_color(32, 128, (0, 0, 0, 1), CPU)], None, _inst_pipeline(vs, _inst_fs, False),
        vb, torch.tensor([[0, 1, 2]], dtype=torch.int32), {},
        TileGrid(width=128, height=32, tile_h=8, tile_w=128), instance_count=2)
    img = colors[0].numpy()
    reds, greens = img[..., 0] > 0.5, img[..., 1] > 0.5
    assert reds.any() and greens.any()
    assert np.where(reds)[1].mean() > np.where(greens)[1].mean()


def test_instanced_forward_matches_separate_objects():
    """TestInstancedScene::test_instanced_forward_matches_separate_objects:
    one instanced cube through the forward shadow and lit passes
    (``shadow.inst`` and ``forward.inst``) equals three separate cubes at
    translated model matrices."""
    from test_torch_renderers import make_camera, make_cube

    from zenith_tpu_torch.core import mathtypes as m
    from zenith_tpu_torch.renderer import (
        DirectionalLight,
        ForwardShadowRenderer,
        Scene,
        SceneObject,
    )

    device = TCore(CPU).create_render_device()
    cam = make_camera()
    cube_kwargs = dict(base_color=(0.2, 0.6, 0.8, 1.0), roughness=0.5, bin_capacity=64)
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0,
                              base_color=(0.4, 0.4, 0.42, 1.0), roughness=0.9)
    sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.5, shadow_map_size=128,
                           shadow_extent=70.0)

    def render(scene):
        renderer = ForwardShadowRenderer(scene)
        builder = TBuilder()
        out = builder.create(TDesc.color("rt", 128, 64))
        depth = builder.create(TDesc.depth("ds", 128, 64))
        builder.export(out)
        renderer.render_to(builder, out, depth, cam)
        nodes = [n.name for n in builder.nodes]
        compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        return compiled.value(out).numpy(), nodes

    inst = SceneObject.from_mesh(device, make_cube(size=8.0, z0=4.0), "cube",
                                 instance_offsets=OFFSETS, **cube_kwargs)
    img_inst, nodes = render(Scene(objects=[inst, ground], sun=sun, ambient=(0.05,) * 3))
    separate = [SceneObject.from_mesh(device, make_cube(size=8.0, z0=4.0), f"cube{k}",
                                      model_matrix=m.mat4_translation(OFFSETS[k]), **cube_kwargs)
                for k in range(3)]
    img_sep, _ = render(Scene(objects=[*separate, ground], sun=sun, ambient=(0.05,) * 3))
    assert "shadow.inst" in nodes and "forward.inst" in nodes, nodes
    assert img_inst[..., :3].std() > 0.02
    np.testing.assert_allclose(img_inst, img_sep, atol=2e-3)

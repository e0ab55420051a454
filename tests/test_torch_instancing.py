"""Deferred opaque instancing in the port (the ``shadow.inst`` and
``gbuffer.inst`` nodes) against the reference package: twins of
tests/test_instancing.py::TestInstancedScene's deferred cases on
test_renderers.py's cube and ground at 128×64, the scenes built by the
reference and carried across by zenith_tpu_torch.interop.

Tolerances: the reference's own between instanced and separate objects
(HDR atol 2e-3); against the JAX frame, the encoded frame ≤ 1 LSB with < 1%
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
    """velocity=None turns the velocity plane on for device-resident offsets
    (reference deferred.py:598-604), ported since item 21.6; host offsets
    render with it off."""
    scene = interop.scene_from(_jax_scenes()["instanced"], CPU)
    assert not TDeferred(scene).velocity
    scene.objects[0].instance_offsets = torch.from_numpy(OFFSETS)
    renderer = TDeferred(scene)
    assert renderer.velocity and renderer.scene_animated

"""Object picking in the port (the deferred renderer's id plane and
``pick``) against the reference package: twins of tests/test_picking.py's
four cases, each scene built by the reference, rendered by both packages
(carried across by zenith_tpu_torch.interop), the id planes compared and
the reference test's picks made on the port's plane.

Tolerance: the id planes equal (the ids are small integers in float32).
"""

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.renderer import DeferredRenderer as TDeferred
from zenith_tpu_torch.rendergraph import CompileOptions as TOptions
from zenith_tpu_torch.rendergraph import RenderGraphBuilder as TBuilder
from zenith_tpu_torch.rhi import PipelineCache as TCache
from zenith_tpu_torch.rhi import RhiCore as TCore
from zenith_tpu_torch.rhi import TextureDesc as TDesc

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64


def _camera():
    from zenith_tpu.core.camera import Camera
    from zenith_tpu.core.mathtypes import Degree, Radians

    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def _px(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


def _ids(jscene, compare=True):
    """The port's renderer and id plane of the reference's scene, the plane
    held equal to the reference's (``compare``)."""
    cam = _camera()
    renderer = TDeferred(interop.scene_from(jscene, CPU), shadows=False, id_buffer=True)
    builder = TBuilder()
    color = builder.create(TDesc.color("rt", W, H))
    renderer.render_to(builder, color, cam, W, H)
    builder.export(color)
    device = TCore(CPU).create_render_device()
    compiled = builder.build().compile(device, TCache(), TOptions(tile_h=8, tile_w=128))
    compiled.execute(device)
    ids = compiled.value(renderer.id_resource).numpy()
    if compare:
        from zenith_tpu.renderer import DeferredRenderer
        from zenith_tpu.rendergraph import RenderGraphBuilder
        from zenith_tpu.rendergraph.graph import CompileOptions
        from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

        jdevice = RhiCore().create_render_device()
        jr = DeferredRenderer(jscene, shadows=False, id_buffer=True)
        jb = RenderGraphBuilder()
        jcolor = jb.create(TextureDesc.color("rt", W, H))
        jr.render_to(jb, jcolor, cam, W, H)
        jb.export(jcolor)
        jc = jb.build().compile(jdevice, PipelineCache(), CompileOptions(tile_h=8, tile_w=128))
        jc.execute(jdevice)
        np.testing.assert_array_equal(ids, np.asarray(jc.value(jr.id_resource)))
    return renderer, cam, ids


def _objects():
    from test_renderers import make_cube

    from zenith_tpu.renderer import DirectionalLight, SceneObject
    from zenith_tpu.rhi import RhiCore

    device = RhiCore().create_render_device()
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0, base_color=(0.4, 0.4, 0.4, 1.0))
    sun = DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=1.0, cast_shadows=False)
    return device, make_cube, ground, sun


def test_ids_and_pick_roundtrip():
    from zenith_tpu.renderer import Scene, SceneObject

    device, make_cube, ground, sun = _objects()
    cube = SceneObject.from_mesh(device, make_cube(size=14.0, z0=8.0), "cube",
                                 base_color=(0.8, 0.2, 0.2, 1.0), bin_capacity=64)
    renderer, cam, ids = _ids(Scene(objects=[cube, ground], sun=sun, ambient=(0.05,) * 3))
    assert ids.shape[:2] == (H, W)
    cy, cx = _px(cam, (0.0, 0.0, 15.0))  # on the floating cube
    gy, gx = _px(cam, (40.0, 0.0, 0.0))  # open ground
    assert ids[cy, cx, 0] == 1.0 and ids[gy, gx, 0] == 2.0
    assert ids[1, 1, 0] == 0.0  # the sky above the horizon
    objs = renderer.scene.objects
    assert renderer.pick(ids, cx, cy) is objs[0] and renderer.pick(ids, gx, gy) is objs[1]
    assert renderer.pick(ids, 1, 1) is None
    # A tensor plane reads only the picked pixel.
    assert renderer.pick(torch.from_numpy(ids), cx, cy) is objs[0]


def test_instanced_objects_share_their_id():
    from zenith_tpu.renderer import Scene, SceneObject

    device, make_cube, ground, sun = _objects()
    posts = SceneObject.from_mesh(
        device, make_cube(size=8.0, z0=4.0), "posts", base_color=(0.2, 0.8, 0.2, 1.0),
        bin_capacity=64, instance_offsets=np.array([[-20.0, 0.0, 0.0], [20.0, 0.0, 0.0]],
                                                   np.float32))
    renderer, cam, ids = _ids(Scene(objects=[posts, ground], sun=sun))
    for ix in (-20.0, 20.0):
        y, x = _px(cam, (ix, 0.0, 8.0))
        assert ids[y, x, 0] == 1.0, (ix, ids[y, x])
        assert renderer.pick(ids, x, y) is renderer.scene.objects[0]


def test_depth_resolves_occlusion():
    """Two overlapping cubes: the nearer one owns the shared pixels."""
    from zenith_tpu.renderer import Scene, SceneObject

    device, make_cube, _, sun = _objects()
    near = SceneObject.from_mesh(device, make_cube(size=10.0, z0=8.0), "near",
                                 base_color=(1, 0, 0, 1), bin_capacity=64)
    far = SceneObject.from_mesh(device, make_cube(size=30.0, z0=5.0), "far",
                                base_color=(0, 0, 1, 1), bin_capacity=64)
    far.model_matrix = np.array([[1, 0, 0, 0], [0, 1, 0, 40.0], [0, 0, 1, 0], [0, 0, 0, 1]],
                                np.float32)  # behind 'near' from this camera
    renderer, cam, ids = _ids(Scene(objects=[near, far], sun=sun), compare=False)
    y, x = _px(cam, (0.0, 0.0, 12.0))  # the centre of the near cube
    assert renderer.pick(ids, x, y) is renderer.scene.objects[0]
    assert (ids == 2.0).any()  # the far cube shows around it


def test_disabled_by_default():
    from zenith_tpu_torch.renderer import Scene, SceneObject

    device = TCore(CPU).create_render_device()
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0,
                              base_color=(0.4, 0.4, 0.4, 1.0))
    renderer = TDeferred(Scene(objects=[ground], sun=None), shadows=False)
    assert renderer.id_resource is None
    with pytest.raises(ValueError, match="id_buffer=True"):
        renderer.pick(np.zeros((H, W, 1)), 0, 0)

"""The deferred renderer's velocity plane in the port (``g.prev``, the
previous transforms and instance offsets, velocity on by default for
device-resident offsets) against the reference package on the same scene
(tests/test_velocity.py), and twins of its skinned, morphed and automatic
cases (test_velocity.py:131, :160, :392) on the port.

Tolerance: the ``g.prev`` and ``g.pos`` planes at the port's position
tolerance, atol 0.05 (tests/test_torch_deferred.py:99: the near-clipped
ground's positions differ by the FMA rounding of its clip); the skinned and
morphed position deltas atol 1e-3 against the analytic motion (the
reference test's tolerance). The SPMD case (test_velocity.py:329) is
test_torch_gbuffer_spmd.py's.
"""

import numpy as np
import torch

from test_torch_shadow_frames import CPU, cameras
from zenith_tpu_torch import interop
from zenith_tpu_torch.renderer import DeferredRenderer
from zenith_tpu_torch.rhi import RhiCore

torch.set_num_threads(1)
W, H = 128, 64


def _motion_scene():
    """test_renderers.py's scene (no point lights) plus four instanced
    rocks on the ground."""
    from test_renderers import build_test_scene

    from zenith_tpu.renderer import SceneObject
    from zenith_tpu.rhi import RhiCore as JCore

    dev = JCore().create_render_device()
    jscene = build_test_scene(dev, num_lights=0)
    offs = np.array([[-30, 10, 0], [-12, 25, 0], [15, 22, 0], [32, 8, 0]], np.float32)
    jscene.objects.append(SceneObject.cube(dev, "rocks", size=6.0, z0=0.0,
                                           base_color=(0.35, 0.33, 0.3, 1.0),
                                           instance_offsets=offs))
    return jscene


def _prev_planes(renderer, cam, device, pkg):
    """One frame of ``renderer``; its (pos, prev, depth) planes as numpy."""
    if pkg == "jax":
        from zenith_tpu.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith_tpu.rhi import PipelineCache, TextureDesc
    else:
        from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith_tpu_torch.rhi import PipelineCache, TextureDesc
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("hdr", W, H))
    builder.export(out)
    renderer.render_to(builder, out, cam, W, H)
    g = renderer.gbuffer_handles
    for name in ("pos", "prev_pos", "depth"):
        builder.export(g[name])
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
    compiled.execute(device)
    return [np.array(compiled.value(g[name])) for name in ("pos", "prev_pos", "depth")]


def test_prev_plane_of_moved_objects_matches_the_reference():
    """The cube translated and the rocks' host offsets rolled between two
    frames: the second frame's g.prev plane holds the first frame's
    positions, in both packages (atol 0.05), and differs from g.pos."""
    from zenith_tpu.renderer import DeferredRenderer as JDeferred
    from zenith_tpu.rhi import RhiCore as JCore

    jscene = _motion_scene()
    scene = interop.scene_from(jscene, CPU)
    jcam, cam = cameras(45.0, W / H, (0.0, -60.0, 25.0), 0.0, -0.25)
    jr = JDeferred(jscene, velocity=True)
    r = DeferredRenderer(scene, velocity=True)
    jdev, dev = JCore().create_render_device(), RhiCore(CPU).create_render_device()
    _prev_planes(jr, jcam, jdev, "jax")
    _prev_planes(r, cam, dev, "port")
    move = np.eye(4, dtype=np.float32)
    move[:3, 3] = (4.0, 0.0, 1.5)
    for s in (jscene, scene):
        s.objects[0].model_matrix = (move @ s.objects[0].model_matrix).astype(np.float32)
        s.objects[-1].instance_offsets = np.roll(np.asarray(s.objects[-1].instance_offsets), 1, 0)
    jpos, jprev, jdepth = _prev_planes(jr, jcam, jdev, "jax")
    pos, prev, depth = _prev_planes(r, cam, dev, "port")
    cov = (depth > 0) & (jdepth > 0)
    assert cov.mean() > 0.5
    np.testing.assert_allclose(prev[..., :3][cov], jprev[..., :3][cov], atol=0.05)
    np.testing.assert_allclose(pos[..., :3][cov], jpos[..., :3][cov], atol=0.05)
    moved = np.abs(prev[..., :3] - pos[..., :3]).max(-1) > 1.0
    assert moved[cov].mean() > 0.02  # the cube and the rocks carry velocity
    # The observation is idempotent within a frame: a retained re-run with
    # frame_dynamics keeps the same previous transforms.
    d = r.frame_dynamics(cam, include_models=True)
    np.testing.assert_array_equal(d["def.prev_inst.rocks"], np.roll(
        np.asarray(scene.objects[-1].instance_offsets), -1, 0))


def test_device_offsets_turn_the_velocity_plane_on():
    """Tensor offsets: velocity=None turns the plane on (reference
    deferred.py:598-604), the offsets ride dynamics as tensors, and a new
    tensor each frame is the motion signal (identity, no value read)."""
    jscene = _motion_scene()
    scene = interop.scene_from(jscene, CPU)
    offs = torch.from_numpy(np.asarray(scene.objects[-1].instance_offsets))
    scene.objects[-1].instance_offsets = offs
    r = DeferredRenderer(scene)
    assert r.velocity and r.scene_animated
    _, cam = cameras(45.0, W / H, (0.0, -60.0, 25.0), 0.0, -0.25)
    dev = RhiCore(CPU).create_render_device()
    pos, prev, depth = _prev_planes(r, cam, dev, "port")
    np.testing.assert_allclose(prev[..., :3][depth > 0], pos[..., :3][depth > 0], atol=1e-5)
    assert r.gbuffer_handles.animated_without_velocity is False
    d = r.frame_dynamics(cam)
    assert d["def.inst.rocks"] is offs and d["def.prev_inst.rocks"] is offs
    moved = offs + torch.tensor([0.0, 0.0, 2.0])
    scene.objects[-1].instance_offsets = moved
    d = r.frame_dynamics(cam)
    assert d["def.inst.rocks"] is moved and d["def.prev_inst.rocks"] is offs
    assert r.frame_dynamics(cam)["def.prev_inst.rocks"] is offs  # idempotent
    r.reset_motion()
    assert r.frame_dynamics(cam)["def.prev_inst.rocks"] is moved
    # Without the plane, an animated scene is flagged for the temporal passes.
    off = DeferredRenderer(scene, velocity=False)
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import TextureDesc

    b = RenderGraphBuilder()
    off.render_to(b, b.create(TextureDesc.color("o", W, H)), cam, W, H)
    assert off.gbuffer_handles.animated_without_velocity and "prev_pos" not in off.gbuffer_handles


def _animated_planes(obj, cam, move):
    """Two frames of ``obj`` alone with the velocity plane: ``move(obj)``
    between them. Returns the second frame's (pos, prev) planes."""
    from zenith_tpu_torch.renderer import DirectionalLight, Scene

    device = RhiCore(CPU).create_render_device()
    r = DeferredRenderer(Scene(objects=[obj], sun=DirectionalLight(cast_shadows=False)),
                         shadows=False, velocity=True)
    _prev_planes(r, cam, device, "port")
    move(obj)
    return _prev_planes(r, cam, device, "port")[:2]


def _tube_camera():
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians

    cam = Camera(fov_y=Degree(35.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -120.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.1))
    return cam


def _tube():
    from zenith_tpu_torch.renderer import SceneObject
    from zenith_tpu_torch.sandbox.scene import skinned_tube

    return SceneObject.from_mesh(RhiCore(CPU).create_render_device(),
                                 skinned_tube(bones=3, rings=8, sides=8), "tube")


def test_skinned_prev_tracks_palette():
    """The joint palette moves between frames: the prev plane holds the
    previous palette's skinned positions."""
    def move(obj):
        pal = np.broadcast_to(np.eye(4, dtype=np.float32), (obj.skin.num_joints, 4, 4)).copy()
        pal[:, 2, 3] = 3.0  # every joint up 3 in z (the weights sum to 1)
        obj.joint_matrices = pal

    pos, prev = _animated_planes(_tube(), _tube_camera(), move)
    cov = pos[..., 2] != 0
    assert cov.sum() > 50
    delta = pos[..., :3][cov] - prev[..., :3][cov]
    np.testing.assert_allclose(delta, np.tile([0.0, 0.0, 3.0], (delta.shape[0], 1)), atol=1e-3)


def test_morph_prev_tracks_weights():
    """One constant-direction target, weight 0 then 1: the prev delta is
    exactly w·(2, 0, 0)."""
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree
    from zenith_tpu_torch.renderer import SceneObject
    from zenith_tpu_torch.sandbox.scene import morphing_blob

    blob = morphing_blob(rings=8, sides=10)
    blob.morph_deltas = np.tile(np.array([2.0, 0.0, 0.0], np.float32),
                                (1, blob.vertices.shape[0], 1))
    obj = SceneObject.from_mesh(RhiCore(CPU).create_render_device(), blob, "blob")
    obj.morph_weights = np.zeros((1,), np.float32)
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -30.0, 5.0], np.float32))
    pos, prev = _animated_planes(obj, cam,
                                 lambda o: setattr(o, "morph_weights", np.ones((1,), np.float32)))
    cov = pos[..., 2] != 0
    assert cov.sum() > 50
    delta = pos[..., :3][cov] - prev[..., :3][cov]
    np.testing.assert_allclose(delta, np.tile([2.0, 0.0, 0.0], (delta.shape[0], 1)), atol=1e-3)


def test_skinned_scene_auto_on():
    """velocity=None turns the plane on for a skinned scene and publishes
    it; frame 0's prev plane is the current positions."""
    from zenith_tpu_torch.renderer import DirectionalLight, Scene

    r = DeferredRenderer(Scene(objects=[_tube()], sun=DirectionalLight(cast_shadows=False)),
                         shadows=False)
    assert r.velocity is True and r.scene_animated
    pos, prev, _ = _prev_planes(r, _tube_camera(), RhiCore(CPU).create_render_device(), "port")
    assert "prev_pos" in r.gbuffer_handles and not r.gbuffer_handles.animated_without_velocity
    np.testing.assert_allclose(pos[..., :3], prev[..., :3], atol=1e-5)

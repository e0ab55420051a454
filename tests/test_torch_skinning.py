"""Skeletal skinning in the port (renderer/animation.py, the deferred
renderer's skinned stages) against the reference package: twins of
tests/test_skinning.py's animation, linear-blend and pipeline cases and its
STEP-interpolation case.

Tolerances: the palettes equal the reference's (the same NumPy code); the
skinned positions and normals atol 1e-4 against the float64 NumPy oracle
(the reference test's tolerance) and atol 2e-5 against the jitted
reference on the same inputs (XLA contracts the four-term blends into FMAs,
the port rounds each product: measured 1.5e-5 on positions up to 104
units, 9.5e-7 on the normals); the bind-pose frame atol 1e-5 against the
plain pipeline (the reference test's tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from zenith_tpu_torch.asset import AssetUrl
from zenith_tpu_torch.asset.render_types import AnimationChannel, AnimationClip, Mesh, Skin
from zenith_tpu_torch.renderer.animation import AnimationPlayer

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _two_bone_skin(seg=2.0):
    inv_bind = np.stack([np.eye(4, dtype=np.float32)] * 2)
    inv_bind[1, 2, 3] = -seg  # joint 1 binds at (0, 0, seg)
    rest_t = np.array([[0, 0, 0], [0, 0, seg]], np.float32)
    rest_r = np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1))
    rest_s = np.ones((2, 3), np.float32)
    return Skin(inv_bind, np.array([-1, 0], np.int32), rest_t, rest_r, rest_s)


def _rot_x_quat(angle):
    return np.array([np.sin(angle / 2), 0.0, 0.0, np.cos(angle / 2)], np.float32)


def _palette(skin, channels, t, loop=False, duration=None):
    """The port's palette, equal to the reference player's on the same clip."""
    from zenith_tpu.asset import render_types as jrt
    from zenith_tpu.renderer.animation import AnimationPlayer as JPlayer

    clip = AnimationClip("c", channels, duration)
    jskin = jrt.Skin(skin.inverse_bind, skin.parents, skin.rest_t, skin.rest_r, skin.rest_s,
                     skin.pre)
    jclip = jrt.AnimationClip("c", [jrt.AnimationChannel(c.joint, c.path, c.times, c.values,
                                                         c.interpolation)
                                    for c in channels], duration)
    got = AnimationPlayer(skin, clip, loop=loop).joint_matrices(t)
    np.testing.assert_array_equal(got, JPlayer(jskin, jclip, loop=loop).joint_matrices(t))
    return got


def test_bind_pose_is_identity_palette():
    pal = _palette(_two_bone_skin(), [], 0.0)
    assert pal.shape == (2, 4, 4)
    np.testing.assert_allclose(pal, np.stack([np.eye(4)] * 2), atol=1e-6)


def test_rotation_channel_and_hierarchy():
    """90° about X on joint 1: a point at the tip (0, 0, 2·seg) swings to
    (0, -seg, seg)."""
    seg = 2.0
    times = np.array([0.0, 1.0], np.float32)
    quats = np.stack([_rot_x_quat(0.0), _rot_x_quat(np.pi / 2)])
    pal = _palette(_two_bone_skin(seg), [AnimationChannel(1, "rotation", times, quats)], 1.0)
    np.testing.assert_allclose(pal[0], np.eye(4), atol=1e-6)  # joint 0 untouched
    out = pal[1] @ np.array([0.0, 0.0, 2 * seg, 1.0], np.float32)
    np.testing.assert_allclose(out[:3], [0.0, -seg, seg], atol=1e-5)


def test_keyframe_interpolation_midpoint():
    times = np.array([0.0, 1.0], np.float32)
    tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
    pal = _palette(_two_bone_skin(), [AnimationChannel(0, "translation", times, tr)], 0.5)
    np.testing.assert_allclose(pal[0][:3, 3], [2.0, 0, 0], atol=1e-6)
    # nlerp at the midpoint of a 0→90° X rotation is exactly 45°.
    quats = np.stack([_rot_x_quat(0.0), _rot_x_quat(np.pi / 2)])
    pal = _palette(_two_bone_skin(), [AnimationChannel(0, "rotation", times, quats)], 0.5)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    np.testing.assert_allclose(pal[0][:3, :3], [[1, 0, 0], [0, c, -s], [0, s, c]], atol=1e-5)


def test_looping():
    times = np.array([0.0, 2.0], np.float32)
    tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
    ch = [AnimationChannel(0, "translation", times, tr)]
    np.testing.assert_allclose(_palette(_two_bone_skin(), ch, 2.5, loop=True)[0][:3, 3],
                               _palette(_two_bone_skin(), ch, 0.5, loop=True)[0][:3, 3],
                               atol=1e-6)


def test_step_interpolation_holds_pose():
    times = np.array([0.0, 1.0], np.float32)
    tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
    ch = [AnimationChannel(0, "translation", times, tr, interpolation="STEP")]
    np.testing.assert_allclose(_palette(_two_bone_skin(), ch, 0.5)[0][:3, 3], [0, 0, 0],
                               atol=1e-6)  # STEP holds the previous key
    np.testing.assert_allclose(_palette(_two_bone_skin(), ch, 1.0)[0][:3, 3], [4.0, 0, 0],
                               atol=1e-6)


def test_skin_blend_matches_numpy_oracle(rng):
    from zenith_tpu.renderer.deferred import _skin_blend as ref
    from zenith_tpu_torch.renderer.deferred import _skin_blend

    n, j = 4096, 6
    pos = rng.uniform(-30, 30, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    jidx = rng.integers(0, j, size=(n, 4)).astype(np.float32)
    w = rng.uniform(0.01, 1.0, size=(n, 4)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    mats = rng.normal(size=(j, 4, 4)).astype(np.float32)
    attrs = {"position": pos, "normal": nrm, "joints": jidx, "weights": w}
    got_p, got_n = _skin_blend({k: torch.from_numpy(v) for k, v in attrs.items()},
                               {"Joints": torch.from_numpy(mats)})
    hom = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    want_p = np.zeros((n, 4), np.float64)
    want_n = np.zeros((n, 3), np.float64)
    for k in range(4):
        mk = mats[jidx[:, k].astype(int)]
        want_p += w[:, k:k + 1] * np.einsum("nij,nj->ni", mk, hom)
        want_n += w[:, k:k + 1] * np.einsum("nij,nj->ni", mk[:, :3, :3], nrm)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=1e-4)
    np.testing.assert_allclose(got_n.numpy(), want_n, atol=1e-4)
    jp, jn = jax.jit(lambda a, m: ref(a, {"Joints": m}))(attrs, mats)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(jp), atol=2e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(jn), atol=2e-5)


def _render(*, animate, skinned=True):
    """test_skinning.py's tube frame on the port: (HDR frame, (renderer,
    compiled graph, camera, device, object, output handle))."""
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.renderer import DeferredRenderer, DirectionalLight, Scene, SceneObject
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, TextureDesc
    from zenith_tpu_torch.sandbox.scene import skinned_tube

    device = RhiCore(CPU).create_render_device()
    tube = skinned_tube(bones=4, rings=12, sides=10)
    if not skinned:  # the same geometry through the plain pipeline
        tube = Mesh(AssetUrl("plain/tube"), tube.vertices, tube.indices)
    obj = SceneObject.from_mesh(device, tube, "tube", base_color=(0.3, 0.8, 0.4, 1.0))
    scene = Scene(objects=[obj], sun=DirectionalLight(cast_shadows=True), point_lights=[],
                  ambient=(0.1, 0.1, 0.12))
    renderer = DeferredRenderer(scene)
    w, h = 128, 64
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
    camera.set_position(np.array([0.0, -120.0, 25.0], np.float32))
    camera.set_yaw_pitch(Radians(0.0), Radians(-0.1))
    if animate:
        obj.joint_matrices = AnimationPlayer(obj.skin, obj.clips[0]).joint_matrices(0.6)
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, out, camera, w, h)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
    compiled.execute(device)
    return compiled.value(out).numpy(), (renderer, compiled, camera, device, obj, out)


def test_bind_pose_matches_plain_pipeline():
    """The identity palette is the bind pose: the skinned draw gives the
    plain pipeline's frame on the same mesh."""
    img_s, (renderer, *_rest) = _render(animate=False, skinned=True)
    img_p, _ = _render(animate=False, skinned=False)
    assert renderer.has_skinned and renderer.velocity  # a skin turns the velocity plane on
    np.testing.assert_allclose(img_s, img_p, atol=1e-5)
    assert img_s[..., :3].std() > 0.01  # the tube is on screen


def test_animation_deforms_and_retained_matches():
    img0, _ = _render(animate=False)
    img1, (renderer, compiled, camera, device, obj, out) = _render(animate=True)
    assert np.abs(img1 - img0).max() > 0.05  # the pose moved pixels
    # A retained run with a new pose takes the palette dynamic and changes
    # the frame with the same frame function.
    obj.joint_matrices = AnimationPlayer(obj.skin, obj.clips[0]).joint_matrices(1.4)
    compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
    assert np.abs(compiled.value(out).numpy() - img1).max() > 0.01

"""A whole 128×64 frame of the port's animated objects against the
reference package's: sandbox/scene.py's skinned tentacle (its wave clip
through AnimationPlayer), its morphing blob (the pulse clip's weights) and
32 sparks simulated on the device and drawn instanced at the positions
each frame feeds back, after three fed-back frames, with the object-id
plane and the velocity plane (on by default for skins, morphs and device
offsets). The scene and the particle system are built by the reference and
carried across by zenith_tpu_torch.interop; both packages step the same
clock. One case (the JAX frame compiles for seconds, and the suite spreads
files over its workers).

Tolerances: the id plane equal and ``pick`` at three pixels (the tube, the
blob, a spark) the same object in both; the encoded frame ≤ 1 LSB with
< 1% of values differing (the golden tolerance); the fed-back particle
state atol 1e-5 (the respawned x and y velocities differ by up to 2e-6,
tests/test_torch_particles.py, and move the positions by dt times that).
"""

import numpy as np
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.rhi import Format as TFormat
from zenith_tpu_torch.rhi import encode_present

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
FRAMES = 3
DT = 0.05


def _jax_parts():
    """(scene, camera, particle system) of the reference: the tube, the blob
    and the sparks at the particle system's positions."""
    from zenith_tpu.core import mathtypes as m
    from zenith_tpu.core.camera import Camera
    from zenith_tpu.core.mathtypes import Degree, Radians
    from zenith_tpu.renderer import DirectionalLight, ParticleSystem, Scene, SceneObject
    from zenith_tpu.rhi import RhiCore
    from zenith_tpu.sandbox.scene import morphing_blob, skinned_tube

    device = RhiCore().create_render_device()
    tube = SceneObject.from_mesh(device, skinned_tube(bones=4, rings=12, sides=10), "tentacle",
                                 model_matrix=m.mat4_translation(np.array([-22.0, 0.0, 0.0],
                                                                          np.float32)),
                                 base_color=(0.45, 0.75, 0.5, 1.0), metallic=0.1, roughness=0.5)
    blob = SceneObject.from_mesh(device, morphing_blob(rings=10, sides=12), "blob",
                                 model_matrix=m.mat4_translation(np.array([22.0, 0.0, 12.0],
                                                                          np.float32)),
                                 base_color=(0.8, 0.55, 0.3, 1.0), metallic=0.2, roughness=0.35)
    psys = ParticleSystem(32, emitter=(0.0, 0.0, 2.0))
    sparks = SceneObject.cube(device, "sparks", size=1.5, z0=-0.75,
                              base_color=(1.0, 0.75, 0.3, 1.0), emissive=(4.0, 2.4, 0.8),
                              instance_offsets=psys.positions)
    scene = Scene(objects=[tube, blob, sparks],
                  sun=DirectionalLight(direction=(0.3, -0.5, 1.0), intensity=2.5,
                                       cast_shadows=False), ambient=(0.06,) * 3)
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -80.0, 22.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.08))
    return scene, cam, psys


def _animate(scene, t):
    """Both packages' players and clips, sampled at ``t``."""
    tube, blob = scene.objects[0], scene.objects[1]
    if isinstance(scene.objects[0].vertex_buffer.array, torch.Tensor):
        from zenith_tpu_torch.renderer.animation import AnimationPlayer, sample_morph_weights
    else:
        from zenith_tpu.renderer.animation import AnimationPlayer, sample_morph_weights
    tube.joint_matrices = AnimationPlayer(tube.skin, tube.clips[0]).joint_matrices(t)
    blob.morph_weights = sample_morph_weights(blob.clips[0], t, blob.morph_deltas.shape[0])


def _frames(scene, cam, psys, port):
    """FRAMES fed-back frames; returns (renderer, hdr, id plane, state)."""
    if port:
        from zenith_tpu_torch.renderer import DeferredRenderer
        from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore(CPU).create_render_device()
    else:
        from zenith_tpu.renderer import DeferredRenderer
        from zenith_tpu.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith_tpu.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
    renderer = DeferredRenderer(scene, id_buffer=True)
    assert renderer.velocity  # skins, morphs and device offsets turn it on
    cache = PipelineCache()
    for f in range(FRAMES):
        _animate(scene, 0.4 + f * DT)
        scene.objects[2].instance_offsets = psys.positions
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", W, H))
        builder.export(hdr)
        renderer.render_to(builder, hdr, cam, W, H)
        state_h, pos_h = psys.sim_to(builder, DT)
        compiled = builder.build().compile(device, cache, CompileOptions(tile_h=8, tile_w=128))
        compiled.execute(device)
        psys.feedback(compiled.value(state_h), compiled.value(pos_h))
    return (renderer, np.asarray(compiled.value(hdr)),
            np.asarray(compiled.value(renderer.id_resource)), np.asarray(psys._state))


def _pixel(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


def test_animated_frame_matches_the_reference():
    jscene, cam, jpsys = _jax_parts()
    scene = interop.scene_from(jscene, CPU)
    psys = interop.particle_system_from(jpsys, CPU)
    renderer, hdr, ids, state = _frames(scene, cam, psys, port=True)
    jrenderer, jhdr, jids, jstate = _frames(jscene, cam, jpsys, port=False)
    assert renderer.has_skinned and renderer.has_morphs and psys._tick == FRAMES
    np.testing.assert_array_equal(ids, jids)
    assert set(np.unique(ids)) == {0.0, 1.0, 2.0, 3.0}  # the sky, tube, blob and sparks
    np.testing.assert_allclose(state, jstate, atol=1e-5)
    spark = state[np.argmax(state[:, 2])]  # the highest spark (drawn a frame late)
    picks = [_pixel(cam, p) for p in ((-22.0, 0.0, 20.0), (22.0, 0.0, 12.0))]
    picks.append(tuple(np.argwhere(ids[..., 0] == 3.0)[0]))
    for y, x in picks:
        obj, jobj = renderer.pick(ids, x, y), jrenderer.pick(jids, x, y)
        assert obj is not None and obj.name == jobj.name
    assert [renderer.pick(ids, x, y).name for y, x in picks] == ["tentacle", "blob", "sparks"]
    assert np.isfinite(spark).all()
    ea, eb = (encode_present(torch.from_numpy(np.array(x)), TFormat.RGBA8_SRGB).numpy()
              .astype(np.int16) for x in (hdr, jhdr))
    d = np.abs(ea - eb)
    assert int(d.max()) <= 1 and float((d > 0).mean()) < 0.01, (int(d.max()), (d > 0).mean())

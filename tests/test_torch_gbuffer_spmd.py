"""The SPMD cases of two G-buffer features' reference tests on the port:
test_contact.py:147 (the contact-shadow delta over the baked cerberus)
and test_velocity.py:329 (the velocity G-buffer of a moving cube), each
rendered over 8 row bands of ``default_mesh(8, device="cpu")`` against the
port's single-device frame. A file of their own beside
test_torch_screenspace_spmd.py and test_torch_velocity.py, so that no file
runs much over 30 s. Tolerances:

- contact: the reference's atol 1e-4 on all but 0.01% of the delta's
  values (the case's docstring says why not everywhere);
- velocity: ``g.pos`` and ``g.prev`` at the reference's atol 1e-4
  against single-device (band evaluation reassociates the attribute math
  at fp32), and at the port's position tolerance, atol 0.05, against the
  JAX 8-device planes (tests/test_torch_deferred.py:99: the near-clipped
  ground's positions differ by the FMA rounding of its clip).
"""

import numpy as np
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_spmd_contact_delta_matches_single_device(cpu_devices, monkeypatch):
    """test_contact.py:147: the contact-shadow delta (on - off) of the
    sandbox scene over the baked cerberus at 256×128 matches across mesh
    sizes (the march's global-row dither and gathered tap planes make the
    feature band-invariant): the reference's atol 1e-4 on all but 0.01% of
    the values. The band-local edge setup rounds the G-buffer positions a
    few ulps apart from the single-device setup (28% of them differ, by
    ~1e-6 relative), and on this frame that flips one tap verdict at two
    pixels (6 values, by 0.2). The port only: four JAX frames of cerberus
    would cost a minute; the single-device contact march is held against
    the reference above."""
    import math
    from dataclasses import replace
    from pathlib import Path

    from zenith_tpu_torch import asset
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.parallel import default_mesh
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc
    from zenith_tpu_torch.sandbox.scene import build_scene

    root = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(root)
    monkeypatch.setenv("ZENITH_CACHE", str(root / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    asset.initialize()
    device = RhiCore(CPU).create_render_device()
    base_scene = build_scene(device, 0, np.random.default_rng(3), skybox=False)
    w, h = 256, 128
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
    camera.set_position(np.array([0.0, -170.0, 25.0], np.float32))
    camera.set_yaw_pitch(Radians(0.0), Radians(-math.atan2(20.0, 170.0)))

    def render(contact, mesh):
        scene = base_scene
        if contact:
            scene = replace(scene, sun=replace(scene.sun, contact_shadows=True,
                                               contact_distance=6.0, contact_steps=8))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h))
        builder.export(out)
        DeferredRenderer(scene).render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(device, PipelineCache(),
                                           CompileOptions(tile_h=8, mesh=mesh))
        compiled.execute(device)
        return compiled.value(out).numpy()

    mesh = default_mesh(8, device="cpu")
    delta1 = render(True, None) - render(False, None)
    delta8 = render(True, mesh) - render(False, mesh)
    assert np.abs(delta1).max() > 0.01  # the feature did something
    off = np.abs(delta8 - delta1) > 1e-4
    assert off.mean() < 1e-4, (off.sum(), np.abs(delta8 - delta1).max())


def _velocity_planes(pkg_name, mesh_n):
    """test_velocity.py:329's two frames (the cube moved between them) in
    ``pkg_name``: the second frame's g.pos and g.prev planes."""
    from test_torch_spmd_twins import Pkg, device_of, mesh_of

    pkg = Pkg(pkg_name)
    rg, rhi, ren = pkg.mod("rendergraph"), pkg.mod("rhi"), pkg.mod("renderer")
    camera, mt = pkg.mod("core.camera"), pkg.mod("core.mathtypes")
    w8, h8 = 128, 128  # the height divides 8 shards x tile_h 8
    device = device_of(pkg)
    cube = ren.SceneObject.cube(device, "c", size=6.0)
    scene = ren.Scene(objects=[cube], sun=ren.DirectionalLight(cast_shadows=False))
    r = ren.DeferredRenderer(scene, shadows=False, velocity=True)
    cam = camera.Camera(fov_y=mt.Degree(45.0), aspect_ratio=w8 / h8)
    cam.set_position(np.array([0.0, -30.0, 5.0], np.float32))
    options = rg.CompileOptions(tile_h=8, tile_w=64, mesh=mesh_of(pkg, mesh_n))

    def frame():
        builder = rg.RenderGraphBuilder()
        out = builder.create(rhi.TextureDesc.color("hdr", w8, h8))
        r.render_to(builder, out, cam, w8, h8)
        for k in ("pos", "prev_pos"):
            builder.export(r.gbuffer_handles[k])
        compiled = builder.build().compile(device, rhi.PipelineCache(), options)
        compiled.execute(device)
        return [np.asarray(compiled.value(r.gbuffer_handles[k])) for k in ("pos", "prev_pos")]

    frame()
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = 4.0
    cube.model_matrix = m
    return frame()


def test_spmd_velocity_gbuffer_sharded_matches_single(cpu_devices):
    from test_torch_spmd_twins import PORT, REF

    pos1, prev1 = _velocity_planes(PORT, None)
    pos8, prev8 = _velocity_planes(PORT, 8)
    # Interpolated world positions are O(10); band evaluation reassociates
    # the attribute math at fp32.
    np.testing.assert_allclose(pos8, pos1, atol=1e-4)
    np.testing.assert_allclose(prev8, prev1, atol=1e-4)
    assert np.abs(prev1 - pos1).max() > 1.0  # the cube moved
    jpos8, jprev8 = _velocity_planes(REF, 8)
    np.testing.assert_allclose(pos8, jpos8, atol=0.05)
    np.testing.assert_allclose(prev8, jprev8, atol=0.05)

"""The SPMD cases of the screen-space passes' reference tests on the port
(test_flare.py:102, test_ssr.py:165, test_volumetric.py:139,
test_ssao.py:193; test_contact.py:147 is test_torch_gbuffer_spmd.py's):
each node over 8 row bands of
``default_mesh(8, device="cpu")`` against the port's single-device frame at
the reference's tolerance, and against the JAX 8-device frame
(tests/test_torch_spmd_twins.py is the harness). A file of its own beside
test_torch_screenspace_ops.py, which twins the ops, so that no file runs
much over 30 s. Each case states its tolerance.
"""

import numpy as np
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _FakeCam:
    """render_to reads only these camera attributes."""

    def __init__(self, vp=None, inv_vp=None, loc=None):
        self.render_view_projection = vp
        self.render_inv_view_projection = inv_vp
        self.location = loc


def test_spmd_flare_sharded_matches_single(cpu_devices):
    """test_flare.py:102: lobes over global rows per band; the occlusion
    probe window (near the top band) summed over the bands. The reference's
    atol 1e-5 against single-device and against the JAX 8-device frame."""
    from test_torch_spmd_twins import grid, triplet

    w2, h2 = 128, 64
    sun_uv = np.asarray([0.7, 0.08], np.float32)
    rows, cols = grid(h2, w2)
    base = 0.05 + 0.02 * np.sin(rows * 0.3) * np.cos(cols * 0.2)
    c = base + 3.0 * np.exp(-((cols - sun_uv[0] * w2) ** 2 + (rows - sun_uv[1] * h2) ** 2) / 40.0)
    planes = {"hdr": np.stack([c, c * 0.9, c * 0.8, np.ones_like(c)], -1)}

    def add(pkg, builder, h):
        pkg.mod("renderer.flare").LensFlare().render_to(builder, h["hdr"])  # occlusion on
        return [h["hdr"]]

    dyn = {"flare.sun_uv": sun_uv, "flare.vis": np.float32(1.0)}
    (img1,), (img8,), (jimg,) = triplet(planes, add, dynamics=dyn)
    assert img8[..., :3].sum() > 0.0
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)


def test_spmd_ssr_node_sharded_matches_single(cpu_devices):
    """test_ssr.py:165: the march gathers on the gathered full surfaces, the
    band sliced back (a mirror floor below an elevated green plate). The
    reference's atol 1e-5 against single-device; against the JAX 8-device
    frame atol 1e-4 (0.2% of the values differ by up to 2e-5: over this
    24-step march XLA's contracted multiply-adds move the hit blend by a
    few ulps of its 0.3-1.0 values)."""
    from test_torch_spmd_twins import grid, triplet

    h2, w2 = 256, 128
    vp = np.zeros((4, 4), np.float32)
    vp[0, 0], vp[0, 3] = 2.0 / w2, 1.0 / w2 - 1.0
    vp[1, 1], vp[1, 3] = 2.0 / h2, 1.0 / h2 - 1.0
    vp[2, 2] = vp[3, 3] = 1.0
    cam = _FakeCam(vp=vp, loc=np.array([64.0, 0.0, 80.0], np.float32))
    rows, cols = grid(h2, w2)
    wall = rows >= 224.0
    z = np.where(wall, 60.0, 0.0).astype(np.float32)
    nrm = np.where(wall[..., None], np.float32([0.0, -1.0, 0.0]), np.float32([0.0, 0.0, 1.0]))
    green = np.where(wall, 1.0, 0.05).astype(np.float32)
    planes = {
        "hdr": np.stack([np.full_like(green, 0.05), green, np.full_like(green, 0.05),
                         np.ones_like(green)], -1),
        "galb": np.concatenate([np.full((h2, w2, 3), 0.9), np.ones((h2, w2, 1))], -1),
        "gnrm": np.concatenate([nrm, np.where(wall, 1.0, 0.05)[..., None]], -1),
        "gpos": np.stack([cols, rows, z, np.zeros_like(z)], -1),
        "gdep": np.full((h2, w2), 0.5, np.float32),
    }

    def add(pkg, builder, h):
        ssr = pkg.mod("renderer.ssr").ScreenSpaceReflections(
            steps=24, refine=4, max_distance=400.0, thickness=8.0, max_roughness=0.6, jitter=True)
        out = builder.create(pkg.mod("rhi").TextureDesc.color("ssr.out", w2, h2))
        ssr.render_to(builder, h["hdr"], out, cam, {"albedo": h["galb"], "normal": h["gnrm"],
                                                    "pos": h["gpos"], "depth": h["gdep"]})
        return [out, h["hdr"]]

    (img1, src1), (img8, _), (jimg, _) = triplet(planes, add)
    assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3  # reflections picked up
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-4)


def test_spmd_fog_node_sharded_matches_single(cpu_devices):
    """test_volumetric.py:139: only the (banded) 32² shadow map gathers
    full; the screen math stays on the band and the jitter hash uses global
    rows. The reference's atol 1e-5 against single-device and the JAX
    8-device frame."""
    from test_torch_spmd_twins import grid, triplet
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians

    h2, w2 = 128, 64
    real = Camera(fov_y=Degree(40.0), aspect_ratio=w2 / h2)
    real.set_position(np.array([0.0, -60.0, 20.0], np.float32))
    real.set_yaw_pitch(Radians(0.0), Radians(-0.2))
    cam = _FakeCam(inv_vp=np.asarray(real.render_inv_view_projection, np.float32),
                   loc=np.asarray(real.location, np.float32))
    lvp = np.zeros((4, 4), np.float32)
    lvp[0, 0] = lvp[1, 1] = 0.01
    lvp[2, 3] = 0.5
    lvp[3, 3] = 1.0
    rows, cols = grid(h2, w2)
    base = 0.2 + 0.4 * np.sin(rows * 0.2) * np.cos(cols * 0.13)
    wx, wz = (cols - w2 / 2) * 1.5, (rows - h2 / 2) * -0.5
    planes = {
        "hdr": np.stack([base, base * 0.5, 1.0 - base, np.ones_like(base)], -1),
        "gpos": np.stack([wx, np.full_like(wx, 40.0), wz, np.zeros_like(wx)], -1),
        "gdep": np.full((h2, w2), 0.5, np.float32),
        "sm": np.broadcast_to((np.arange(32, dtype=np.float32) > 16.0)[:, None],
                              (32, 32)).astype(np.float32),
    }

    def add(pkg, builder, h):
        fog = pkg.mod("renderer.volumetric").VolumetricFog(density=0.01, anisotropy=0.4, steps=12)
        out = builder.create(pkg.mod("rhi").TextureDesc.color("fog.out", w2, h2))
        fog.render_to(builder, h["hdr"], out, cam,
                      {"pos": h["gpos"], "depth": h["gdep"], "sun_shadow": h["sm"]}, sun=None)
        return [out, h["hdr"]]

    dyn = {"def.light_vp": lvp, "def.shadow_bias": np.float32(0.001)}
    (img1, src1), (img8, _), (jimg, _) = triplet(planes, add, dynamics=dyn, tile_w=64)
    assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)


def _ssao_frame(pkg_name, mesh_n):
    """test_ssao.py's ambient-only scene (a cube on the ground) with SSAO,
    128×64, in ``pkg_name``."""
    from test_torch_spmd_twins import Pkg, device_of, mesh_of

    pkg = Pkg(pkg_name)
    rg, rhi, ren = pkg.mod("rendergraph"), pkg.mod("rhi"), pkg.mod("renderer")
    camera, mt = pkg.mod("core.camera"), pkg.mod("core.mathtypes")
    device = device_of(pkg)
    w, h = 128, 64
    scene = ren.Scene(objects=[
        ren.SceneObject.quad(device, "ground", size=120.0, z=0.0, base_color=(1.0, 1.0, 1.0, 1.0)),
        ren.SceneObject.cube(device, "box", size=16.0, z0=0.0, base_color=(1.0, 1.0, 1.0, 1.0)),
    ], sun=None, ambient=(0.5, 0.5, 0.5))
    renderer = ren.DeferredRenderer(scene, shadows=False,
                                    ssao=ren.SSAOOptions(radius=6.0, samples=16))
    cam = camera.Camera(fov_y=mt.Degree(45.0), aspect_ratio=w / h)
    cam.set_position(np.array([0.0, -55.0, 30.0], np.float32))
    cam.set_yaw_pitch(mt.Radians(0.0), mt.Radians(-0.42))
    builder = rg.RenderGraphBuilder()
    out = builder.create(rhi.TextureDesc.color("out", w, h))
    builder.export(out)
    renderer.render_to(builder, out, cam, w, h)
    compiled = builder.build().compile(
        device, rhi.PipelineCache(), rg.CompileOptions(tile_h=8, tile_w=128,
                                                       mesh=mesh_of(pkg, mesh_n)))
    compiled.execute(device)
    return np.asarray(compiled.value(out))


def test_spmd_ssao_matches_single(cpu_devices):
    """test_ssao.py:193: taps from the gathered full planes, the vertical
    blur over halo-exchanged bands. The reference's atol 2e-4 against
    single-device and against the JAX 8-device frame."""
    from test_torch_spmd_twins import PORT, REF

    sharded = _ssao_frame(PORT, 8)
    np.testing.assert_allclose(sharded, _ssao_frame(PORT, None), atol=2e-4)
    np.testing.assert_allclose(sharded, _ssao_frame(REF, 8), atol=2e-4)

"""The deferred frames of tests/test_parallel.py on the port: the deferred
scene with its glass pane (G-buffer MRT, tiled lighting, the shadow map's
get_full, the glass blend node) and the image-based-lit scene (the IBL
resolve, the environment as sky), each through
CompileOptions(mesh=default_mesh(8, device="cpu")) in row bands. The
scenes are built with the reference's API and carried across by
zenith_tpu_torch.interop.

Tolerances: atol 2e-4 against the port's single-device frame (the
reference's, test_parallel.py:474); against the JAX 8-device frame the
encoded frame ≤ 1 LSB with < 1% of values differing (the golden
tolerance: positions differ by XLA's FMA contraction, ROADMAP §3).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_parallel_frames import CPU, H, W, _lsb
from test_torch_spmd_twins import jax_mesh, run_graph
from zenith_tpu_torch import interop
from zenith_tpu_torch.parallel import default_mesh
from zenith_tpu_torch.rhi import TextureDesc

torch.set_num_threads(1)


# -- TestDeferredSharded ----------------------------------------------------------------------


def _jax_glass_scene():
    """test_deferred_scene_with_glass_sharded_matches_single's scene."""
    from zenith_tpu.core.mathtypes import mat4_translation
    from zenith_tpu.renderer.scene import DirectionalLight, PointLight, Scene, SceneObject
    from zenith_tpu.rhi import RhiCore as JCore

    device = JCore().create_render_device()
    ground = SceneObject.quad(device, "ground", size=80.0, z=0.0,
                              base_color=(0.3, 0.5, 0.3, 1.0), roughness=0.8)
    box = SceneObject.cube(device, "box", size=14.0, z0=0.0,
                           base_color=(0.8, 0.3, 0.2, 1.0), roughness=0.5)
    pane = SceneObject.quad(device, "pane", size=25.0, z=0.0,
                            base_color=(0.3, 0.4, 1.0, 0.5), translucent=True)
    rot = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    pane.model_matrix = (mat4_translation(np.array([8.0, -18.0, 10.0], np.float32))
                         @ rot).astype(np.float32)
    return Scene(
        objects=[ground, box, pane],
        sun=DirectionalLight(direction=(0.3, -0.4, 0.85), shadow_map_size=64,
                             shadow_extent=60.0),
        point_lights=[
            PointLight(position=(10.0, -10.0, 8.0), color=(1.0, 0.4, 0.2), intensity=60.0),
            PointLight(position=(-12.0, 5.0, 6.0), color=(0.2, 0.4, 1.0), intensity=60.0),
        ],
    )


def _jax_ibl_scene():
    """test_deferred_ibl_sharded_matches_single's scene."""
    from zenith_tpu.renderer import EnvironmentLight
    from zenith_tpu.renderer.scene import Scene, SceneObject
    from zenith_tpu.rhi import RhiCore as JCore

    device = JCore().create_render_device()
    env_px = np.full((6, 16, 16, 4), 0.05, np.float32)
    env_px[4, ..., 1] = 1.5  # green +Z sky
    env_px[..., 3] = 1.0
    env = EnvironmentLight.from_cube_pixels("spmd.env", env_px, num_mips=2, samples=8)
    return Scene(
        objects=[
            SceneObject.quad(device, "ground", size=80.0, z=0.0, base_color=(0.6, 0.6, 0.6, 1.0)),
            SceneObject.cube(device, "box", size=14.0, z0=0.0, base_color=(1.0, 1.0, 1.0, 1.0),
                             metallic=1.0, roughness=0.3),
        ],
        sun=None,
        environment=env,
    )


def _deferred_camera(pkg):
    import importlib

    camera = importlib.import_module(f"{pkg}.core.camera")
    mt = importlib.import_module(f"{pkg}.core.mathtypes")
    cam = camera.Camera(fov_y=mt.Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -55.0, 22.0], np.float32))
    cam.set_yaw_pitch(mt.Radians(0.0), mt.Radians(-0.3))
    return cam


@pytest.mark.parametrize("case", ["glass", "ibl"])
def test_deferred_scene_sharded_matches_single(cpu_devices, case):
    """The deferred renderer (G-buffer MRT + tiled lighting + the shadow
    map's get_full + the glass blend node; or the IBL resolve with the
    environment as sky) over 8 bands matches single-device and the JAX
    8-device frame."""
    from zenith_tpu.renderer import DeferredRenderer as JDeferred
    from zenith_tpu.rhi import TextureDesc as JTex
    from zenith_tpu_torch.renderer import DeferredRenderer

    jscene = _jax_glass_scene() if case == "glass" else _jax_ibl_scene()
    kw = {} if case == "glass" else dict(shadows=False)
    scene = interop.scene_from(jscene, CPU)

    def build(renderer, tex, pkg):
        def f(builder):
            out = builder.create(tex.color("out", W, H))
            builder.export(out)
            renderer.render_to(builder, out, _deferred_camera(pkg), W, H)
            return (out,)
        return f

    def port_graph():
        return build(DeferredRenderer(scene, **kw), TextureDesc, "zenith_tpu_torch")

    single, = run_graph("port", port_graph(), None)
    sharded, = run_graph("port", port_graph(), default_mesh(8, device="cpu"))
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=2e-4)
    if case == "ibl":
        assert single[..., 1].max() > single[..., 0].max() * 1.5  # env-lit: green dominates
    jimg, = run_graph("jax", build(JDeferred(jscene, **kw), JTex, "zenith_tpu"), jax_mesh())
    mx, frac = _lsb(sharded, jimg)
    assert mx <= 1 and frac < 0.01, (mx, frac)

"""Deferred decals on the port (tests/test_decals.py's seven cases): the
decal box's world-to-decal mapping and its degenerate up vector, then
decals rewriting the G-buffer albedo before lighting through the port's
DeferredRenderer on a ground quad at 128×64 (8×128 tiles): a solid decal
tints only inside its box, a textured decal masks by the texture's
alpha, a decal projecting along the surface fades out by the normal, and
moving a decal changes only the frame's dynamics (the frame program cache
does not grow). The stacked matrices keep their (N, 3, 4) shape.

Each case asserts on the port what the reference's asserts.
test_torch_screenspace_ops.py::test_apply_decal_matches holds the decal op
(solid and textured) against the reference's on the same G-buffer, so no
JAX frame is built here.

Tolerances: the reference's own.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zenith_tpu_torch.core.camera import Camera
from zenith_tpu_torch.core.mathtypes import Degree, Radians
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph import graph as G
from zenith_tpu_torch.rendergraph.graph import CompileOptions
from zenith_tpu_torch.renderer import (
    Decal,
    DeferredRenderer,
    DirectionalLight,
    Scene,
    SceneObject,
)
from zenith_tpu_torch.renderer.decal import stacked_decal_mats
from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, Texture, TextureDesc

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)


@pytest.fixture
def device():
    return RhiCore(CPU).create_render_device()


def make_camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def ground_scene(device, decals):
    ground = SceneObject.quad(device, "ground", size=200.0, z=0.0,
                              base_color=(0.5, 0.5, 0.5, 1.0))
    return Scene(objects=[ground],
                 sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.0,
                                      cast_shadows=False),
                 ambient=(0.1, 0.1, 0.1), decals=decals)


def render(device, scene):
    renderer = DeferredRenderer(scene, shadows=False)
    cam = make_camera()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    renderer.render_to(builder, color, cam, W, H)
    builder.export(color)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return compiled.value(color).numpy(), cam


def px_of(cam, world):
    clip = np.asarray(cam.render_view_projection, np.float32) @ np.array([*world, 1.0],
                                                                         np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


class TestWorldToDecal:
    def test_unit_box_mapping(self):
        d = Decal("d", position=(10.0, 5.0, 0.0), size=(4.0, 8.0, 2.0))
        m = d.world_to_decal()
        assert m.shape == (3, 4)

        def local(p):
            return m @ np.array([*p, 1.0], np.float32)

        np.testing.assert_allclose(local((10.0, 5.0, 0.0)), 0.0, atol=1e-6)
        # +2 world x = half the 4-wide box = +0.5 u (right = up × forward).
        np.testing.assert_allclose(local((12.0, 5.0, 0.0)), [0.5, 0.0, 0.0], atol=1e-6)
        # forward (0, 0, -1): +1 world z over a depth extent of 2 → -0.5.
        np.testing.assert_allclose(local((10.0, 5.0, 1.0)), [0.0, 0.0, -0.5], atol=1e-6)

    def test_degenerate_up_recovers(self):
        m = Decal("d", forward=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0)).world_to_decal()
        assert np.all(np.isfinite(m))


class TestDecalRendering:
    def test_solid_decal_tints_ground_inside_only(self, device):
        decal = Decal("mark", position=(0.0, 0.0, 0.0), size=(20.0, 20.0, 4.0),
                      color=(1.0, 0.0, 0.0, 1.0))
        img, cam = render(device, ground_scene(device, [decal]))
        iy, ix = px_of(cam, (0.0, 0.0, 0.0))  # the decal's centre
        oy, ox = px_of(cam, (40.0, 0.0, 0.0))  # open ground
        c_in, c_out = img[iy, ix, :3], img[oy, ox, :3]
        assert c_in[0] > c_in[1] * 2.0, c_in  # inside: red dominates
        np.testing.assert_allclose(c_out[0], c_out[1], rtol=0.05)  # outside: grey

    def test_textured_decal_alpha_masks(self, device):
        # Left half opaque green, right half fully transparent.
        texels = np.zeros((8, 8, 4), np.float32)
        texels[:, :4] = (0.0, 1.0, 0.0, 1.0)
        tex = Texture.from_numpy("decal.tex", texels, Format.RGBA32F, device=CPU)
        decal = Decal("stripe", position=(0.0, 0.0, 0.0), size=(40.0, 40.0, 4.0), texture=tex,
                      up=(0.0, 1.0, 0.0))
        img, cam = render(device, ground_scene(device, [decal]))
        gy, gx = px_of(cam, (-10.0, 0.0, 0.0))  # u < 0.5: green
        ny, nx = px_of(cam, (10.0, 0.0, 0.0))  # u > 0.5: grey ground
        assert img[gy, gx, 1] > img[gy, gx, 0] * 2.0, img[gy, gx]
        np.testing.assert_allclose(img[ny, nx, 0], img[ny, nx, 1], rtol=0.05)

    def test_normal_fade_rejects_perpendicular_surface(self, device):
        # A decal projecting along -x onto the ground (normal +z): alignment
        # 0, so it fades out fully and the ground stays untouched.
        decal = Decal("side", position=(0.0, 0.0, 0.0), size=(30.0, 30.0, 30.0),
                      forward=(-1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0), color=(1.0, 0.0, 0.0, 1.0))
        img, cam = render(device, ground_scene(device, [decal]))
        iy, ix = px_of(cam, (0.0, 0.0, 0.0))
        c = img[iy, ix, :3]
        np.testing.assert_allclose(c[0], c[1], rtol=0.05)

    def test_moving_decal_is_a_dynamic(self, device):
        """Moving a decal changes only the dynamics: the same frame program."""
        decal = Decal("mark", position=(0.0, 0.0, 0.0), size=(16.0, 16.0, 4.0),
                      color=(0.0, 0.0, 1.0, 1.0))
        renderer = DeferredRenderer(ground_scene(device, [decal]), shadows=False)
        cam = make_camera()
        cache = PipelineCache()

        def one_frame():
            builder = RenderGraphBuilder()
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            builder.export(color)
            compiled = builder.build().compile(device, cache, OPTS)
            compiled.execute(device)
            return compiled.value(color).numpy()

        img0 = one_frame()
        n_programs = len(G._FRAME_PROGRAM_CACHE)
        decal.position = (20.0, 0.0, 0.0)
        img1 = one_frame()
        assert len(G._FRAME_PROGRAM_CACHE) == n_programs, "moving the decal recompiled"
        y0, x0 = px_of(cam, (0.0, 0.0, 0.0))
        y1, x1 = px_of(cam, (20.0, 0.0, 0.0))
        assert img0[y0, x0, 2] > img0[y0, x0, 0] * 1.5
        assert img1[y1, x1, 2] > img1[y1, x1, 0] * 1.5
        assert img1[y0, x0, 2] < img1[y0, x0, 0] * 1.5  # the old spot is clean

    def test_stacked_mats_shape(self):
        ds = [Decal("a"), Decal("b", position=(1, 2, 3))]
        assert stacked_decal_mats(ds).shape == (2, 3, 4)

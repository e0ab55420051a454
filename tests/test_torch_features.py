"""The port's screen-space feature frames: the six goldens of
tests/test_golden_features.py (SSR, volumetric fog, the atmosphere sky, lens
flare, contact shadows, decals) rendered by the port through
``sandbox.scene.feature_golden_scene``, and SSAO, which has no golden,
against one JAX deferred frame carried across by ``interop``.

Tolerance: the encoded frame ≤ 1 LSB with < 1% of values differing (the
reference's own golden tolerance), against each golden file and against the
JAX SSAO frame. Each golden must differ from the port's base frame (the same
scene with no feature), and so must the port's feature frame: a golden equal
to the base would pin nothing. The reference renders one frame here (SSAO);
the goldens pin the other six.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch import interop
from zenith_tpu_torch.rhi import Format as TFormat, RhiCore as TCore, encode_present
from zenith_tpu_torch.sandbox.scene import FEATURE_GOLDENS, feature_golden_frame

sys.path.insert(0, str(Path(__file__).parent))
torch.set_num_threads(1)
CPU = torch.device("cpu")
GOLDEN_DIR = Path(__file__).parent / "golden"


def _lsb(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.fixture(scope="module")
def device():
    return TCore(CPU).create_render_device()


@pytest.fixture(scope="module")
def base(device):
    return feature_golden_frame(device, "base").numpy()


@pytest.mark.parametrize("cfg", FEATURE_GOLDENS)
def test_feature_frame_matches_its_golden(device, cfg):
    img = feature_golden_frame(device, cfg).numpy()
    golden = np.load(GOLDEN_DIR / f"feat_{cfg}_128x64.npy")
    assert img.shape == golden.shape == (64, 128, 4) and img.dtype == np.uint8
    mx, frac = _lsb(img, golden)
    assert mx <= 1 and frac < 0.01, (cfg, mx, frac)


@pytest.mark.parametrize("cfg", FEATURE_GOLDENS)
def test_feature_golden_and_frame_differ_from_the_base(device, base, cfg):
    golden = np.load(GOLDEN_DIR / f"feat_{cfg}_128x64.npy")
    assert (golden != base).any(), f"{cfg} golden equals the port's base frame"
    assert (feature_golden_frame(device, cfg).numpy() != base).any(), cfg


def test_film_has_no_port_yet(device):
    """Film was the last unported feature golden; it is ported (item 21.5)
    and pinned with the others above, and a name with no golden (the
    reference has none for depth of field) raises."""
    assert "film" in FEATURE_GOLDENS
    with pytest.raises(ValueError, match="no feature golden 'dof'"):
        feature_golden_frame(device, "dof")


def _jax_ssao_frame(options):
    """The reference's deferred golden scene with SSAO, through PostProcess."""
    from test_renderers import H, OPTS, W, build_test_scene, make_camera

    from zenith_tpu.renderer import DeferredRenderer, PostProcess
    from zenith_tpu.rendergraph import RenderGraphBuilder
    from zenith_tpu.rhi import Format, PipelineCache, RhiCore, TextureDesc
    from zenith_tpu.rhi import encode_present as jencode
    from zenith_tpu.sandbox.scene import sky_cube_texture

    device = RhiCore().create_render_device()
    scene = dataclasses.replace(build_test_scene(device, num_lights=8),
                                skybox=sky_cube_texture(16))
    renderer = DeferredRenderer(scene, ssao=options)
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    builder.export(out)
    builder.export(hdr)
    renderer.render_to(builder, hdr, make_camera(), W, H)
    PostProcess().render_to(builder, hdr, out)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return (scene, np.asarray(jencode(compiled.value(out), Format.RGBA8_SRGB)),
            np.asarray(compiled.value(hdr)))


def test_ssao_frame_matches_the_reference(device, base):
    """The reference's deferred golden scene with SSAO (radius 6, as
    SceneApp --ssao sets it; 12 samples), carried across by interop: the
    frame ≤ 1 LSB / < 1% of the JAX frame, darker than the frame without
    AO where it differs, and the AO reaches the HDR frame (rtol 1e-2, the
    deferred frame's tolerance, tests/test_torch_deferred.py)."""
    from zenith_tpu.renderer import SSAOOptions as JOptions
    from zenith_tpu_torch.renderer import DeferredRenderer
    from zenith_tpu_torch.sandbox.scene import deferred_frame, golden_scene
    from zenith_tpu_torch.rendergraph import CompileOptions

    jopts = JOptions(radius=6.0)
    jscene, jimg, jhdr = _jax_ssao_frame(jopts)
    opts = interop.ssao_options_from(jopts)
    assert opts.__zenith_capture_key__() == jopts.__zenith_capture_key__()
    _, cam = golden_scene(device)
    renderer = DeferredRenderer(interop.scene_from(jscene, CPU), ssao=opts)
    compiled, out, hdr, _ = deferred_frame(device, renderer, cam, 128, 64,
                                           CompileOptions(tile_h=8, tile_w=128),
                                           exports=("hdr",))
    img = encode_present(compiled.value(out), TFormat.RGBA8_SRGB).numpy()
    mx, frac = _lsb(img, jimg)
    assert mx <= 1 and frac < 0.01, (mx, frac)
    np.testing.assert_allclose(compiled.value(hdr).numpy(), jhdr, rtol=1e-2, atol=1e-3)
    changed = (img != base).any(-1)
    assert changed.sum() > 20  # the AO darkens the cube's foot and edges
    assert img[..., :3][changed].astype(int).sum() < base[..., :3][changed].astype(int).sum()


def test_interop_carries_the_feature_settings():
    """Settings objects and a scene's sky, decals and contact fields cross
    by their fields."""
    from zenith_tpu.ops.atmosphere import Atmosphere
    from zenith_tpu.renderer import LensFlare, ScreenSpaceReflections, VolumetricFog
    from zenith_tpu.renderer.decal import Decal
    from zenith_tpu.renderer.scene import DirectionalLight, Scene

    ssr = ScreenSpaceReflections(steps=9, refine=2, max_distance=80.0, thickness=1.5,
                                 strength=0.8, max_roughness=0.5, jitter=False)
    t_ssr = interop.ssr_from(ssr)
    assert t_ssr.__zenith_capture_key__() == ssr.__zenith_capture_key__()
    np.testing.assert_array_equal(t_ssr._params(), ssr._params())
    fog = VolumetricFog(density=0.01, height=3.0, steps=8, shafts=False)
    t_fog = interop.fog_from(fog)
    assert t_fog.__zenith_capture_key__() == fog.__zenith_capture_key__()
    np.testing.assert_array_equal(t_fog._params(), fog._params())
    flare = LensFlare(intensity=0.3, streak=0.0, probe_px=4)
    assert interop.flare_from(flare).__zenith_capture_key__() == flare.__zenith_capture_key__()
    scene = Scene(sun=DirectionalLight(contact_shadows=True, contact_steps=5,
                                       contact_distance=4.5),
                  atmosphere=Atmosphere(steps=6, mie_g=0.5),
                  decals=[Decal("d", position=(1.0, 2.0, 0.0), color=(0.1, 0.2, 0.3, 0.4))])
    t_scene = interop.scene_from(scene, CPU)
    sun = t_scene.sun
    assert (sun.contact_shadows, sun.contact_steps, sun.contact_distance) == (True, 5, 4.5)
    assert t_scene.atmosphere.__zenith_capture_key__() == scene.atmosphere.__zenith_capture_key__()
    np.testing.assert_array_equal(t_scene.atmosphere.packed(3.0), scene.atmosphere.packed(3.0))
    np.testing.assert_array_equal(t_scene.decals[0].world_to_decal(),
                                  scene.decals[0].world_to_decal())
    assert t_scene.decals[0].color == (0.1, 0.2, 0.3, 0.4)

"""Validate-mode checks and interop in the port: the render graph's
capture self-check and the swapchain's stale-slot warning under
ZENITH_VALIDATE=1 (twins of tests/test_rendergraph.py::
TestCaptureSelfCheck and tests/test_rhi.py::TestSwapchain::
test_pre_encoded_explicit_and_stale_slot_warning), and interop carrying
the shadow settings of the sun and the point lights across.
"""

import logging

import numpy as np
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_mutated_big_capture_warns_on_cadence(monkeypatch, caplog):
    """Twin of TestCaptureSelfCheck::test_mutated_big_capture_warns_on_cadence:
    a big host array captured by a closure keys the structure by shape only;
    when its content changes under the cached frame function, every 64th
    cache hit checks and warns."""
    import zenith_tpu_torch.rendergraph.graph as G
    from zenith_tpu_torch.rendergraph import RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, RhiCore, TextureDesc

    monkeypatch.setenv("ZENITH_VALIDATE", "1")
    monkeypatch.setattr(G, "_SELFCHECK_TICK", 0)
    monkeypatch.setattr(G, "_DEEP_FP_CACHE", {})
    device = RhiCore(CPU).create_render_device()
    pcache = PipelineCache()
    big = np.zeros((1000,), np.float32)

    def build():
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("o", 8, 8))
        builder.export(out)
        node = builder.add_lambda_node("n")
        dst = node.write(out)

        def record(ctx):
            ctx.set(dst, torch.zeros((8, 8, 4)) + float(big[0]) * 0)

        node.execute(record)
        return builder.build()

    with caplog.at_level(logging.WARNING):
        for _ in range(70):
            build().compile(device, pcache)
        assert not any("self-check" in r.message for r in caplog.records)
        big[:] = 7.0  # in-place: the same shape, a stale frame function
        for _ in range(70):
            build().compile(device, pcache)
    assert any("self-check" in r.message for r in caplog.records)


def test_pre_encoded_explicit_and_stale_slot_warning(caplog, monkeypatch):
    """Twin of TestSwapchain::test_pre_encoded_explicit_and_stale_slot_warning:
    pre-encoding is explicit (``pre_encoded=``) with the dtype as fallback,
    and validate mode warns once about the stale-slot LOAD trap."""
    from zenith_tpu_torch.rhi import RhiCore, Swapchain, SwapchainConfig

    monkeypatch.setenv("ZENITH_VALIDATE", "1")
    device = RhiCore(CPU).create_render_device()
    delivered = []
    sc = Swapchain(device, SwapchainConfig(width=8, height=4, num_images=2),
                   on_present=lambda img, idx: delivered.append(img))
    sc.acquire_next_image()
    pre = torch.zeros((4, 8, 4), dtype=torch.uint8)
    with caplog.at_level(logging.WARNING):
        sc.present(pre)  # inferred pre-encoded: warns
        sc.acquire_next_image()
        sc.present(pre, pre_encoded=True)  # explicit: no second warning
    assert len([r for r in caplog.records if "LINEAR contents" in r.message]) == 1
    sc.flush()
    assert delivered[0].dtype == np.uint8
    sc.acquire_next_image()
    sc.present(torch.zeros((4, 8, 4), dtype=torch.uint8), pre_encoded=False)
    sc.flush()


def test_interop_carries_the_shadow_settings():
    from zenith_tpu.renderer import DirectionalLight, PointLight, Scene

    from zenith_tpu_torch import interop

    sun = DirectionalLight(cascades=3, soft_shadows=True, vsm_blur=5,
                           vsm_bleed_reduction=0.3, cascade_lambda=0.6)
    pl = PointLight(position=(1.0, 2.0, 3.0), cast_shadows=True, shadow_map_size=128,
                    shadow_near=0.5, shadow_bias=0.07)
    port = interop.scene_from(Scene(objects=[], sun=sun, point_lights=[pl]), CPU)
    for field in ("cascades", "soft_shadows", "vsm_blur", "vsm_bleed_reduction",
                  "cascade_lambda"):
        assert getattr(port.sun, field) == getattr(sun, field), field
    for field in ("cast_shadows", "shadow_map_size", "shadow_near", "shadow_bias"):
        assert getattr(port.point_lights[0], field) == getattr(pl, field), field

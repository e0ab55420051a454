"""Vertex-input declarations and their validation on the port
(tests/test_vertex_inputs.py's twelve cases): the port's
``GraphicPipeline._validate_vertex_inputs`` (rhi/pipeline.py) at pipeline
build and through ``PipelineCache``, the draw-time checks of
``ops.draw.draw_indexed`` (an undeclared attribute the shader reads, a
declared per-instance input the draw does not provide) and the
validate-mode warning for a binding that is declared but never read.

Each case asserts what the reference's does: the same accepts, the same
``BindingError`` naming the same attribute, the warning only under
``ZENITH_VALIDATE=1``. Nothing here runs the JAX package: both sides are
host-side checks with the same messages.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops import draw as draw_mod
from zenith_tpu_torch.ops.binning import TileGrid
from zenith_tpu_torch.rhi import (
    Format,
    GraphicPipelineAttachments,
    GraphicShaderInput,
    PipelineCache,
    Shader,
    attr,
    uniform,
)
from zenith_tpu_torch.rhi.pipeline import GraphicPipeline, GraphicPipelineDesc
from zenith_tpu_torch.rhi.shader import BindingError
from zenith_tpu_torch.rhi.state import GraphicPipelineState, VertexLayout

torch.set_num_threads(1)
LAYOUT = VertexLayout.from_fields(("position", 3), ("color", 3))


def _vs_fn(attrs, res):
    p = attrs["position"]
    return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1), "color": attrs["color"]}


def _desc(vs, layout=LAYOUT):
    return GraphicPipelineDesc(
        shader_input=GraphicShaderInput(vs, None, layout),
        state=GraphicPipelineState(),
        attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,)),
    )


class TestPipelineTimeValidation:
    def test_matching_inputs_pass(self):
        vs = Shader.vertex("vs", _vs_fn, inputs=[attr("position", 3), attr("color", 3)])
        GraphicPipeline(_desc(vs))  # no raise

    def test_missing_attribute_rejected(self):
        vs = Shader.vertex("vs.miss", _vs_fn, inputs=[attr("position", 3), attr("tangent", 4)])
        with pytest.raises(BindingError, match="tangent"):
            GraphicPipeline(_desc(vs))

    def test_wrong_width_rejected(self):
        vs = Shader.vertex("vs.width", _vs_fn, inputs=[attr("position", 4), attr("color", 3)])
        with pytest.raises(BindingError, match="position"):
            GraphicPipeline(_desc(vs))

    def test_extra_layout_attributes_allowed(self):
        vs = Shader.vertex("vs.sub", _vs_fn, inputs=[attr("position", 3)])
        GraphicPipeline(_desc(vs))  # a layout superset is fine

    def test_no_layout_with_declared_inputs_rejected(self):
        vs = Shader.vertex("vs.nolayout", _vs_fn, inputs=[attr("position", 3)])
        with pytest.raises(BindingError, match="no vertex layout"):
            GraphicPipeline(_desc(vs, layout=None))

    def test_undeclared_inputs_skip_validation(self):
        vs = Shader.vertex("vs.legacy", _vs_fn)  # inputs=None
        GraphicPipeline(_desc(vs))

    def test_per_instance_inputs_skip_layout_check(self):
        vs = Shader.vertex("vs.inst", _vs_fn,
                           inputs=[attr("position", 3), attr("inst_offset", 3, per_instance=True)])
        GraphicPipeline(_desc(vs))  # inst_offset not in the layout: fine

    def test_error_surfaces_through_pipeline_cache(self):
        vs = Shader.vertex("vs.cache", _vs_fn, inputs=[attr("nope", 2)])
        with pytest.raises(BindingError, match="nope"):
            PipelineCache().get_or_create(_desc(vs))


class TestDrawTimeChecks:
    def _draw(self, vs, resources=None, instance_count=1, instance_data=None):
        pipe = GraphicPipeline(_desc(vs))
        grid = TileGrid(width=128, height=32, tile_h=32, tile_w=128)
        vb = np.zeros((3, 6), np.float32)
        vb[:, :3] = [[-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.5, 0.5]]
        ib = np.array([0, 1, 2], np.int32)
        colors = [torch.zeros((32, 128, 4), dtype=torch.float32)]
        return draw_mod.draw_indexed(
            colors, None, pipe, torch.from_numpy(vb), torch.from_numpy(ib), resources or {},
            grid, instance_count=instance_count, instance_data=instance_data)

    def test_missing_attr_named_error_at_draw(self):
        def bad_vs(attrs, res):
            p = attrs["position"]
            attrs["tangent"]  # not in the layout
            return {"position": torch.cat([p, torch.ones_like(p[:, :1])], 1)}

        vs = Shader.vertex("vs.bad", bad_vs)  # undeclared → draw-time error
        with pytest.raises(BindingError, match="tangent"):
            self._draw(vs)

    def test_missing_instance_data_rejected(self):
        vs = Shader.vertex("vs.inst2", _vs_fn,
                           inputs=[attr("position", 3), attr("inst_offset", 3, per_instance=True)])
        with pytest.raises(BindingError, match="inst_offset"):
            self._draw(vs, instance_count=2, instance_data={})

    def test_unused_binding_warns_under_validate(self, caplog, monkeypatch):
        monkeypatch.setenv("ZENITH_VALIDATE", "1")
        monkeypatch.setattr(draw_mod, "_UNUSED_WARNED", set())
        vs = Shader.vertex("vs.unused", _vs_fn, bindings=[uniform("NeverRead")],
                           inputs=[attr("position", 3), attr("color", 3)])
        with caplog.at_level(logging.WARNING):
            self._draw(vs, resources={"NeverRead": torch.zeros((4,))})
        assert any("NeverRead" in r.message for r in caplog.records)

    def test_no_unused_warning_when_validation_off(self, caplog, monkeypatch):
        monkeypatch.setenv("ZENITH_VALIDATE", "0")
        monkeypatch.setattr(draw_mod, "_UNUSED_WARNED", set())
        vs = Shader.vertex("vs.unused2", _vs_fn, bindings=[uniform("NeverRead")],
                           inputs=[attr("position", 3), attr("color", 3)])
        with caplog.at_level(logging.WARNING):
            self._draw(vs, resources={"NeverRead": torch.zeros((4,))})
        assert not any("NeverRead" in r.message for r in caplog.records)

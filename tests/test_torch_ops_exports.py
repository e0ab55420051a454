"""The public API of the port's ``ops`` package against the reference's:
``zenith_tpu_torch.ops.__all__`` holds every name of ``zenith_tpu.ops.__all__``
apart from the names in NOT_PORTED, each with the ROADMAP item that ports
it, and each name that both export is the same kind of object (a module, a
class or a function). The port's ``renderer.__all__`` names only what the
reference's exports, and ``ops.draw`` has the reference's standard sample
positions, each inside [0, 1)², the offsets the CUDA rasters accept."""

import inspect

import pytest

import zenith_tpu.ops as ref_ops
import zenith_tpu.ops.draw as ref_draw
import zenith_tpu.renderer as ref_renderer
import zenith_tpu_torch.ops as port_ops
import zenith_tpu_torch.ops.draw as port_draw
import zenith_tpu_torch.renderer as port_renderer

# Names of zenith_tpu.ops.__all__ the port does not export yet, each with the
# ROADMAP item that ports it. Empty: every name is ported.
NOT_PORTED: "dict[str, str]" = {}


def test_not_ported_names_are_reference_names_the_port_lacks():
    for name, item in NOT_PORTED.items():
        assert name in ref_ops.__all__ and name not in port_ops.__all__, name
        assert item.startswith("ROADMAP item "), (name, item)


@pytest.mark.parametrize("name", sorted(set(ref_ops.__all__) - set(NOT_PORTED)))
def test_port_exports_the_reference_name(name):
    assert name in port_ops.__all__
    ref, port = getattr(ref_ops, name), getattr(port_ops, name)
    for kind in (inspect.ismodule, inspect.isclass, callable):
        assert kind(port) == kind(ref), (name, kind.__name__)


def test_port_renderer_names_are_reference_names():
    assert set(port_renderer.__all__) <= set(ref_renderer.__all__)
    assert "ForwardShadowRenderer" in port_renderer.__all__


def test_sample_positions_equal_the_reference_and_lie_in_the_unit_square():
    assert port_draw.SAMPLE_POSITIONS == ref_draw.SAMPLE_POSITIONS
    for samples, offsets in port_draw.SAMPLE_POSITIONS.items():
        assert len(offsets) == samples
        assert all(0.0 <= o < 1.0 for off in offsets for o in off), samples
    assert callable(port_draw.assemble_lines)

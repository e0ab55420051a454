"""The public API of the port's ``ops`` package against the reference's:
``zenith_tpu_torch.ops.__all__`` holds every name of ``zenith_tpu.ops.__all__``
apart from the names in NOT_PORTED, each with the ROADMAP item that ports
it, and each name that both export is the same kind of object (a module, a
class or a function)."""

import inspect

import pytest

import zenith_tpu.ops as ref_ops
import zenith_tpu_torch.ops as port_ops

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

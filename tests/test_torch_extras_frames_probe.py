"""A whole 128×64 frame of a scene lit by its own reflection probe: the JAX
graph and the port's on the same scene, through
test_torch_extras_frames.py's ``check_frame`` (its docstring gives the
tolerance)."""

import pytest

from test_torch_extras_frames import check_frame


@pytest.mark.parametrize("case", ["probe"])
def test_frame_matches_the_jax_frame(case):
    check_frame(case)

"""A whole 128×64 frame of TAA with the velocity plane and motion blur over
four instanced rocks, after three fed-back frames of a moving camera: the
JAX graph and the port's on the same scene, through
test_torch_extras_frames.py's ``check_frame`` (its docstring gives the
tolerance)."""

import pytest

from test_torch_extras_frames import check_frame


@pytest.mark.parametrize("case", ["temporal"])
def test_frame_matches_the_jax_frame(case):
    check_frame(case)

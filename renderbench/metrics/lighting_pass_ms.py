"""renderer nodes: device time a frame under the ``lighting`` node scope,
from the profile with host operators."""


def read(trace):
    us = trace["scope_device_us"].get("lighting", 0.0)
    return us / 1e3 / trace["frames"] if us > 0 else None

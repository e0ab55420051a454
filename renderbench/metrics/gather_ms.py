"""ops: device time a frame of the gather kernels (kernel names holding
``gather``), from the kernels-only profile."""


def read(trace):
    us = sum(b - a for name, a, b in trace["kernels"] if "gather" in name)
    return us / 1e3 / trace["frames"] if us > 0 else None

"""device: milliseconds a frame in which some kernel ran (the union of the
kernels-only profile's device spans over its frames). Beside ``fps`` of
an untraced run it gives that run's idle share, 1 - busy_ms · fps / 1000,
which the traced window (slowed on the host by the profiler) overstates."""

import roofline


def read(trace):
    spans = [(a, b) for _, a, b in trace["kernels"]]
    if not spans:
        return None
    return roofline.union_us(spans) / 1e3 / trace["frames"]

"""device: the share of the traced window in which no kernel ran, 1 - the
union of the kernels-only profile's device spans over the window's host
time."""

import roofline


def read(trace):
    spans = [(a, b) for _, a, b in trace["kernels"]]
    if not spans or trace["window_s"] <= 0:
        return None
    busy_s = roofline.union_us(spans) / 1e6
    return max(0.0, 1.0 - busy_s / trace["window_s"]) * 100.0

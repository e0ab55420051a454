"""kernels (K2): the point-light kernel's share of its roofline, the bound
of one recorded frame's K2 calls (``roofline.k2_bound`` on its G-buffer and
lights) over K2's device time a frame in the kernels-only profile."""

KERNEL = "tiled_lights_kernel"


def read(trace):
    spans = [(a, b) for name, a, b in trace["kernels"] if KERNEL in name]
    if not spans or not trace["k2_calls"]:
        return None
    device_ms = sum(b - a for a, b in spans) / 1e3 / trace["frames"]
    bound_ms = sum(c["bound_ms"] for c in trace["k2_calls"])
    return bound_ms / device_ms * 100.0

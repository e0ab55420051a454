"""kernels (K1): the raster kernel's share of its roofline, the bounds of
one recorded frame's K1 calls (``roofline.k1_bound`` on each call's bins)
over K1's device time a frame in the kernels-only profile."""

KERNEL = "raster_segmented_kernel"


def read(trace):
    spans = [(a, b) for name, a, b in trace["kernels"] if KERNEL in name]
    if not spans or not trace["k1_calls"]:
        return None
    device_ms = sum(b - a for a, b in spans) / 1e3 / trace["frames"]
    bound_ms = sum(c["bound_ms"] for c in trace["k1_calls"])
    return bound_ms / device_ms * 100.0

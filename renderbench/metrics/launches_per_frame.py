"""render graph: kernel launches a frame, the ``cudaLaunchKernel`` /
``cuLaunchKernel`` calls of the profile with host operators."""


def read(trace):
    if not trace["launches"]:
        return None
    return trace["launches"] / trace["frames"]

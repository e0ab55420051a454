"""renderer nodes: device time a frame under the shadow and G-buffer node
scopes (``shadow*``, ``gbuffer*``, the instanced ``.inst`` passes with
them), from the profile with host operators."""


def read(trace):
    us = sum(v for k, v in trace["scope_device_us"].items()
             if k.startswith(("shadow", "gbuffer")))
    return us / 1e3 / trace["frames"] if us > 0 else None

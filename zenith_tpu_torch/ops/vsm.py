"""Variance shadow maps: prefilterable soft shadows (torch port of
zenith_tpu/ops/vsm.py).

Classic PCF sharpens with map resolution but can't be blurred (the compare
is nonlinear); VSM stores the depth distribution's first two moments,
which blur linearly, so a soft penumbra is a gaussian over the moment
planes, here shifted adds (rolls) only. The lookup stays one bilinear
fetch (4 gathers, as the 2x2 PCF) and the visibility is Chebyshev's
inequality:

    p_max = sigma² / (sigma² + (d - mu)²)       for d > mu, else 1

Light bleeding (the classic VSM artifact behind overlapping occluders) is
clamped by rescaling p_max below ``bleed_reduction`` to zero.

The moments are derived from the ordinary shadow depth map inside the
lighting node per frame: no extra render pass, no extra graph resource.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zenith_tpu_torch.ops.sampling import sample_2d
from zenith_tpu_torch.rhi.sampler import AddressMode, SamplerConfig

_CLAMPED = SamplerConfig(address_mode_u=AddressMode.CLAMP_TO_EDGE,
                         address_mode_v=AddressMode.CLAMP_TO_EDGE)


def depth_to_moments(depth: torch.Tensor, taps: int = 3) -> torch.Tensor:
    """(S, S) regular-z shadow depth → (S, S, 2) gaussian-blurred moments
    (E[z], E[z²]). ``taps`` is the blur radius per axis (binomial weights
    via repeated box passes of shifted adds), run on an edge-padded copy
    and cropped so that no moment wraps from one border onto the other."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    m = torch.stack([depth, depth * depth], dim=-1)
    pad = taps + 1  # the blur reaches `taps` texels; +1 keeps wrapped values out
    m = F.pad(m.permute(2, 0, 1)[None], (pad, pad, pad, pad), mode="replicate")[0]
    m = m.permute(1, 2, 0)
    for axis in (0, 1):
        for _ in range(taps):
            m = (m + torch.roll(m, 1, dims=axis) + torch.roll(m, -1, dims=axis)) / 3.0
    return m[pad:-pad, pad:-pad]


def sample_vsm(
    moments: torch.Tensor,  # (S, S, 2) blurred moments
    uv: torch.Tensor,  # (..., 2)
    ref_z: torch.Tensor,  # (...,) receiver depth (regular z)
    min_variance: float = 2e-5,
    bleed_reduction: float = 0.4,
) -> torch.Tensor:
    """Chebyshev visibility in [0, 1] from one bilinear moment fetch."""
    m = sample_2d(moments, uv, _CLAMPED)
    mu = m[..., 0]
    var = torch.clamp(m[..., 1] - mu * mu, min=min_variance)
    d = ref_z - mu
    p_max = var / (var + d * d)
    # Light-bleeding reduction: everything below the floor is shadow.
    p_max = torch.clamp((p_max - bleed_reduction) / (1.0 - bleed_reduction), 0.0, 1.0)
    return torch.where(ref_z <= mu, torch.ones_like(p_max), p_max)

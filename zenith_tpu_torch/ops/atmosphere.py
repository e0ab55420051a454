"""Procedural atmosphere: single-scattering Rayleigh + Mie sky (torch port
of zenith_tpu/ops/atmosphere.py).

The Nishita-style integral: march the view ray through a spherical
atmosphere, accumulating in-scattered sunlight attenuated by the optical
depth to the camera and to the sun. The march is a host-unrolled loop of
elementwise (H, W) math (12 view steps × 4 light steps by default); the
live knobs (sun intensity, density multipliers, Mie anisotropy, sun-disk
boost, camera height) ride one packed (6,) dynamic.

Rounding. The sky works at planet scale in float32: ``oz*oz - R*R`` and
``b*b - c`` subtract numbers near 4·10^13, whose float32 spacing is about
4·10^6, so how the products round decides the ground hit near the horizon.
The reference's compiled frame contracts these multiply-adds into fused
multiply-adds; ``_fma`` rounds them the same way (the float32 product is
exact in float64, and the float64 sum is cast once), as ops/geometry's
``_lerp_fma`` does for the near clip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Earth-ish defaults (meters).
_BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
_BETA_MIE = 3.996e-6


@dataclass
class Atmosphere:
    """Sky config (atmosphere.py:36-89). Static fields (the march step
    counts, the planetary geometry and scattering coefficients) shape the
    frame function; the dynamic ones (``sun_intensity``, ``rayleigh_mult``,
    ``mie_mult``, ``mie_g``, ``disk_intensity``, and the camera height,
    computed per frame by :meth:`packed`) ride the packed ``atmo`` dynamic.
    ``units_to_m`` maps scene units to meters for the camera height."""

    # -- static ------------------------------------------------------------
    steps: int = 12
    light_steps: int = 4
    planet_radius: float = 6371e3
    atmosphere_radius: float = 6471e3
    rayleigh_scale_height: float = 8500.0
    mie_scale_height: float = 1200.0
    beta_rayleigh: tuple = _BETA_RAYLEIGH
    beta_mie: float = _BETA_MIE
    # Mie extinction = scatter * (1 + absorb_factor).
    mie_absorb_factor: float = 0.11
    sun_angular_radius_deg: float = 0.27
    units_to_m: float = 1.0
    # -- dynamic -----------------------------------------------------------
    sun_intensity: float = 22.0
    rayleigh_mult: float = 1.0
    mie_mult: float = 1.0
    mie_g: float = 0.76
    disk_intensity: float = 100.0

    def __zenith_capture_key__(self):
        # Static fields only: the knobs ride the packed dynamic.
        return ("atmosphere", self.steps, self.light_steps,
                self.planet_radius, self.atmosphere_radius,
                self.rayleigh_scale_height, self.mie_scale_height,
                tuple(self.beta_rayleigh), self.beta_mie,
                self.mie_absorb_factor, self.sun_angular_radius_deg,
                self.units_to_m)

    def packed(self, camera_height: float) -> np.ndarray:
        """The per-frame dynamic: [sun_I, rayleigh_mult, mie_mult, g,
        disk_I, camera_height_m]. ``camera_height`` in scene units."""
        h_m = max(float(camera_height) * self.units_to_m, 2.0)
        return np.asarray(
            [self.sun_intensity, self.rayleigh_mult, self.mie_mult,
             self.mie_g, self.disk_intensity, h_m],
            np.float32,
        )


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as the fused multiply-add the compiled
    reference computes (exact product in float64, one rounding of the sum
    to float32 except at a float32 tie)."""
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b.double() + c).to(torch.float32)


def sky_radiance(dirs: torch.Tensor, sun_dir: torch.Tensor, params: torch.Tensor,
                 cfg: Atmosphere) -> torch.Tensor:
    """HDR sky radiance for normalized view rays (atmosphere.py:91-185).

    ``dirs``: (..., 3) unit view directions (Z-up world). ``sun_dir``: (3,)
    unit vector toward the sun. ``params``: the (6,) packed dynamic from
    :meth:`Atmosphere.packed`. Returns (..., 3) linear HDR. Rays that hit
    the planet march only to the ground hit."""
    f32 = torch.float32
    dev = dirs.device
    sun_i, ray_mult, mie_mult, g, disk_i, cam_h = (params[k] for k in range(6))
    rp, ra = cfg.planet_radius, cfg.atmosphere_radius
    hr, hm = cfg.rayleigh_scale_height, cfg.mie_scale_height
    # float32 coefficients times the device multiplier, stacked on the card
    # (no host constant is copied inside a frame).
    beta_r = torch.stack([ray_mult * float(np.float32(c)) for c in cfg.beta_rayleigh])
    beta_m_s = cfg.beta_mie * mie_mult
    beta_m_e = beta_m_s * (1.0 + cfg.mie_absorb_factor)
    ra2 = float(np.float32(ra * ra))
    rp2 = float(np.float32(rp * rp))

    rx, ry, rz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    sx, sy, sz = sun_dir[0], sun_dir[1], sun_dir[2]
    oz = rp + cam_h  # camera on the +z axis of the planet

    # Ray-sphere: origin (0, 0, oz), |o + t·d|² = R². b = o·d = oz·dz.
    b = oz * rz
    c_atmo = _fma(oz, oz, -ra2)  # < 0: the camera starts inside
    t_exit = -b + torch.sqrt(torch.clamp(_fma(b, b, -c_atmo), min=0.0))
    c_gnd = _fma(oz, oz, -rp2)
    disc_g = _fma(b, b, -c_gnd)
    t_gnd = -b - torch.sqrt(torch.clamp(disc_g, min=0.0))
    hits_ground = (disc_g > 0.0) & (t_gnd > 0.0)
    t_end = torch.where(hits_ground, t_gnd, t_exit)
    dt = t_end / float(cfg.steps)

    # The sun-disk window below turns one rounding of mu into a visible step:
    # mu is rounded as the compiled reference contracts it (the second
    # product rounded, then two fused multiply-adds).
    mu = _fma(rz, sz, _fma(rx, sx, ry * sy))
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g2 = g * g
    phase_m = (3.0 / (8.0 * np.pi)) * ((1.0 - g2) * (1.0 + mu * mu)) / (
        (2.0 + g2) * torch.pow(1.0 + g2 - 2.0 * g * mu, 1.5)
    )

    tau_r = torch.zeros_like(rz)
    tau_m = torch.zeros_like(rz)
    sum_r = torch.zeros(dirs.shape[:-1] + (3,), dtype=f32, device=dev)
    sum_m = torch.zeros(dirs.shape[:-1] + (3,), dtype=f32, device=dev)
    inv_ls = 1.0 / float(cfg.light_steps)
    for i in range(cfg.steps):
        t = (i + 0.5) * dt
        px, py, pz = rx * t, ry * t, oz + rz * t
        pr = torch.sqrt(px * px + py * py + pz * pz)
        h = pr - rp
        dr = torch.exp(-h / hr) * dt
        dm = torch.exp(-h / hm) * dt
        tau_r = tau_r + dr
        tau_m = tau_m + dm
        # Secondary ray: optical depth from the sample to the sun.
        bl = px * sx + py * sy + pz * sz
        tl = -bl + torch.sqrt(torch.clamp(bl * bl - _fma(pr, pr, -ra2), min=0.0))
        dtl = tl * inv_ls
        ltau_r = torch.zeros_like(rz)
        ltau_m = torch.zeros_like(rz)
        for j in range(cfg.light_steps):
            tj = (j + 0.5) * dtl
            qx, qy, qz = px + sx * tj, py + sy * tj, pz + sz * tj
            hl = torch.sqrt(qx * qx + qy * qy + qz * qz) - rp
            ltau_r = ltau_r + torch.exp(-hl / hr)
            ltau_m = ltau_m + torch.exp(-hl / hm)
        ltau_r = ltau_r * dtl
        ltau_m = ltau_m * dtl
        att = torch.exp(
            -(beta_r * (tau_r + ltau_r)[..., None]
              + beta_m_e * (tau_m + ltau_m)[..., None])
        )
        sum_r = sum_r + dr[..., None] * att
        sum_m = sum_m + dm[..., None] * att

    radiance = sun_i * (
        sum_r * beta_r * phase_r[..., None]
        + sum_m * beta_m_s * phase_m[..., None]
    )

    # Sun disk: view-path transmittance times a smooth angular window, only
    # for rays that reach space.
    cos_disk = float(np.cos(np.deg2rad(cfg.sun_angular_radius_deg)))
    edge = 1.0 - cos_disk  # smoothstep band about one disk radius wide
    # Rounded as the compiled reference folds it: the two constants summed in
    # float32, the division by a constant as a product with its float32
    # reciprocal (the window is 1.1e-5 wide in mu, so one rounding moves it).
    e32 = np.float32(edge)
    w = torch.clamp((mu + float(e32 - np.float32(cos_disk))) * float(np.float32(1.0) / e32),
                    0.0, 1.0)
    w = w * w * (3.0 - 2.0 * w)
    trans = torch.exp(-(beta_r * tau_r[..., None] + beta_m_e * tau_m[..., None]))
    disk = torch.where(hits_ground, torch.zeros_like(w), w) * disk_i * sun_i
    return radiance + trans * disk[..., None]

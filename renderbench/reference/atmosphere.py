"""Single-scattering Rayleigh + Mie sky (Nishita): the view ray marched
through a spherical atmosphere, each sample's sunlight attenuated by the
optical depth to the camera and to the sun, plus a smooth sun disk. Float32
at planet scale, where ``a*a - R*R`` cancels: those multiply-adds round
once, as a fused multiply-add does, so that the ground hit near the horizon
is decided as a compiled float32 renderer decides it."""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

# Earth-like defaults (metres).
STEPS, LIGHT_STEPS = 12, 4
PLANET_R, ATMO_R = 6371e3, 6471e3
H_RAYLEIGH, H_MIE = 8500.0, 1200.0
BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
BETA_MIE, MIE_ABSORB = 3.996e-6, 0.11
SUN_ANGULAR_RADIUS_DEG = 0.27
SUN_INTENSITY, MIE_G, DISK_INTENSITY = 22.0, 0.76, 100.0


def _fma(a, b, c):
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b.double() + c).to(F32)


def sky(dirs: torch.Tensor, sun_dir: torch.Tensor, camera_height: float) -> torch.Tensor:
    """(..., 3) HDR radiance along unit view rays ``dirs`` (Z up) with the
    sun toward ``sun_dir``, the camera ``camera_height`` metres up (2 m
    at least)."""
    dev = dirs.device
    cam_h = torch.tensor(max(float(camera_height), 2.0), dtype=F32, device=dev)
    beta_r = torch.tensor([float(np.float32(c)) for c in BETA_RAYLEIGH], dtype=F32, device=dev)
    beta_m_s = BETA_MIE
    beta_m_e = beta_m_s * (1.0 + MIE_ABSORB)
    ra2 = float(np.float32(ATMO_R * ATMO_R))
    rp2 = float(np.float32(PLANET_R * PLANET_R))
    rx, ry, rz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    sx, sy, sz = sun_dir[0], sun_dir[1], sun_dir[2]
    oz = PLANET_R + cam_h
    b = oz * rz
    c_atmo = _fma(oz, oz, -ra2)
    t_exit = -b + torch.sqrt(torch.clamp(_fma(b, b, -c_atmo), min=0.0))
    c_gnd = _fma(oz, oz, -rp2)
    disc = _fma(b, b, -c_gnd)
    t_gnd = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    ground = (disc > 0.0) & (t_gnd > 0.0)
    t_end = torch.where(ground, t_gnd, t_exit)
    dt = t_end / float(STEPS)
    mu = _fma(rz, sz, _fma(rx, sx, ry * sy))
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g = torch.tensor(MIE_G, dtype=F32, device=dev)
    g2 = g * g
    phase_m = (3.0 / (8.0 * np.pi)) * ((1.0 - g2) * (1.0 + mu * mu)) / (
        (2.0 + g2) * torch.pow(1.0 + g2 - 2.0 * g * mu, 1.5))
    tau_r = torch.zeros_like(rz)
    tau_m = torch.zeros_like(rz)
    sum_r = torch.zeros(dirs.shape[:-1] + (3,), dtype=F32, device=dev)
    sum_m = torch.zeros_like(sum_r)
    inv_ls = 1.0 / float(LIGHT_STEPS)
    for i in range(STEPS):
        t = (i + 0.5) * dt
        px, py, pz = rx * t, ry * t, oz + rz * t
        pr = torch.sqrt(px * px + py * py + pz * pz)
        h = pr - PLANET_R
        dr = torch.exp(-h / H_RAYLEIGH) * dt
        dm = torch.exp(-h / H_MIE) * dt
        tau_r = tau_r + dr
        tau_m = tau_m + dm
        bl = px * sx + py * sy + pz * sz
        tl = -bl + torch.sqrt(torch.clamp(bl * bl - _fma(pr, pr, -ra2), min=0.0))
        dtl = tl * inv_ls
        lr = torch.zeros_like(rz)
        lm = torch.zeros_like(rz)
        for j in range(LIGHT_STEPS):
            tj = (j + 0.5) * dtl
            qx, qy, qz = px + sx * tj, py + sy * tj, pz + sz * tj
            hl = torch.sqrt(qx * qx + qy * qy + qz * qz) - PLANET_R
            lr = lr + torch.exp(-hl / H_RAYLEIGH)
            lm = lm + torch.exp(-hl / H_MIE)
        lr = lr * dtl
        lm = lm * dtl
        att = torch.exp(-(beta_r * (tau_r + lr)[..., None] + beta_m_e * (tau_m + lm)[..., None]))
        sum_r = sum_r + dr[..., None] * att
        sum_m = sum_m + dm[..., None] * att
    radiance = SUN_INTENSITY * (sum_r * beta_r * phase_r[..., None]
                                + sum_m * beta_m_s * phase_m[..., None])
    cos_disk = math.cos(math.radians(SUN_ANGULAR_RADIUS_DEG))
    e32 = np.float32(1.0 - cos_disk)
    w = torch.clamp((mu + float(e32 - np.float32(cos_disk))) * float(np.float32(1.0) / e32),
                    0.0, 1.0)
    w = w * w * (3.0 - 2.0 * w)
    trans = torch.exp(-(beta_r * tau_r[..., None] + beta_m_e * tau_m[..., None]))
    disk = torch.where(ground, torch.zeros_like(w), w) * DISK_INTENSITY * SUN_INTENSITY
    return radiance + trans * disk[..., None]

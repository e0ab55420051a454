"""The reference's post chain after lighting: exposure (eye adaptation),
the colour grade's halves, bloom + ACES, an FXAA-class anti-alias on
axis and diagonal taps, and film finishing (lateral chromatic aberration,
a 4-neighbour sharpen, hashed grain). Rolls wrap round the image's edges.
Where a compiled float32 renderer fuses a multiply-add whose rounding a
bilinear tap or a window can see, it is rounded once here too."""

from __future__ import annotations

import numpy as np
import torch

from reference import shade

F32 = torch.float32


def fma(a, b, c) -> torch.Tensor:
    """a·b + c with one rounding to float32 (products of float32 values are
    exact in float64)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))
    return (f64(a) * f64(b) + f64(c)).to(F32)


def ndc_ramp(n: int, device) -> torch.Tensor:
    """Pixel-centre coordinates in [-1, 1], the division by the length
    taken as a product with its float32 reciprocal."""
    inv = float(np.float32(1.0 / n))
    return (torch.arange(n, dtype=F32, device=device) + 0.5) * inv * 2.0 - 1.0


# -- eye adaptation -------------------------------------------------------------

def exposure(rgb: torch.Tensor, prev: "float | None", dt: float, key: float = 0.18,
             speed: float = 1.5, lo: float = 0.05, hi: float = 16.0) -> torch.Tensor:
    """The exposure that takes the log-average luminance toward ``key``,
    adapted from ``prev`` (none on the first frame) at ``speed`` per second."""
    log_avg = torch.mean(torch.log(shade.luma(rgb)[..., 0] + 1e-4))
    target = torch.clamp(key / torch.clamp(torch.exp(log_avg), min=1e-4), lo, hi)
    if prev is None:
        return target
    k = 1.0 - torch.exp(-torch.tensor(dt, dtype=F32, device=rgb.device) * speed)
    prev = torch.tensor(prev, dtype=F32, device=rgb.device)
    return prev + (target - prev) * k


# -- colour grade ------------------------------------------------------------------

def grade_pre(rgb: torch.Tensor, g: "list[float]") -> torch.Tensor:
    """Exposure in stops, white balance (temperature tilts r/b, tint g,
    normalised by the gains' luma), log-space contrast about 0.18."""
    dev = rgb.device
    gv = torch.tensor(g, dtype=F32, device=dev)
    rgb = rgb * torch.exp2(gv[0])
    t, ti = gv[3], gv[4]
    gains = torch.stack([1.0 + 0.25 * t, 1.0 + 0.25 * ti, 1.0 - 0.25 * t])
    gains = gains / torch.clamp(shade.luma(gains), min=1e-4)
    rgb = rgb * gains
    pivot = float(np.float32(np.log2(0.18)))
    safe = torch.clamp(rgb, min=1e-6)
    return torch.where(rgb > 0.0, torch.exp2((torch.log2(safe) - pivot) * gv[1] + pivot), rgb)


def grade_post(mapped: torch.Tensor, g: "list[float]") -> torch.Tensor:
    """Saturation about luma and a smooth radial vignette."""
    gv = torch.tensor(g, dtype=F32, device=mapped.device)
    lm = shade.luma(mapped)
    mapped = lm + (mapped - lm) * gv[2]
    h, w = mapped.shape[:2]
    ys, xs = ndc_ramp(h, mapped.device), ndc_ramp(w, mapped.device)
    r2 = (ys * ys)[:, None] + (xs * xs)[None, :]
    fall = 1.0 - gv[5] * torch.clamp(r2 * 0.5, 0.0, 1.0) ** 1.5
    return torch.clamp(mapped * fall[..., None], 0.0, 1.0)


# -- anti-alias --------------------------------------------------------------------

def fxaa(c: torch.Tensor, threshold: float = 0.0625, rel: float = 0.125) -> torch.Tensor:
    """Where the local luma range passes FXAA's gate: a quarter pull toward
    the two neighbours along the edge (horizontal, vertical or a diagonal,
    from the 4-neighbour gradient), then FXAA's subpixel blend toward the
    4-neighbour mean, weighted by 0.75·((|mean luma - luma| / range)²)."""
    def sh(img, dy, dx):
        if dy:
            img = torch.roll(img, dy, dims=0)
        if dx:
            img = torch.roll(img, dx, dims=1)
        return img

    lum = c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114
    up, dn, lf, rt = sh(lum, 1, 0), sh(lum, -1, 0), sh(lum, 0, 1), sh(lum, 0, -1)
    lmin = torch.minimum(torch.minimum(torch.minimum(up, dn), torch.minimum(lf, rt)), lum)
    lmax = torch.maximum(torch.maximum(torch.maximum(up, dn), torch.maximum(lf, rt)), lum)
    rng = lmax - lmin
    active = rng >= torch.clamp(rel * lmax, min=threshold)
    gx, gy = rt - lf, dn - up
    ax, ay = gx.abs(), gy.abs()
    horiz, vert, diag = ay >= 2.0 * ax, ax >= 2.0 * ay, gx * gy > 0
    c_up, c_dn, c_lf, c_rt = sh(c, 1, 0), sh(c, -1, 0), sh(c, 0, 1), sh(c, 0, -1)
    c_ul, c_dr, c_ur, c_dl = sh(c, 1, 1), sh(c, -1, -1), sh(c, 1, -1), sh(c, -1, 1)
    along = torch.where(horiz[..., None], 0.5 * (c_lf + c_rt),
                        torch.where(vert[..., None], 0.5 * (c_up + c_dn),
                                    torch.where(diag[..., None], 0.5 * (c_ur + c_dl),
                                                0.5 * (c_ul + c_dr))))
    directional = c * (1.0 - 0.25) + along * 0.25
    l_avg = 0.25 * (up + dn + lf + rt)
    low = 0.25 * (c_up + c_dn + c_lf + c_rt)
    sub = torch.clamp(torch.abs(l_avg - lum) / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    s = (0.75 * sub * sub)[..., None]
    return torch.where(active[..., None], directional * (1.0 - s) + low * s, c)


# -- film ---------------------------------------------------------------------------

def hash_bits(h: int, w: int, seed: int) -> np.ndarray:
    """(H, W) low 16 bits of a 32-bit integer hash of the pixel coordinates
    remixed by ``seed``."""
    m = np.uint64(0xFFFFFFFF)
    ys = np.arange(h, dtype=np.uint64)[:, None]
    xs = np.arange(w, dtype=np.uint64)[None, :]
    n = (ys * np.uint64(374761393) & m) + (xs * np.uint64(668265263) & m) & m
    n = (n + (np.uint64(seed & 0xFFFFFFFF) * np.uint64(2654435761) & m)) & m
    n = ((n ^ (n >> np.uint64(13))) * np.uint64(1274126177)) & m
    n = n ^ (n >> np.uint64(16))
    return (n & np.uint64(0xFFFF)).astype(np.int32)


def _bilinear_plane(plane, sy, sx):
    h, w = plane.shape
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 2)
    fx = torch.clamp(sx - x0.to(F32), 0.0, 1.0)
    fy = torch.clamp(sy - y0.to(F32), 0.0, 1.0)
    flat = plane.reshape(-1)

    def at(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(plane.shape)

    top = fma(at(y0, x0), 1 - fx, at(y0, x0 + 1) * fx)
    bot = fma(at(y0 + 1, x0), 1 - fx, at(y0 + 1, x0 + 1) * fx)
    return fma(top, 1 - fy, bot * fy)


def film(mapped: torch.Tensor, ca: float, sharpen: float, grain: float, seed: int,
         response: float) -> torch.Tensor:
    """Lateral chromatic aberration (R outward, B inward, ``ca`` pixels at
    the corner, quadratic in the radius), a 4-neighbour unsharp mask, then
    grain faded in highlights."""
    h, w = mapped.shape[:2]
    dev = mapped.device
    if ca > 0.0:
        px = ndc_ramp(w, dev)[None, :].expand(h, w)
        py = ndc_ramp(h, dev)[:, None].expand(h, w)
        r2 = fma(py, py, px * px)
        scale = torch.tensor(ca, dtype=F32, device=dev) / float(np.hypot(w, h)) * r2
        ix = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
        iy = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
        rx, ry = ix - (w - 1) * 0.5, iy - (h - 1) * 0.5
        r = _bilinear_plane(mapped[..., 0], fma(ry, scale, iy), fma(rx, scale, ix))
        b = _bilinear_plane(mapped[..., 2], fma(-ry, scale, iy), fma(-rx, scale, ix))
        mapped = torch.stack([r, mapped[..., 1], b], -1)
    blur = 0.25 * (torch.roll(mapped, 1, 0) + torch.roll(mapped, -1, 0)
                   + torch.roll(mapped, 1, 1) + torch.roll(mapped, -1, 1))
    sv = torch.tensor([sharpen, grain, response], dtype=F32, device=dev)
    mapped = torch.clamp(mapped + sv[0] * (mapped - blur), 0.0, 1.0)
    noise = torch.from_numpy(hash_bits(h, w, seed)).to(dev).to(F32) / 65535.0 - 0.5
    amp = sv[1] * (1.0 - sv[2] * torch.clamp(shade.luma(mapped)[..., 0], 0.0, 1.0))
    return torch.clamp(mapped + (noise * amp)[..., None], 0.0, 1.0)


def chain(hdr: torch.Tensor, post: dict, frame: int, exposure_prev, dt: float):
    """The whole post chain of frame ``frame`` (0-based) → (LDR RGBA, the
    frame's exposure or None). ``post`` holds the scene's settings."""
    rgb = hdr[..., :3]
    ev = None
    if post.get("auto_exposure"):
        ev = exposure(rgb, exposure_prev, dt)
        rgb = rgb * ev
    grade = post.get("grade")
    if grade is not None:
        rgb = grade_pre(rgb, grade)
    ldr = shade.bloom_aces(torch.cat([rgb, hdr[..., 3:4]], -1))
    mapped = ldr[..., :3]
    if grade is not None:
        mapped = grade_post(mapped, grade)
    if post.get("fxaa"):
        mapped = fxaa(mapped)
    f = post.get("film")
    if f is not None:
        # The grain's seed advances once a frame, from 1 on the first.
        mapped = film(mapped, f["chromatic_aberration"], f["sharpen"], f["grain"],
                      (frame + 1) % 4096, f["grain_response"])
    return torch.cat([mapped, hdr[..., 3:4]], -1), ev


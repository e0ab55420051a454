"""Post-processing chain: bloom + tonemap, and the present encode (torch
port of zenith_tpu/renderer/post.py at its defaults).

Pure dense image ops, declared as one lambda node reading the HDR scene
color and writing the LDR output:

- bright-pass → 2× downsample → separable 9-tap gaussian (twice) → upsample
  → additive bloom;
- ACES filmic tonemap (Narkowicz approximation) → linear LDR (the present
  encode applies the sRGB transfer).

With ``bloom_mips`` = N ≥ 2 the bloom runs over a real downsampled mip
chain through the render graph's render-to-mip writes (post.py:499-580):
the bright pass into mip 0 of a graph-managed texture of N + 1 levels, N
downsample + blur nodes each writing mip k from mip k - 1, and a combine
node that accumulates the levels coarse to fine and tonemaps.

Around the tonemap, in both forms: auto-exposure (a log-average luminance
adapted across frames, its state a device value fed back through the
engine's ``request_output`` path), the colour grade (``ColorGrade``),
FXAA (ops.aa) and the film effects (``FilmEffects``); the grade and film
values ride packed dynamics.

Under an SPMD mesh (row bands) the single node takes
``tone_and_bloom_banded``: a ring halo exchange of ``BLOOM_HALO`` rows, the
whole chain on the extended band, cropped back; chromatic aberration, whose
radial resample reaches across bands, gathers the full surface instead.
Auto-exposure's log-average is averaged over the bands. The mip chain is
single-device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from zenith_tpu_torch.ops.aa import post_aa
from zenith_tpu_torch.ops.ssao import _pixel_hash_bits
from zenith_tpu_torch.parallel import spmd
from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.rhi.formats import Format, encode_present
from zenith_tpu_torch.rhi.resource import BufferDesc, TextureDesc

_GAUSS9 = np.array(
    [0.0162162, 0.0540541, 0.1216216, 0.1945946, 0.2270270,
     0.1945946, 0.1216216, 0.0540541, 0.0162162],
    np.float32,
)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma (..., 1), summed in the reference's channel order."""
    return (rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152) + rgb[..., 2:3] * 0.0722


def _blur_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
    """9-tap separable gaussian along one axis (post.py:28-35; the taps
    wrap around the edge, as the reference's rolls do)."""
    out = torch.zeros_like(img)
    for i, w in enumerate(_GAUSS9):
        out = out + torch.roll(img, i - 4, dims=axis) * float(w)
    return out


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return x.reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3))


def _upsample2(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    up = img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    # Odd targets: edge-pad the short side (post.py:44-52).
    pad_h = max(0, h - up.shape[0])
    pad_w = max(0, w - up.shape[1])
    if pad_h or pad_w:
        up = F.pad(up.permute(2, 0, 1)[None], (0, pad_w, 0, pad_h),
                   mode="replicate")[0].permute(1, 2, 0)
    return up[:h, :w]


def aces_tonemap(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic approximation (linear HDR → linear LDR)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def reinhard_tonemap(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x)


class ColorGrade:
    """Gather-free colour grading (post.py:55-94): the knobs pack into a
    (7,) float32 dynamic, so a live grade never rebuilds the frame
    function.

    - ``exposure_ev``: pre-tonemap exposure in stops.
    - ``contrast``: log-space contrast around the 0.18 mid-grey pivot.
    - ``saturation``: post-tonemap, around Rec.709 luma.
    - ``temperature``/``tint``: white balance as per-channel linear gains.
    - ``vignette``: corner darkening strength (smooth radial falloff).
    """

    def __init__(self, exposure_ev: float = 0.0, contrast: float = 1.0,
                 saturation: float = 1.0, temperature: float = 0.0,
                 tint: float = 0.0, vignette: float = 0.0):
        self.exposure_ev = float(exposure_ev)
        self.contrast = float(contrast)
        self.saturation = float(saturation)
        self.temperature = float(temperature)
        self.tint = float(tint)
        self.vignette = float(vignette)

    def pack(self) -> np.ndarray:
        return np.asarray(
            [self.exposure_ev, self.contrast, self.saturation,
             self.temperature, self.tint, self.vignette, 0.0],
            np.float32,
        )

    def __zenith_capture_key__(self):
        # The values ride the packed dynamic; only existence shapes the frame.
        return ("ColorGrade",)


class FilmEffects:
    """Lens and film finishing after the tonemap and FXAA, in this order
    (post.py:97-147): chromatic aberration, a CAS-style sharpen and
    animated film grain. Every value rides one packed (5,) dynamic
    ("post.film"), the grain's per-frame seed too; only the aberration's
    enablement shapes the frame (on, it resamples R and B bilinearly).

    - ``chromatic_aberration``: the largest per-channel displacement, at
      the image corner, in pixels.
    - ``sharpen``: unsharp-mask amount.
    - ``grain``: noise amplitude in LDR units.
    - ``grain_response``: how much grain fades in highlights (0 = flat).
    """

    def __init__(self, chromatic_aberration: float = 0.0,
                 sharpen: float = 0.0, grain: float = 0.0,
                 grain_response: float = 0.8):
        self.chromatic_aberration = float(chromatic_aberration)
        self.sharpen = float(sharpen)
        self.grain = float(grain)
        self.grain_response = float(grain_response)
        self._seed = 0

    def pack(self) -> np.ndarray:
        """The per-frame dynamic; advances the grain seed, so each frame's
        noise is a fresh field."""
        self._seed = (self._seed + 1) % 4096
        return np.asarray(
            [self.chromatic_aberration, self.sharpen, self.grain,
             float(self._seed), self.grain_response],
            np.float32,
        )

    def __zenith_capture_key__(self):
        return ("FilmEffects", self.chromatic_aberration > 0.0)


def _ndc_ramp(n: int, device, first: int = 0, full: "int | None" = None) -> torch.Tensor:
    """(n,) pixel-centre coordinates in [-1, 1] of rows (or columns)
    ``first``.. of a ``full``-long axis, rounded as the reference's compiled
    frame rounds them: XLA turns the division by the constant length into a
    product with its float32 reciprocal."""
    inv = float(np.float32(1.0 / (full or n)))
    return (first + torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv * 2.0 - 1.0


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32 (a fused multiply-add, emulated in
    float64; a Python number enters as a float32 constant), where XLA's CPU
    ``jit`` contracts the reference's expression."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))

    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _bilinear_plane(plane: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of a (H, W) plane at float coordinates (4 gathers)."""
    h, w = plane.shape
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 2)
    fx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)
    flat = plane.reshape(-1)

    def gather(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(plane.shape)

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    # Each blend is one FMA, as the compiled reference's (see _fma).
    top = _fma(p00, 1 - fx, p01 * fx)
    bot = _fma(p10, 1 - fx, p11 * fx)
    return _fma(top, 1 - fy, bot * fy)


def apply_film(mapped: torch.Tensor, f: torch.Tensor, ca_enabled: bool,
               row0: int = 0) -> torch.Tensor:
    """The FilmEffects chain on tonemapped LDR rgb (post.py:163-221); ``f``
    is the packed (5,) vector. With ``ca_enabled`` the input must be the
    whole surface (the radial resample reaches across row bands); ``row0``
    seeds the grain hash with a band's global rows."""
    h, w = mapped.shape[0], mapped.shape[1]
    dev = mapped.device
    if ca_enabled:
        # Lateral CA: R sampled outward, B inward, scaled about the image
        # centre with a quadratic radial profile.
        # The radius and the resample coordinates round as the compiled
        # reference rounds them (one FMA each): at 1e-6 the bilinear taps
        # see every ulp of a coordinate.
        px = _ndc_ramp(w, dev)[None, :].expand(h, w)
        py = _ndc_ramp(h, dev)[:, None].expand(h, w)
        r2 = _fma(py, py, px * px)
        # f[0] px at the corner: the corner pixel moves by f[0].
        scale = f[0] / float(np.hypot(w, h)) * r2
        cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
        ix = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
        iy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
        rx, ry = ix - cx, iy - cy
        r = _bilinear_plane(mapped[..., 0], _fma(ry, scale, iy), _fma(rx, scale, ix))
        b = _bilinear_plane(mapped[..., 2], _fma(-ry, scale, iy), _fma(-rx, scale, ix))
        mapped = torch.stack([r, mapped[..., 1], b], dim=-1)
    # CAS-style sharpen: a gather-free 4-neighbour unsharp mask.
    blur = 0.25 * (
        torch.roll(mapped, 1, dims=0) + torch.roll(mapped, -1, dims=0)
        + torch.roll(mapped, 1, dims=1) + torch.roll(mapped, -1, dims=1)
    )
    mapped = torch.clamp(mapped + f[1] * (mapped - blur), 0.0, 1.0)
    # Film grain: the shared screen-dither hash, remixed by the per-frame
    # seed (a device value: no host read), attenuated in highlights by
    # grain_response.
    bits = _pixel_hash_bits(h, w, row0, seed=f[3], device=dev)
    noise = bits.to(torch.float32) / 65535.0 - 0.5
    luma = _luma(mapped)[..., 0]
    amp = f[2] * (1.0 - f[4] * torch.clamp(luma, 0.0, 1.0))
    return torch.clamp(mapped + (noise * amp)[..., None], 0.0, 1.0)


def apply_grade_pre(rgb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The pre-tonemap half of the grade (post.py:224-243): exposure, white
    balance, contrast (linear HDR in and out); ``g`` is the packed (7,)
    vector."""
    rgb = rgb * torch.exp2(g[0])
    # White balance: temperature tilts r/b, tint tilts g, normalized to keep
    # mid-grey luma roughly fixed.
    t, ti = g[3], g[4]
    gains = torch.stack([1.0 + 0.25 * t, 1.0 + 0.25 * ti, 1.0 - 0.25 * t])
    gains = gains / torch.clamp(_luma(gains), min=1e-4)
    rgb = rgb * gains
    # Log-space contrast around mid-grey 0.18.
    log_pivot = float(np.float32(np.log2(0.18)))
    safe = torch.clamp(rgb, min=1e-6)
    return torch.where(
        rgb > 0.0,
        torch.exp2((torch.log2(safe) - log_pivot) * g[1] + log_pivot),
        rgb,
    )


def apply_grade_post(mapped: torch.Tensor, g: torch.Tensor, row0: int = 0,
                     full_h: "int | None" = None) -> torch.Tensor:
    """The post-tonemap half (post.py:246-261): saturation and vignette
    (LDR in and out); ``row0`` and ``full_h`` place a row band in the
    frame."""
    luma = _luma(mapped)
    mapped = luma + (mapped - luma) * g[2]
    h, w = mapped.shape[0], mapped.shape[1]
    if full_h is None:
        full_h = h
    ys, xs = _ndc_ramp(h, mapped.device, row0, full_h), _ndc_ramp(w, mapped.device)
    r2 = (ys * ys)[:, None] + (xs * xs)[None, :]
    fall = 1.0 - g[5] * torch.clamp(r2 * 0.5, 0.0, 1.0) ** 1.5
    return torch.clamp(mapped * fall[..., None], 0.0, 1.0)


def tone_and_bloom(
    hdr: torch.Tensor,  # (H, W, 4) linear HDR
    bloom_threshold: float = 1.0,
    bloom_strength: float = 0.35,
    tonemap: str = "aces",
    fxaa: bool = False,
    exposure=None,  # 0-d tensor (auto-exposure) | None
    grade=None,  # packed (7,) ColorGrade tensor | None
    film=None,  # packed (5,) FilmEffects tensor | None
    film_ca: bool = False,
    row0: int = 0,
    full_h: "int | None" = None,
) -> torch.Tensor:
    """Bloom + tonemap of one frame (post.py:264-301): exposure and the
    grade's first half before the bloom, the grade's second half, FXAA
    and the film effects after the tonemap. ``row0``/``full_h`` place a
    row band in the frame (the vignette and the grain's global rows)."""
    rgb = hdr[..., :3]
    if exposure is not None:
        rgb = rgb * exposure
    if grade is not None:
        rgb = apply_grade_pre(rgb, grade)
    h, w = rgb.shape[0], rgb.shape[1]
    half = _downsample2(_bright_pass(rgb, bloom_threshold))
    half = _blur_axis(_blur_axis(half, 0), 1)
    half = _blur_axis(_blur_axis(half, 0), 1)  # wider kernel via 2 passes
    bloom = _upsample2(half, h, w)

    combined = rgb + bloom * bloom_strength
    return torch.cat([_finish(_tonemap(combined, tonemap), grade, fxaa, film, film_ca,
                              row0, full_h),
                      hdr[..., 3:4]], dim=-1)


def _finish(mapped, grade, fxaa, film, film_ca, row0=0, full_h=None):
    """The LDR stages after the tonemap: grade, FXAA, film."""
    if grade is not None:
        mapped = apply_grade_post(mapped, grade, row0, full_h)
    if fxaa:
        mapped = post_aa(mapped)
    if film is not None:
        mapped = apply_film(mapped, film, film_ca, row0)
    return mapped


# Cross-band reach of the bloom chain in full-res rows: one 2x downsample,
# then two 9-tap passes (radius 4 each) at half res = 8 half-rows.
BLOOM_HALO = 16


def tone_and_bloom_banded(
    hdr_band: torch.Tensor,  # (bh, W, 4) this shard's row band
    axis_name: str,
    bloom_threshold: float = 1.0,
    bloom_strength: float = 0.35,
    tonemap: str = "aces",
    fxaa: bool = False,
    exposure=None,
    grade=None,
    film=None,
) -> torch.Tensor:
    """SPMD row-banded tone_and_bloom (post.py:310-351): a ring halo
    exchange extends the band by BLOOM_HALO rows each side, the whole
    chain runs on the extended band, and the result crops back, bit-exact
    with the single-device output (the halo wraps at the frame edges as
    the rolls do; FXAA and the sharpen reach 1 row, well inside the halo).
    Requires an even band height >= BLOOM_HALO."""
    from zenith_tpu_torch.parallel.sharding import halo_exchange_rows

    bh = hdr_band.shape[0]
    if bh % 2 or bh < BLOOM_HALO:
        raise ValueError(f"banded bloom needs an even band height >= {BLOOM_HALO}, got {bh}")
    ext = halo_exchange_rows(hdr_band, axis_name, BLOOM_HALO)
    n = spmd.psum(1, axis_name)
    out = tone_and_bloom(
        ext, bloom_threshold=bloom_threshold, bloom_strength=bloom_strength,
        tonemap=tonemap, fxaa=fxaa, exposure=exposure, grade=grade,
        film=film, film_ca=False,  # CA takes the gather path, never this one
        row0=spmd.axis_index(axis_name) * bh - BLOOM_HALO, full_h=bh * n,
    )
    return out[BLOOM_HALO:BLOOM_HALO + bh]


def _bright_pass(rgb: torch.Tensor, threshold: float) -> torch.Tensor:
    """The part of each pixel above the luma threshold, its hue kept."""
    luma = _luma(rgb)
    return rgb * torch.clamp(luma - threshold, min=0.0) / torch.clamp(luma, min=1e-4)


def _tonemap(rgb: torch.Tensor, tonemap: str) -> torch.Tensor:
    return aces_tonemap(rgb) if tonemap == "aces" else reinhard_tonemap(rgb)


class PostProcess:
    """Declares the post node(s): HDR color in → LDR image out (post.py:354):
    the single-node bloom (``bloom_mips=0``) or the render-to-mip chain
    (``bloom_mips`` ≥ 2), each with optional auto-exposure, grade, FXAA
    and film effects.

    Auto-exposure (eye adaptation): the log-average scene luminance drives
    an exposure multiplier, smoothed over time, applied before bloom and
    tonemap. The adapted value stays on the device: the frame exports a
    (1,) buffer ("post.ae", handle ``exposure_out``), the app hands it back
    through ``feedback`` and it enters the next frame as the "post.ae_prev"
    dynamic; a "post.ae_valid" scalar, chosen on the host from whether
    state exists, gates frame 0, so one frame function serves every
    frame."""

    def __init__(self, bloom_threshold: float = 1.0, bloom_strength: float = 0.35,
                 tonemap: str = "aces", bloom_mips: int = 0,
                 fxaa: bool = False, auto_exposure: bool = False,
                 exposure_key: float = 0.18, adapt_speed: float = 1.5,
                 exposure_min: float = 0.05, exposure_max: float = 16.0,
                 grade: "ColorGrade | None" = None,
                 film: "FilmEffects | None" = None):
        self.bloom_threshold = bloom_threshold
        self.bloom_strength = bloom_strength
        self.tonemap = tonemap
        self.bloom_mips = bloom_mips
        self.fxaa = fxaa
        self.auto_exposure = auto_exposure
        self.exposure_key = float(exposure_key)
        self.adapt_speed = float(adapt_speed)
        self.exposure_min = float(exposure_min)
        self.exposure_max = float(exposure_max)
        self._ae_state = None  # (1,) device tensor from last frame's feedback
        self._dt = 1.0 / 60.0
        self.exposure_out = None  # graph handle, set per render_to
        self.grade = grade
        self.film = film

    def __zenith_capture_key__(self):
        """The frame-shaping configuration only: the per-frame state
        (_ae_state, _dt) rides dynamics."""
        return (
            "PostProcess", self.bloom_threshold, self.bloom_strength,
            self.tonemap, self.bloom_mips, self.fxaa, self.auto_exposure,
            self.exposure_key, self.adapt_speed, self.exposure_min,
            self.exposure_max, self.grade is not None,
            None if self.film is None else self.film.__zenith_capture_key__(),
        )

    # -- auto-exposure cross-frame state -----------------------------------

    def set_delta_time(self, dt: float) -> None:
        """Frame delta for the adaptation rate (call from app.tick)."""
        self._dt = max(float(dt), 1e-4)

    def feedback(self, exposure) -> None:
        """Engine feedback: this frame's adapted exposure → next frame."""
        self._ae_state = exposure

    def frame_dynamics(self) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        d = {}
        if self.auto_exposure:
            d["post.ae_dt"] = np.float32(self._dt)
            d["post.ae_valid"] = np.float32(0.0 if self._ae_state is None else 1.0)
            if self._ae_state is not None:
                d["post.ae_prev"] = self._ae_state
        if self.grade is not None:
            d["post.grade"] = self.grade.pack()
        if self.film is not None:
            d["post.film"] = self.film.pack()
        return d

    def _declare_ae(self, builder: RenderGraphBuilder):
        """The dynamics and the exported (1,) state buffer of auto-exposure.
        Frame 0's placeholder state is a host array of the same shape and
        dtype as the fed-back tensor, so both frames share one function."""
        prev = self._ae_state if self._ae_state is not None else np.ones((1,), np.float32)
        builder.set_dynamic("post.ae_prev", prev)
        builder.set_dynamic("post.ae_dt", np.float32(self._dt))
        builder.set_dynamic("post.ae_valid", np.float32(0.0 if self._ae_state is None else 1.0))
        ae = builder.create(BufferDesc.storage("post.ae", (1,)))
        builder.export(ae)
        self.exposure_out = ae
        return ae

    def _adapted_exposure(self, ctx, rgb: torch.Tensor) -> torch.Tensor:
        """0-d tensor: the exposure adapted toward key / average luminance.
        ``rgb`` may be a row band under SPMD: the log-average is averaged
        over the bands, so every band adapts identically."""
        log_avg = torch.mean(torch.log(_luma(rgb)[..., 0] + 1e-4))
        if ctx.sharded and ctx.num_shards > 1:
            log_avg = spmd.pmean(log_avg, ctx.shard_axis)
        target = torch.clamp(self.exposure_key / torch.clamp(torch.exp(log_avg), min=1e-4),
                             self.exposure_min, self.exposure_max)
        prev = ctx.dynamic("post.ae_prev")[0]
        k = 1.0 - torch.exp(-ctx.dynamic("post.ae_dt") * self.adapt_speed)
        return torch.where(ctx.dynamic("post.ae_valid") > 0.0, prev + (target - prev) * k,
                           target)

    def _declare_values(self, builder: RenderGraphBuilder, hdr_input: RenderGraphResource):
        """(ae buffer | None, has_grade, has_film, film_ca) for this frame."""
        self.exposure_out = None
        ae = None
        if self.auto_exposure:
            ae = self._declare_ae(builder)
        if self.grade is not None:
            builder.set_dynamic("post.grade", self.grade.pack())
        if self.film is not None:
            builder.set_dynamic("post.film", self.film.pack())
        film_ca = self.film is not None and self.film.chromatic_aberration > 0.0
        return ae, self.grade is not None, self.film is not None, film_ca

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        if self.bloom_mips >= 2:
            self._render_mip_chain(builder, hdr_input, output)
            return
        self._render_single_node(builder, hdr_input, output)

    def _render_single_node(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        ae, has_grade, has_film, film_ca = self._declare_values(builder, hdr_input)
        node = builder.add_lambda_node("post")
        src = node.read(hdr_input)
        dst = node.write(output)
        ae_w = node.write(ae) if ae is not None else None
        kwargs = dict(
            bloom_threshold=self.bloom_threshold,
            bloom_strength=self.bloom_strength,
            tonemap=self.tonemap,
            fxaa=self.fxaa,
        )

        def record(ctx):
            hdr = ctx.get(src)
            banded = ctx.sharded and ctx.num_shards > 1
            exposure = None
            grade_vec = ctx.dynamic("post.grade") if has_grade else None
            film_vec = ctx.dynamic("post.film") if has_film else None
            if ae_w is not None:
                exposure = self._adapted_exposure(ctx, hdr[..., :3])
                ctx.set(ae_w, exposure[None])
            if banded and not film_ca and hdr.shape[0] >= BLOOM_HALO \
                    and hdr.shape[0] % 2 == 0:
                # Row-banded under a mesh: halo exchange (bloom's blur
                # crosses band boundaries).
                out = tone_and_bloom_banded(hdr, ctx.shard_axis, exposure=exposure,
                                            grade=grade_vec, film=film_vec, **kwargs)
            elif banded:
                # Bands thinner than the halo (or odd), or chromatic
                # aberration: gather the whole surface, compute, slice back.
                full = tone_and_bloom(ctx.get_full(src), exposure=exposure, grade=grade_vec,
                                      film=film_vec, film_ca=film_ca, **kwargs)
                y0 = spmd.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = full[y0:y0 + hdr.shape[0]]
            else:
                out = tone_and_bloom(hdr, exposure=exposure, grade=grade_vec, film=film_vec,
                                     film_ca=film_ca, **kwargs)
            ctx.set(dst, out)

        node.execute(record)

    def _render_mip_chain(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        """Bloom over a render-to-mip chain (post.py:499-622)."""
        tdesc = builder.resources[hdr_input.id].texture_desc()
        if tdesc is None:
            raise ValueError("the post input must be a texture")
        h, w = tdesc.height, tdesc.width
        n_mips = self.bloom_mips
        if min(h, w) >> n_mips < 1:
            raise ValueError(f"bloom_mips={n_mips} is too deep for {w}x{h}")
        chain = builder.create(TextureDesc("bloom.chain", w, h, tdesc.format,
                                           mip_levels=n_mips + 1))
        ae, has_grade, has_film, film_ca = self._declare_values(builder, hdr_input)

        # The bright pass into mip 0, after the adapted exposure (which
        # scales the scene before the threshold, so bloom follows adaptation).
        node = builder.add_lambda_node("post.bright")
        src = node.read(hdr_input)
        dst0 = node.write(chain, mip=0)
        ae_w = node.write(ae) if ae is not None else None
        threshold = self.bloom_threshold

        def record_bright(ctx):
            if ctx.sharded and ctx.num_shards > 1:
                raise ValueError("bloom_mips >= 2 (the render-to-mip chain) is single-device; "
                                 "use the default single-node bloom under an SPMD mesh")
            rgb = ctx.get(src)[..., :3]
            if ae_w is not None:
                exposure = self._adapted_exposure(ctx, rgb)
                ctx.set(ae_w, exposure[None])
                rgb = rgb * exposure
            bright = _bright_pass(rgb, threshold)
            ctx.set(dst0, torch.cat([bright, torch.zeros_like(bright[..., :1])], dim=-1))

        node.execute(record_bright)

        # The downsample + blur cascade: mip k - 1 → mip k.
        for k in range(1, n_mips + 1):
            node = builder.add_lambda_node(f"post.down{k}")
            src_k = node.read(chain, mip=k - 1)
            dst_k = node.write(chain, mip=k)

            def record_down(ctx, src_k=src_k, dst_k=dst_k):
                ctx.set(dst_k, _blur_axis(_blur_axis(_downsample2(ctx.get(src_k)), 0), 1))

            node.execute(record_down)

        # Upsample-accumulate coarse to fine, then tonemap and finish.
        node = builder.add_lambda_node("post.combine")
        hdr_in = node.read(hdr_input)
        mip_reads = [node.read(chain, mip=k) for k in range(n_mips + 1)]
        ae_r = node.read(ae) if ae is not None else None
        dst = node.write(output)
        strength = self.bloom_strength
        tonemap = self.tonemap
        fxaa = self.fxaa

        def record_combine(ctx):
            hdr = ctx.get(hdr_in)
            grade = ctx.dynamic("post.grade") if has_grade else None
            rgb = hdr[..., :3]
            if ae_r is not None:
                rgb = rgb * ctx.get(ae_r)[0]
            if grade is not None:
                # The grade wraps the tonemap; the bloom chain sees the
                # exposure only (the reference's documented divergence
                # from its single-node path).
                rgb = apply_grade_pre(rgb, grade)
            acc = ctx.get(mip_reads[-1])[..., :3]
            for k in range(n_mips - 1, -1, -1):
                lvl = ctx.get(mip_reads[k])[..., :3]
                acc = lvl + _upsample2(acc, lvl.shape[0], lvl.shape[1])
            bloom = _upsample2(acc, hdr.shape[0], hdr.shape[1]) \
                if acc.shape[:2] != hdr.shape[:2] else acc
            combined = rgb + bloom * (strength / (n_mips + 1))
            mapped = _finish(_tonemap(combined, tonemap), grade, fxaa,
                             ctx.dynamic("post.film") if has_film else None, film_ca)
            ctx.set(dst, torch.cat([mapped, hdr[..., 3:4]], dim=-1))

        node.execute(record_combine)


class PresentEncode:
    """Folds the swapchain present encode (linear → sRGB swapchain format)
    into the frame function as a lambda node (post.py:686-714). The output
    texture must be created with the swapchain's at-rest format (e.g.
    Format.BGRA8_SRGB)."""

    def __init__(self, fmt=None):
        self.format = fmt if fmt is not None else Format.BGRA8_SRGB

    def render_to(
        self,
        builder: RenderGraphBuilder,
        linear_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        node = builder.add_lambda_node("present.encode")
        src = node.read(linear_input)
        dst = node.write(output)
        fmt = self.format

        def record(ctx):
            ctx.set(dst, encode_present(ctx.get(src), fmt))

        node.execute(record)

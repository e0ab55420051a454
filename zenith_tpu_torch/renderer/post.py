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

Not ported yet (ROADMAP item 21): FXAA, auto-exposure, color grading and
film effects; each raises when asked for. The row-banded
``tone_and_bloom_banded`` belongs to the SPMD modes (item 24).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource
from zenith_tpu_torch.rhi.formats import Format, encode_present
from zenith_tpu_torch.rhi.resource import TextureDesc

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


def tone_and_bloom(
    hdr: torch.Tensor,  # (H, W, 4) linear HDR
    bloom_threshold: float = 1.0,
    bloom_strength: float = 0.35,
    tonemap: str = "aces",
) -> torch.Tensor:
    """Bloom + tonemap of one frame (post.py:262-302 without the exposure,
    grade, FXAA and film stages)."""
    rgb = hdr[..., :3]
    h, w = rgb.shape[0], rgb.shape[1]
    half = _downsample2(_bright_pass(rgb, bloom_threshold))
    half = _blur_axis(_blur_axis(half, 0), 1)
    half = _blur_axis(_blur_axis(half, 0), 1)  # wider kernel via 2 passes
    bloom = _upsample2(half, h, w)

    combined = rgb + bloom * bloom_strength
    return torch.cat([_tonemap(combined, tonemap), hdr[..., 3:4]], dim=-1)


def _bright_pass(rgb: torch.Tensor, threshold: float) -> torch.Tensor:
    """The part of each pixel above the luma threshold, its hue kept."""
    luma = _luma(rgb)
    return rgb * torch.clamp(luma - threshold, min=0.0) / torch.clamp(luma, min=1e-4)


def _tonemap(rgb: torch.Tensor, tonemap: str) -> torch.Tensor:
    return aces_tonemap(rgb) if tonemap == "aces" else reinhard_tonemap(rgb)


class PostProcess:
    """Declares the post node(s): HDR color in → LDR image out (post.py:354):
    the single-node bloom (``bloom_mips=0``) or the render-to-mip chain
    (``bloom_mips`` ≥ 2)."""

    def __init__(self, bloom_threshold: float = 1.0, bloom_strength: float = 0.35,
                 tonemap: str = "aces", bloom_mips: int = 0,
                 fxaa: bool = False, auto_exposure: bool = False,
                 grade=None, film=None):
        unported = [name for name, on in (
            ("fxaa", fxaa), ("auto_exposure", auto_exposure),
            ("grade", grade is not None), ("film", film is not None),
        ) if on]
        if unported:
            raise NotImplementedError(
                f"PostProcess {', '.join(unported)} is not ported yet (ROADMAP item "
                f"21: post extras)"
            )
        self.bloom_threshold = bloom_threshold
        self.bloom_strength = bloom_strength
        self.tonemap = tonemap
        self.bloom_mips = bloom_mips

    def __zenith_capture_key__(self):
        return ("PostProcess", self.bloom_threshold, self.bloom_strength,
                self.tonemap, self.bloom_mips)

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        if self.bloom_mips >= 2:
            self._render_mip_chain(builder, hdr_input, output)
            return
        node = builder.add_lambda_node("post")
        src = node.read(hdr_input)
        dst = node.write(output)
        kwargs = dict(
            bloom_threshold=self.bloom_threshold,
            bloom_strength=self.bloom_strength,
            tonemap=self.tonemap,
        )

        def record(ctx):
            ctx.set(dst, tone_and_bloom(ctx.get(src), **kwargs))

        node.execute(record)

    def _render_mip_chain(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        """Bloom over a render-to-mip chain (post.py:499-622, without the
        exposure, grade, FXAA and film stages)."""
        tdesc = builder.resources[hdr_input.id].texture_desc()
        if tdesc is None:
            raise ValueError("the post input must be a texture")
        h, w = tdesc.height, tdesc.width
        n_mips = self.bloom_mips
        if min(h, w) >> n_mips < 1:
            raise ValueError(f"bloom_mips={n_mips} is too deep for {w}x{h}")
        chain = builder.create(TextureDesc("bloom.chain", w, h, tdesc.format,
                                           mip_levels=n_mips + 1))

        node = builder.add_lambda_node("post.bright")
        src = node.read(hdr_input)
        dst0 = node.write(chain, mip=0)
        threshold = self.bloom_threshold

        def record_bright(ctx):
            bright = _bright_pass(ctx.get(src)[..., :3], threshold)
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

        # Upsample-accumulate coarse to fine, then tonemap.
        node = builder.add_lambda_node("post.combine")
        hdr_in = node.read(hdr_input)
        mip_reads = [node.read(chain, mip=k) for k in range(n_mips + 1)]
        dst = node.write(output)
        strength = self.bloom_strength
        tonemap = self.tonemap

        def record_combine(ctx):
            hdr = ctx.get(hdr_in)
            acc = ctx.get(mip_reads[-1])[..., :3]
            for k in range(n_mips - 1, -1, -1):
                lvl = ctx.get(mip_reads[k])[..., :3]
                acc = lvl + _upsample2(acc, lvl.shape[0], lvl.shape[1])
            bloom = _upsample2(acc, hdr.shape[0], hdr.shape[1]) \
                if acc.shape[:2] != hdr.shape[:2] else acc
            combined = hdr[..., :3] + bloom * (strength / (n_mips + 1))
            ctx.set(dst, torch.cat([_tonemap(combined, tonemap), hdr[..., 3:4]], dim=-1))

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

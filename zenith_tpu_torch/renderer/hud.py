"""Debug HUD overlay (torch port of zenith_tpu/renderer/hud.py): text
rasterized on the host into a small fixed-size alpha bitmap (a 5x7 bitfont,
NumPy), which rides the frame function as one dynamic; the device composites
it over the overlay's corner with elementwise ops. Changing the text never
builds a new frame function: the bitmap keeps its shape.

With ``overflow_indicator`` a red bar under the text grows with log2 of the
frame's running bin-overflow count, read from the device counter
(``LambdaNodeExecutionContext.frame_overflow``) without a host read.

The reference logs its stats line to stderr (zenith/src/main_loop.rs:
146-162); this puts the same line on screen. Under an SPMD mesh each band
composites its own global rows of the overlay, and the overflow count is
the frame's total over the bands.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from zenith_tpu_torch.parallel import spmd

from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.rendergraph.resource import RenderGraphResource

# 5x7 bitfont: per printable ASCII char (32..127), 7 rows x 5 bits,
# row-major MSB-left, packed as 7 ints. Derived from the classic public-
# domain 5x7 LCD/terminal glyph shapes (hand-encoded here).
_FONT: "dict[str, tuple[int, ...]]" = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "!": (0b00100,) * 5 + (0, 0b00100),
    '"': (0b01010, 0b01010, 0, 0, 0, 0, 0),
    "%": (0b11001, 0b11010, 0b00010, 0b00100, 0b01000, 0b01011, 0b10011),
    "'": (0b00100, 0b00100, 0, 0, 0, 0, 0),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "+": (0, 0b00100, 0b00100, 0b11111, 0b00100, 0b00100, 0),
    ",": (0, 0, 0, 0, 0, 0b00100, 0b01000),
    "-": (0, 0, 0, 0b11111, 0, 0, 0),
    ".": (0, 0, 0, 0, 0, 0b00110, 0b00110),
    "/": (0b00001, 0b00010, 0b00010, 0b00100, 0b01000, 0b01000, 0b10000),
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00110, 0b01000, 0b10000, 0b11111),
    "3": (0b01110, 0b10001, 0b00001, 0b00110, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    ":": (0, 0b00110, 0b00110, 0, 0b00110, 0b00110, 0),
    "=": (0, 0, 0b11111, 0, 0b11111, 0, 0),
    ">": (0b01000, 0b00100, 0b00010, 0b00001, 0b00010, 0b00100, 0b01000),
    "<": (0b00010, 0b00100, 0b01000, 0b10000, 0b01000, 0b00100, 0b00010),
    "A": (0b01110, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "C": (0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110),
    "D": (0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "H": (0b10001, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "I": (0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "J": (0b00111, 0b00010, 0b00010, 0b00010, 0b00010, 0b10010, 0b01100),
    "K": (0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001),
    "L": (0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "N": (0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001, 0b10001),
    "O": (0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "Q": (0b01110, 0b10001, 0b10001, 0b10001, 0b10101, 0b10010, 0b01101),
    "R": (0b11110, 0b10001, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "T": (0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100),
    "U": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "V": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "X": (0b10001, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001, 0b10001),
    "Y": (0b10001, 0b10001, 0b01010, 0b00100, 0b00100, 0b00100, 0b00100),
    "Z": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b11111),
}
GLYPH_W, GLYPH_H = 6, 8  # 5x7 glyph + 1px spacing


class HudOverlay:
    """A fixed-size text overlay line, top-left (hud.py:85-204).

    ``max_chars`` bounds the bitmap's width; the text itself is a dynamic.
    ``scale`` integer-upsamples the bitfont on the host (2 gives 10x14
    glyphs, readable at 1080p)."""

    def __init__(self, max_chars: int = 48, scale: int = 2, color=(1.0, 1.0, 1.0),
                 background: float = 0.45, margin: int = 8,
                 overflow_indicator: bool = False):
        self.max_chars = int(max_chars)
        self.scale = int(scale)
        self.color = tuple(float(c) for c in color)
        self.background = float(background)
        self.margin = int(margin)
        self.overflow_indicator = bool(overflow_indicator)
        self._text = ""
        self._bitmap = np.zeros(self.bitmap_shape, np.float32)

    @property
    def bitmap_shape(self) -> "tuple[int, int]":
        return (GLYPH_H * self.scale, GLYPH_W * self.scale * self.max_chars)

    def __zenith_capture_key__(self):
        # The text rides a dynamic; the geometry and settings shape the frame.
        return ("HudOverlay", self.max_chars, self.scale, self.color, self.background,
                self.margin, self.overflow_indicator)

    def set_text(self, text: str) -> None:
        """Rasterize ``text`` into the alpha bitmap on the host (cached:
        setting the same string again is free)."""
        if text == self._text:
            return
        self._text = text
        self._bitmap = render_text_bitmap(text, self.max_chars, self.scale)

    def frame_dynamics(self) -> dict:
        return {"hud.bitmap": self._bitmap}

    def render_to(self, builder: RenderGraphBuilder, target: RenderGraphResource,
                  source: "RenderGraphResource | None" = None) -> None:
        """Composite the overlay into ``target`` (LDR, after the tonemap) in
        place, or, with ``source``, read ``source`` and write the composite
        into ``target`` (a stage that exports its history, such as TAA,
        keeps its clean output). Declare it after PostProcess and before
        PresentEncode."""
        builder.set_dynamic("hud.bitmap", self._bitmap)
        node = builder.add_lambda_node("hud")
        src = node.read(source if source is not None else target)
        dst = node.write(target)
        bh, bw = self.bitmap_shape
        margin = self.margin
        color = self.color
        bg = self.background
        overflow_indicator = self.overflow_indicator

        def record(ctx):
            img = ctx.get(src)
            bitmap = ctx.dynamic("hud.bitmap")  # (bh, bw) alpha in [0, 1]
            h, w = img.shape[0], img.shape[1]
            row0 = 0
            if ctx.sharded and ctx.num_shards > 1:
                row0 = spmd.axis_index(ctx.shard_axis) * h
            # The overlay covers global rows [margin, margin + bh) and this
            # band rows [row0, row0 + h): a window of h rows of the bitmap
            # padded by h above and below, its start clamped into range as
            # the reference's dynamic_slice clamps (a band wholly outside
            # lands on the zero padding).
            planes = torch.stack([bitmap, torch.ones_like(bitmap)], dim=-1)  # text, box
            padded = F.pad(planes, (0, 0, 0, 0, h, h))
            start = min(max(h + row0 - margin, 0), bh + h)
            band = padded[start:start + h]
            if bw >= w:
                band = band[:, :w]
            else:
                x0 = min(margin, w - bw)
                band = F.pad(band, (0, 0, x0, w - x0 - bw))
            text_a = band[..., 0]
            box_a = band[..., 1]
            dim = 1.0 - bg * box_a  # the dimmed box
            keep = 1.0 - text_a
            rgb = [img[..., c] * dim * keep + color[c] * text_a for c in range(3)]
            if overflow_indicator:
                # The red bar under the text: width grows with log2 of the
                # running overflow count, all on the device.
                ovf = ctx.frame_overflow().to(torch.float32)
                frac = torch.clamp(torch.log2(1.0 + ovf) / 24.0, 0.0, 1.0)
                bar_y0 = margin + bh + 2
                bar_h = max(2, bh // 4)
                gy = row0 + torch.arange(h, dtype=torch.int32, device=img.device)[:, None]
                gx = torch.arange(w, dtype=torch.int32, device=img.device)[None, :]
                bar_w = frac * (w - 2 * margin)
                in_bar = ((gy >= bar_y0) & (gy < bar_y0 + bar_h) & (gx >= margin)
                          & (gx.to(torch.float32) < margin + bar_w) & (ovf > 0))
                bar_a = in_bar.to(torch.float32)
                rgb = [v * (1.0 - bar_a) + warn * bar_a
                       for v, warn in zip(rgb, (1.0, 0.15, 0.1))]
            ctx.set(dst, torch.cat([torch.stack(rgb, dim=-1), img[..., 3:]], dim=-1))

        node.execute(record)


def render_text_bitmap(text: str, max_chars: int, scale: int) -> np.ndarray:
    """Host rasterization: (GLYPH_H*scale, GLYPH_W*scale*max_chars) alpha
    bitmap. Unknown characters render as blank; lowercase maps to the
    uppercase glyphs."""
    bitmap = np.zeros((GLYPH_H, GLYPH_W * max_chars), np.float32)
    for i, ch in enumerate(text[:max_chars]):
        rows = _FONT.get(ch) or _FONT.get(ch.upper())
        if rows is None:
            continue
        for r, bits in enumerate(rows):
            for c in range(5):
                if bits & (1 << (4 - c)):
                    bitmap[r, i * GLYPH_W + c] = 1.0
    if scale > 1:
        bitmap = np.repeat(np.repeat(bitmap, scale, 0), scale, 1)
    return bitmap

"""DDS container + block-compressed (BCn) texture decode (torch port of
zenith_tpu/asset/dds.py: the parser and the NumPy decoders carried over as
they are; ``DDSFile.to_texture`` uploads to an explicit device).

The reference loads images through the ``image`` crate, which has no
block-compression support (zenith-asset/src/gltf_loader.rs image decode);
production content pipelines ship BC-compressed textures, so this adds the
missing half: a DDS parser (legacy FourCC and DX10 headers, 2D / cube /
mip chains) and vectorized NumPy decoders for BC1/BC2/BC3/BC4/BC5.

Decode happens at BAKE/LOAD time on the host: textures live as linear
float planes on the device (the sampling ops gather them), so compression
is an at-rest format only. The decoders are fully
vectorized over blocks (no per-texel Python), keeping multi-mip loads in
the tens of milliseconds.

Usage::

    dds = load_dds("skin.dds")           # or parse_dds(raw_bytes)
    tex = dds.to_texture("skin", device=dev)  # rhi.Texture (2D+mips or cube)
    asset = dds.to_texture_asset(url)    # base-level TextureAsset
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

import torch

from zenith_tpu_torch.asset import AssetUrl
from zenith_tpu_torch.asset.render_types import TextureAsset, TextureFormat
from zenith_tpu_torch.rhi.formats import Format, decode_stored
from zenith_tpu_torch.rhi.resource import Texture, TextureDesc, TextureUsage

_DDS_MAGIC = 0x20534444  # "DDS "
_DDPF_FOURCC = 0x4
_DDSCAPS2_CUBEMAP = 0x200
_DDSCAPS2_ALL_FACES = 0xFE00

# FourCC → (bc_mode, block_bytes, channels)
_FOURCC = {
    b"DXT1": ("bc1", 8, 4),
    b"DXT2": ("bc2", 16, 4),
    b"DXT3": ("bc2", 16, 4),
    b"DXT4": ("bc3", 16, 4),
    b"DXT5": ("bc3", 16, 4),
    b"ATI1": ("bc4", 8, 1),
    b"BC4U": ("bc4", 8, 1),
    b"ATI2": ("bc5", 16, 2),
    b"BC5U": ("bc5", 16, 2),
}

# DXGI_FORMAT → (bc_mode, block_bytes, channels, srgb)
_DXGI = {
    71: ("bc1", 8, 4, False), 72: ("bc1", 8, 4, True),
    74: ("bc2", 16, 4, False), 75: ("bc2", 16, 4, True),
    77: ("bc3", 16, 4, False), 78: ("bc3", 16, 4, True),
    80: ("bc4", 8, 1, False),
    83: ("bc5", 16, 2, False),
}


def _expand565(v: np.ndarray) -> np.ndarray:
    """(N,) uint16 RGB565 → (N, 3) uint8 with standard bit replication."""
    r = ((v >> 11) & 0x1F).astype(np.uint16)
    g = ((v >> 5) & 0x3F).astype(np.uint16)
    b = (v & 0x1F).astype(np.uint16)
    return np.stack(
        [(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)],
        axis=-1,
    ).astype(np.uint8)


def _color_block(raw: np.ndarray, force_four: bool) -> np.ndarray:
    """Decode the shared BC1 color half. raw: (N, 8) u8 → (N, 16, 4) u8.

    ``force_four``: BC2/BC3 color blocks are ALWAYS 4-color mode regardless
    of the c0<=c1 comparison (D3D spec); standalone BC1 uses the comparison
    to select the 3-color + punch-through-alpha mode."""
    n = raw.shape[0]
    c0 = raw[:, 0:2].copy().view("<u2")[:, 0]
    c1 = raw[:, 2:4].copy().view("<u2")[:, 0]
    idx = raw[:, 4:8].copy().view("<u4")[:, 0]
    p0 = _expand565(c0).astype(np.int32)
    p1 = _expand565(c1).astype(np.int32)
    four = np.ones(n, bool) if force_four else (c0 > c1)
    f = four[:, None]
    p2 = np.where(f, (2 * p0 + p1 + 1) // 3, (p0 + p1) // 2)
    p3 = np.where(f, (p0 + 2 * p1 + 1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], axis=1).astype(np.uint8)  # (N,4,3)
    alpha = np.full((n, 4, 1), 255, np.uint8)
    # 3-color mode: palette entry 3 is transparent black (punch-through).
    alpha[:, 3, 0] = np.where(four, 255, 0).astype(np.uint8)
    pal = np.concatenate([pal, alpha], axis=-1)  # (N,4,4)
    t = np.arange(16, dtype=np.uint32)
    sel = (idx[:, None] >> (2 * t)[None, :]) & 3  # (N, 16)
    return pal[np.arange(n)[:, None], sel]


def _alpha_block(raw: np.ndarray) -> np.ndarray:
    """BC3/BC4 interpolated-alpha half. raw: (N, 8) u8 → (N, 16) u8."""
    n = raw.shape[0]
    a0 = raw[:, 0].astype(np.int32)
    a1 = raw[:, 1].astype(np.int32)
    # 48-bit little-endian index stream, 3 bits per texel.
    bits = np.zeros(n, np.uint64)
    for i in range(6):
        bits |= raw[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    t = np.arange(16, dtype=np.uint64)
    sel = ((bits[:, None] >> (3 * t)[None, :]) & np.uint64(7)).astype(np.int32)
    eight = a0 > a1
    pal = np.zeros((n, 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for k in range(2, 8):
        # 8-entry mode: 6 interpolants /7. 6-entry mode: 4 interpolants /5
        # plus hard 0 and 255 endpoints.
        six = ((6 - k) * a0 + (k - 1) * a1 + 2) // 5 if k < 6 else (
            np.full(n, 0 if k == 6 else 255, np.int32)
        )
        pal[:, k] = np.where(eight, ((8 - k) * a0 + (k - 1) * a1 + 3) // 7, six)
    return pal[np.arange(n)[:, None], sel].astype(np.uint8)


def _blocks_to_image(texels: np.ndarray, w: int, h: int) -> np.ndarray:
    """(N, 16, C) decoded 4×4 blocks (row-major block order) → (h, w, C)."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    c = texels.shape[-1]
    img = texels.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, c)[:h, :w])


def decode_bc1(data: bytes, w: int, h: int) -> np.ndarray:
    """BC1 (DXT1): 8 B/block, RGB + 1-bit punch-through alpha → (h, w, 4)."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, 8)
    return _blocks_to_image(_color_block(raw, force_four=False), w, h)


def decode_bc2(data: bytes, w: int, h: int) -> np.ndarray:
    """BC2 (DXT3): 16 B/block, explicit 4-bit alpha + color → (h, w, 4)."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, 16)
    rgba = _color_block(raw[:, 8:], force_four=True)
    a = raw[:, :8]
    t = np.arange(16)
    nib = (a[:, t // 2] >> ((t % 2) * 4)[None, :]) & 0xF
    rgba[..., 3] = (nib | (nib << 4)).astype(np.uint8)  # 4→8 bit replication
    return _blocks_to_image(rgba, w, h)


def decode_bc3(data: bytes, w: int, h: int) -> np.ndarray:
    """BC3 (DXT5): 16 B/block, interpolated alpha + color → (h, w, 4)."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, 16)
    rgba = _color_block(raw[:, 8:], force_four=True)
    rgba[..., 3] = _alpha_block(raw[:, :8])
    return _blocks_to_image(rgba, w, h)


def decode_bc4(data: bytes, w: int, h: int) -> np.ndarray:
    """BC4: one interpolated-alpha block as a single channel → (h, w, 1)."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, 8)
    return _blocks_to_image(_alpha_block(raw)[..., None], w, h)


def decode_bc5(data: bytes, w: int, h: int) -> np.ndarray:
    """BC5: two BC4 blocks → (h, w, 2) (tangent-space normal XY)."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, 16)
    r = _alpha_block(raw[:, :8])
    g = _alpha_block(raw[:, 8:])
    return _blocks_to_image(np.stack([r, g], axis=-1), w, h)


_DECODERS = {
    "bc1": decode_bc1, "bc2": decode_bc2, "bc3": decode_bc3,
    "bc4": decode_bc4, "bc5": decode_bc5,
}


@dataclass
class DDSFile:
    """Parsed + decoded DDS: ``faces[f][m]`` is mip m of face f as
    (h, w, C) uint8 (C = 4 for BC1-3, 1 for BC4, 2 for BC5)."""

    width: int
    height: int
    mode: str  # bc1..bc5
    srgb: bool
    is_cube: bool
    faces: "list[list[np.ndarray]]"

    @property
    def mip_count(self) -> int:
        return len(self.faces[0])

    @property
    def channels(self) -> int:
        return self.faces[0][0].shape[-1]

    def _rgba(self, level: np.ndarray) -> np.ndarray:
        """Expand to 4 channels for device upload (R→R00α, RG→RG0α)."""
        h, w, c = level.shape
        if c == 4:
            return level
        out = np.zeros((h, w, 4), np.uint8)
        out[..., :c] = level
        out[..., 3] = 255
        return out

    def to_texture(self, name: str, srgb: "bool | None" = None, *,
                   device: "torch.device | str") -> Texture:
        """Device texture on ``device``: 2D with the file's full mip chain,
        or a cube map (base level per face — cube mips need the render
        graph's sub-views)."""
        srgb = self.srgb if srgb is None else srgb
        fmt = Format.RGBA8_SRGB if srgb else Format.RGBA8_UNORM
        if self.is_cube:
            stack = np.stack([self._rgba(f[0]) for f in self.faces])
            return Texture.from_numpy_layers(name, stack, fmt, cube=True, device=device)
        if self.mip_count == 1:
            return Texture.from_numpy(name, self._rgba(self.faces[0][0]), fmt, device=device)
        mips_np = [decode_stored(self._rgba(m), fmt) for m in self.faces[0]]
        desc = TextureDesc(name, self.width, self.height, fmt,
                           TextureUsage.SAMPLED, mip_levels=len(mips_np))
        mips_dev = [torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)
                    for m in mips_np]
        return Texture(desc, mips_dev[0], mips=mips_dev,
                       host_pixels=np.ascontiguousarray(mips_np[0], np.float32))

    def to_texture_asset(self, url: "AssetUrl | str") -> TextureAsset:
        """Base-level TextureAsset (the bake-pipeline representation)."""
        level = self.faces[0][0]
        fmt = {1: TextureFormat.R8, 2: TextureFormat.RG8,
               4: TextureFormat.RGBA8}[level.shape[-1]]
        if isinstance(url, str):
            url = AssetUrl(url)
        return TextureAsset(url, level, fmt)


def parse_dds(data: bytes) -> DDSFile:
    """Parse + decode a DDS payload (legacy FourCC or DX10 header)."""
    if len(data) < 128 or struct.unpack_from("<I", data, 0)[0] != _DDS_MAGIC:
        raise ValueError("not a DDS file (bad magic)")
    (size, _flags, height, width, _pitch, _depth, mip_count) = struct.unpack_from(
        "<7I", data, 4
    )
    if size != 124:
        raise ValueError(f"bad DDS header size {size}")
    pf_size, pf_flags, fourcc = struct.unpack_from("<IIi", data, 76)
    fourcc_b = struct.pack("<i", fourcc)
    caps2 = struct.unpack_from("<I", data, 112)[0]
    mip_count = max(mip_count, 1)
    offset = 128
    srgb = False
    if not (pf_flags & _DDPF_FOURCC):
        raise ValueError(
            "uncompressed DDS is unsupported — use PNG for raw pixels; "
            "this loader exists for the BCn formats"
        )
    if fourcc_b == b"DX10":
        dxgi, _dim, _misc, array_size, _misc2 = struct.unpack_from(
            "<5I", data, 128
        )
        offset = 148
        if dxgi not in _DXGI:
            raise ValueError(
                f"unsupported DXGI format {dxgi} (BC1-BC5 supported; BC6H/"
                f"BC7 compression is out of scope for this decoder)"
            )
        mode, block_bytes, _chans, srgb = _DXGI[dxgi]
        if array_size not in (0, 1, 6):
            raise ValueError(f"unsupported DDS array size {array_size}")
    else:
        if fourcc_b not in _FOURCC:
            raise ValueError(f"unsupported DDS FourCC {fourcc_b!r}")
        mode, block_bytes, _chans = _FOURCC[fourcc_b]
        srgb = mode in ("bc1", "bc2", "bc3")  # legacy color content
    is_cube = bool(caps2 & _DDSCAPS2_CUBEMAP)
    num_faces = 6 if is_cube else 1
    if is_cube and (caps2 & _DDSCAPS2_ALL_FACES) != _DDSCAPS2_ALL_FACES:
        raise ValueError("partial cube maps are unsupported")

    decoder = _DECODERS[mode]
    faces = []
    for _f in range(num_faces):
        mips = []
        w, h = width, height
        for _m in range(mip_count):
            nbytes = ((w + 3) // 4) * ((h + 3) // 4) * block_bytes
            if offset + nbytes > len(data):
                raise ValueError("truncated DDS payload")
            mips.append(decoder(data[offset:offset + nbytes], w, h))
            offset += nbytes
            w, h = max(1, w // 2), max(1, h // 2)
        faces.append(mips)
    return DDSFile(width=width, height=height, mode=mode, srgb=srgb,
                   is_cube=is_cube, faces=faces)


def load_dds(path: str) -> DDSFile:
    """Parse + decode a .dds file from disk (mmap'd read, core.fileio)."""
    from zenith_tpu_torch.core.fileio import load_bytes

    return parse_dds(load_bytes(path))

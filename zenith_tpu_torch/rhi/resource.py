"""Buffers and textures as typed tensor wrappers (torch port of
zenith_tpu/rhi/resource.py).

Mirrors the reference resource model (zenith-rhi/src/buffer.rs, texture.rs):
descs are hashable cache keys (buffer.rs:139-157, texture.rs:257-293); the
resources themselves wrap device arrays. What *doesn't* carry over — by
design — is everything Vulkan needs and PyTorch doesn't: memory-type
selection, bind/allocate, image layouts, resource states and barriers (the
stream orders the work).

Every resource lives on an explicit ``torch.device``: a resource made from
a tensor keeps that tensor's device; one made without a tensor, and every
upload from numpy, takes ``device=`` as a required keyword (there is no
default device; ``RenderDevice.upload_buffer`` passes its own). Resources
are functional: a "write" produces a new wrapper around a new tensor. The
render graph threads tensor values through node stages.
"""

from __future__ import annotations

import enum
import functools

from zenith_tpu_torch.core.collections import FastFlag
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from zenith_tpu_torch.rhi.formats import Format, decode_stored


def _required_device(device, what: str):
    """``device``, which a resource made without a tensor must be given."""
    if device is None:
        raise TypeError(f"{what} made without an array needs device= (there is no default "
                        f"device)")
    return device


class ShapeDtype(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class BufferUsage(FastFlag):
    """(reference buffer.rs:47-94 preset ctors)"""

    VERTEX = enum.auto()
    INDEX = enum.auto()
    UNIFORM = enum.auto()
    STORAGE = enum.auto()
    STAGING = enum.auto()
    TRANSFER_SRC = enum.auto()
    TRANSFER_DST = enum.auto()


class TextureUsage(FastFlag):
    SAMPLED = enum.auto()
    STORAGE = enum.auto()
    COLOR_ATTACHMENT = enum.auto()
    DEPTH_ATTACHMENT = enum.auto()
    TRANSFER_SRC = enum.auto()
    TRANSFER_DST = enum.auto()


@dataclass(frozen=True)
class BufferDesc:
    """Hashable buffer descriptor (reference buffer.rs:16-157).

    Buffers are typed tensors, so the desc carries (shape, dtype) rather
    than a byte size; `size` in elements = prod(shape).
    """

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    usage: BufferUsage = BufferUsage.STORAGE

    # Preset constructors mirroring buffer.rs:47-94.
    @staticmethod
    def vertex(name: str, num_vertices: int, stride_floats: int) -> "BufferDesc":
        return BufferDesc(name, (num_vertices, stride_floats), "float32", BufferUsage.VERTEX)

    @staticmethod
    def index(name: str, num_indices: int) -> "BufferDesc":
        return BufferDesc(name, (num_indices,), "int32", BufferUsage.INDEX)

    @staticmethod
    def uniform(name: str, num_floats: int) -> "BufferDesc":
        return BufferDesc(name, (num_floats,), "float32", BufferUsage.UNIFORM)

    @staticmethod
    def storage(name: str, shape: Tuple[int, ...], dtype: str = "float32") -> "BufferDesc":
        return BufferDesc(name, tuple(shape), dtype, BufferUsage.STORAGE)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def shape_dtype(self) -> ShapeDtype:
        return ShapeDtype(tuple(self.shape), _torch_dtype(self.dtype))


class Buffer:
    """A typed device array with a desc (reference buffer.rs:160-274)."""

    def __init__(self, desc: BufferDesc, array: Optional[torch.Tensor] = None, *,
                 device: "torch.device | str | None" = None):
        if array is None:
            array = torch.zeros(desc.shape, dtype=_torch_dtype(desc.dtype),
                                device=_required_device(device, f"buffer '{desc.name}'"))
        assert tuple(array.shape) == tuple(desc.shape), (
            f"buffer '{desc.name}': array shape {array.shape} != desc {desc.shape}"
        )
        self.desc = desc
        self.array = array

    @staticmethod
    def from_numpy(name: str, data: np.ndarray, usage: BufferUsage = BufferUsage.STORAGE, *,
                   device: "torch.device | str") -> "Buffer":
        """Host→device upload (the UploadPool analog, reference upload.rs —
        ``tensor.to(device)`` replaces the staging buffer + copy + barrier
        dance)."""
        data = np.ascontiguousarray(data)
        desc = BufferDesc(name, tuple(data.shape), str(data.dtype), usage)
        return Buffer(desc, torch.from_numpy(data).to(device))

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.desc.shape

    def with_array(self, array: torch.Tensor) -> "Buffer":
        return Buffer(self.desc, array)

    @property
    def debug_name(self) -> str:
        """Diagnostics name: explicit set_debug_name override, else the
        desc name (reference DebuggableObject, device.rs:16-68)."""
        return getattr(self, "_debug_name", None) or self.desc.name

    @debug_name.setter
    def debug_name(self, value: str) -> None:
        self._debug_name = value

    def read_back(self) -> np.ndarray:
        return self.array.cpu().numpy()


@dataclass(frozen=True)
class TextureDesc:
    """Hashable texture descriptor (reference texture.rs:17-293)."""

    name: str
    width: int
    height: int
    format: Format = Format.RGBA8_SRGB
    usage: TextureUsage = TextureUsage.SAMPLED
    mip_levels: int = 1
    array_layers: int = 1
    depth: int = 1  # 3D textures

    # Preset constructors mirroring texture.rs:64-179.
    @staticmethod
    def new_2d(name: str, width: int, height: int, format: Format,
               usage: TextureUsage = TextureUsage.SAMPLED, mip_levels: int = 1) -> "TextureDesc":
        return TextureDesc(name, width, height, format, usage, mip_levels)

    @staticmethod
    def new_3d(name: str, width: int, height: int, depth: int, format: Format,
               usage: TextureUsage = TextureUsage.SAMPLED) -> "TextureDesc":
        """(texture.rs:81-92) Volume texture: (D, H, W, C) on device."""
        return TextureDesc(name, width, height, format, usage, depth=depth)

    @staticmethod
    def new_cube(name: str, size: int, format: Format,
                 usage: TextureUsage = TextureUsage.SAMPLED) -> "TextureDesc":
        """(texture.rs:94-105) Cube map: 6 array layers, +X -X +Y -Y +Z -Z."""
        return TextureDesc(name, size, size, format, usage, array_layers=6)

    @staticmethod
    def new_2d_array(name: str, width: int, height: int, layers: int,
                     format: Format,
                     usage: TextureUsage = TextureUsage.SAMPLED) -> "TextureDesc":
        """(texture.rs:107-114) Layered 2D texture: (L, H, W, C) on device."""
        return TextureDesc(name, width, height, format, usage,
                           array_layers=layers)

    @staticmethod
    def color(name: str, width: int, height: int,
              format: Format = Format.RGBA32F) -> "TextureDesc":
        """Memoized: renderers call this every frame for their attachment
        descs (the graph is rebuilt per frame); returning the SAME frozen
        instance keeps the per-frame desc cost at a dict probe and lets
        the structure key / pipeline cache hit identity fast paths."""
        return _color_texture_desc(name, width, height, format)

    @staticmethod
    def stencil(name: str, width: int, height: int) -> "TextureDesc":
        """A standalone stencil plane (the reference's stencil_format rides
        beside depth_format, pipeline.rs:23-28; here it is its own plane)."""
        return TextureDesc(name, width, height, Format.S8,
                           TextureUsage.DEPTH_ATTACHMENT | TextureUsage.SAMPLED)

    @property
    def extent(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def device_shape(self) -> Tuple[int, ...]:
        """On-device layout: (H, W, C) [row 0 = top, matching Vulkan
        framebuffer coords], mips stored separately. Stencil is a bare
        (H, W) int32 plane."""
        if self.format.is_stencil:
            return (self.height, self.width)
        c = self.format.channels
        if self.depth > 1:
            return (self.depth, self.height, self.width, c)
        if self.array_layers > 1:
            return (self.array_layers, self.height, self.width, c)
        return (self.height, self.width, c)

    def shape_dtype(self) -> ShapeDtype:
        return ShapeDtype(self.device_shape(), self.format.compute_dtype)


# Flag unions precomputed once: FastFlag.__or__ is Python-level and these
# run per desc per frame on the rebuild path.
_COLOR_USAGE = TextureUsage.COLOR_ATTACHMENT | TextureUsage.SAMPLED
_DEPTH_USAGE = TextureUsage.DEPTH_ATTACHMENT | TextureUsage.SAMPLED


@functools.lru_cache(maxsize=4096)
def _color_texture_desc(name: str, width: int, height: int,
                        format: Format) -> "TextureDesc":
    return TextureDesc(name, width, height, format, _COLOR_USAGE)


@functools.lru_cache(maxsize=4096)
def _depth_texture_desc(name: str, width: int, height: int) -> "TextureDesc":
    return TextureDesc(name, width, height, Format.D32F, _DEPTH_USAGE)


# The reference exposes both a `depth` extent field and a `depth(...)` preset
# ctor (texture.rs:64-179). In Python a method in the class body would shadow
# the dataclass field's DEFAULT at decoration time (round-1 latent bug: descs
# built without depth= carried the function as their depth), so the preset is
# attached after the class is finalized — instances still read the int field.
TextureDesc.depth = staticmethod(_depth_texture_desc)


class Texture:
    """A device image in linear float space, row 0 = top.

    ``array`` is (H, W, C) float32 (or a list of such per mip level in
    ``mips`` when mip_levels > 1).
    """

    def __init__(self, desc: TextureDesc, array: Optional[torch.Tensor] = None,
                 mips: "Optional[list[torch.Tensor]]" = None,
                 host_pixels: "Optional[np.ndarray]" = None, *,
                 device: "torch.device | str | None" = None):
        if array is None:
            array = torch.zeros(desc.device_shape(), dtype=desc.format.compute_dtype,
                                device=_required_device(device, f"texture '{desc.name}'"))
        self.desc = desc
        self.array = array
        self.mips = mips  # mips[0] is `array` when present
        # Decoded linear host copy, kept by the from_numpy ctors, so host-side
        # consumers need no device→host copy.
        self.host_pixels = host_pixels

    def host_linear(self) -> np.ndarray:
        """Linear float host pixels WITHOUT a device read when possible."""
        if self.host_pixels is not None:
            return self.host_pixels
        return self.array.cpu().numpy()

    @property
    def debug_name(self) -> str:
        """Diagnostics name: explicit set_debug_name override, else the
        desc name (reference DebuggableObject, device.rs:16-68)."""
        return getattr(self, "_debug_name", None) or self.desc.name

    @debug_name.setter
    def debug_name(self, value: str) -> None:
        self._debug_name = value

    @staticmethod
    def from_numpy(name: str, pixels: np.ndarray, format: Format,
                   usage: TextureUsage = TextureUsage.SAMPLED,
                   generate_mips: bool = False, *,
                   device: "torch.device | str") -> "Texture":
        """Upload host pixels (at-rest dtype, e.g. sRGB u8) → linear float
        device image; optionally builds a full mip chain (box filter)."""
        linear = decode_stored(pixels, format)
        if linear.ndim == 2:
            linear = linear[..., None]
        h, w, _ = linear.shape
        mips_np = [linear]
        levels = 1
        if generate_mips:
            cur = linear
            while min(cur.shape[0], cur.shape[1]) > 1:
                hh = max(1, cur.shape[0] // 2)
                ww = max(1, cur.shape[1] // 2)
                cur = cur[: hh * 2, : ww * 2]
                cur = cur.reshape(hh, 2, ww, 2, cur.shape[-1]).mean(axis=(1, 3))
                mips_np.append(cur.astype(np.float32))
            levels = len(mips_np)
        desc = TextureDesc(name, w, h, format, usage, mip_levels=levels)
        mips_dev = [torch.from_numpy(np.ascontiguousarray(m)).to(device) for m in mips_np]
        return Texture(desc, mips_dev[0],
                       mips=mips_dev if levels > 1 else None,
                       host_pixels=np.ascontiguousarray(linear, np.float32))

    @staticmethod
    def from_numpy_layers(name: str, pixels: np.ndarray, format: Format,
                          usage: TextureUsage = TextureUsage.SAMPLED,
                          cube: bool = False, *,
                          device: "torch.device | str") -> "Texture":
        """Upload a layered image stack (L, H, W, C) → 2D-array texture
        (or a cube map when L == 6 and ``cube``; Vulkan face order
        +X -X +Y -Y +Z -Z)."""
        linear = decode_stored(pixels, format)
        assert linear.ndim == 4, f"expected (L, H, W, C), got {linear.shape}"
        layers, h, w, _ = linear.shape
        if cube:
            assert layers == 6 and h == w, "cube maps are 6 square layers"
            desc = TextureDesc.new_cube(name, w, format, usage)
        else:
            desc = TextureDesc.new_2d_array(name, w, h, layers, format, usage)
        return Texture(desc, torch.from_numpy(np.ascontiguousarray(linear)).to(device),
                       host_pixels=np.ascontiguousarray(linear, np.float32))

    @staticmethod
    def from_numpy_3d(name: str, pixels: np.ndarray, format: Format,
                      usage: TextureUsage = TextureUsage.SAMPLED, *,
                      device: "torch.device | str") -> "Texture":
        """Upload a volume (D, H, W, C) → 3D texture."""
        linear = decode_stored(pixels, format)
        assert linear.ndim == 4, f"expected (D, H, W, C), got {linear.shape}"
        d, h, w, _ = linear.shape
        desc = TextureDesc.new_3d(name, w, h, d, format, usage)
        return Texture(desc, torch.from_numpy(np.ascontiguousarray(linear)).to(device))

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def width(self) -> int:
        return self.desc.width

    @property
    def height(self) -> int:
        return self.desc.height

    def with_array(self, array: torch.Tensor) -> "Texture":
        return Texture(self.desc, array, mips=self.mips)

    def read_back(self) -> np.ndarray:
        return self.array.cpu().numpy()


@dataclass
class ResourceCacheStats:
    """(reference resource_cache.rs:62-77)"""

    hits: int = 0
    misses: int = 0
    recycled: int = 0


class ResourceCache:
    """Desc-keyed transient resource recycler (reference
    resource_cache.rs:4-71). Only *host-persistent* tensors need recycling
    (swapchain ring, readback staging); graph-managed intermediates are
    temporaries of PyTorch's caching allocator."""

    def __init__(self, device: "torch.device | str") -> None:
        self._pool: dict[object, list] = {}
        self.stats = ResourceCacheStats()
        self.device = device

    def acquire(self, desc):
        entries = self._pool.get(desc)
        if entries:
            self.stats.hits += 1
            return entries.pop()
        self.stats.misses += 1
        if isinstance(desc, TextureDesc):
            return Texture(desc, device=self.device)
        if isinstance(desc, BufferDesc):
            return Buffer(desc, device=self.device)
        raise TypeError(f"unknown desc type {type(desc)!r}")

    def recycle(self, desc, resource) -> None:
        self._pool.setdefault(desc, []).append(resource)
        self.stats.recycled += 1

    def clear(self) -> None:
        self._pool.clear()

"""Asset registry + asset model (torch port of zenith_tpu/asset; reference
zenith-asset/src/lib.rs). The asset pipeline is host NumPy code: the port
keeps its own copy and touches torch only where a texture is uploaded to an
explicit device (``dds.DDSFile.to_texture``,
``renderer.scene.SceneObject.from_mesh_with_material``).

- Global registry keyed by (AssetUrl, type) behind an RW lock
  (lib.rs:22-67) — here a module-global with an RLock.
- ``Asset`` base + ``AssetType`` extension mapping (lib.rs:70-101):
  mesh ".mesh", texture ".tex", material ".mat", collection ".mscl".
- Typed ``AssetHandle``/``AssetRef`` (lib.rs:152-209).
- Serialization: bincode → ``.npz`` (NumPy arrays + a JSON metadata blob)
  (lib.rs:256-279).

Where the reference asserts on its inputs (an absolute URL, an unpaired
collection, a registry used before ``initialize``), the port raises
``ValueError`` / ``RuntimeError``: asserts vanish under ``python -O``.
"""

from __future__ import annotations

import enum
import io
import json
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Generic, Optional, Tuple, Type, TypeVar

import numpy as np

from zenith_tpu_torch.core import log

logger = log.get(__name__)

T = TypeVar("T", bound="Asset")


class AssetType(enum.Enum):
    """(lib.rs:70-101)"""

    MESH = "mesh"
    TEXTURE = "tex"
    MATERIAL = "mat"
    MESH_COLLECTION = "mscl"

    @property
    def extension(self) -> str:
        return self.value


@dataclass(frozen=True)
class AssetUrl:
    """Relative asset path (lib.rs:114-149).

    >>> AssetUrl("mesh/cerberus/scene.gltf").path
    'mesh/cerberus/scene.gltf'
    """

    path: str

    def __post_init__(self):
        if self.path.startswith("/"):
            raise ValueError(f"asset urls are relative, got {self.path!r}")

    def with_extension(self, ext: str) -> "AssetUrl":
        p = Path(self.path)
        return AssetUrl(str(p.with_suffix(f".{ext}")))

    def sibling(self, name: str) -> "AssetUrl":
        return AssetUrl(str(Path(self.path).parent / name))

    def __str__(self) -> str:
        return self.path


class Asset:
    """Base asset (lib.rs:216-220). Subclasses implement (de)serialization
    via numpy-array dicts + JSON metadata."""

    asset_type: AssetType

    def __init__(self, url: AssetUrl):
        self.url = url

    # -- serialization (lib.rs:256-279) ---------------------------------------

    def arrays(self) -> "Dict[str, np.ndarray]":
        raise NotImplementedError

    def metadata(self) -> "Dict[str, Any]":
        raise NotImplementedError

    @classmethod
    def from_parts(cls: "Type[T]", url: AssetUrl, arrays: "Dict[str, np.ndarray]",
                   metadata: "Dict[str, Any]") -> "T":
        raise NotImplementedError

    def save(self, path: "Path") -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        buf = io.BytesIO()
        arrays = dict(self.arrays())
        arrays["__meta__"] = np.frombuffer(
            json.dumps(self.metadata()).encode(), dtype=np.uint8
        )
        np.savez(buf, **arrays)
        path.write_bytes(buf.getvalue())

    @classmethod
    def load(cls: "Type[T]", url: AssetUrl, path: "Path") -> "T":
        with np.load(path, mmap_mode=None, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
            meta = json.loads(bytes(data["__meta__"]).decode())
        return cls.from_parts(url, arrays, meta)


class AssetRef(Generic[T]):
    """Borrowed view of a registered asset (lib.rs:195-209)."""

    def __init__(self, asset: T):
        self._asset = asset

    def __getattr__(self, name: str) -> Any:
        return getattr(self._asset, name)

    def get(self) -> T:
        return self._asset


@dataclass(frozen=True)
class AssetHandle(Generic[T]):
    """Typed handle; resolution goes through the registry (lib.rs:152-193)."""

    url: AssetUrl
    type_name: str

    def get(self) -> "AssetRef[T]":
        asset = registry().get_by_name(self.url, self.type_name)
        if asset is None:
            raise KeyError(f"asset {self.url} ({self.type_name}) not registered")
        return AssetRef(asset)

    def try_get(self) -> "Optional[AssetRef[T]]":
        asset = registry().get_by_name(self.url, self.type_name)
        return AssetRef(asset) if asset is not None else None


class AssetRegistry:
    """(lib.rs:29-67)"""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._assets: Dict[Tuple[str, str], Asset] = {}

    def register(self, asset: Asset) -> AssetHandle:
        key = (asset.url.path, type(asset).__name__)
        with self._lock:
            self._assets[key] = asset
        return AssetHandle(asset.url, type(asset).__name__)

    def unregister(self, url: AssetUrl, asset_class: "Type[Asset]") -> None:
        with self._lock:
            self._assets.pop((url.path, asset_class.__name__), None)

    def get(self, url: AssetUrl, asset_class: "Type[T]") -> "Optional[T]":
        return self.get_by_name(url, asset_class.__name__)

    def get_by_name(self, url: AssetUrl, type_name: str) -> "Optional[Asset]":
        with self._lock:
            return self._assets.get((url.path, type_name))

    def handle(self, url: AssetUrl, asset_class: "Type[T]") -> "AssetHandle[T]":
        return AssetHandle(url, asset_class.__name__)

    def __len__(self) -> int:
        with self._lock:
            return len(self._assets)

    def clear(self) -> None:
        with self._lock:
            self._assets.clear()


_REGISTRY: Optional[AssetRegistry] = None


def initialize() -> None:
    """(lib.rs:22-26) idempotent global registry init."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = AssetRegistry()


def registry() -> AssetRegistry:
    if _REGISTRY is None:
        raise RuntimeError("call zenith_tpu_torch.asset.initialize() first")
    return _REGISTRY


from zenith_tpu_torch.asset.render_types import (  # noqa: E402
    AnimationChannel,
    AnimationClip,
    Material,
    Mesh,
    MeshCollection,
    Skin,
    SkinnedVertex,
    TextureAsset,
    TextureFormat,
    Vertex,
)
from zenith_tpu_torch.asset.manager import AssetManager  # noqa: E402

__all__ = [
    "Asset",
    "AssetHandle",
    "AssetManager",
    "AssetRef",
    "AssetRegistry",
    "AssetType",
    "AssetUrl",
    "AnimationChannel",
    "AnimationClip",
    "Material",
    "Mesh",
    "MeshCollection",
    "Skin",
    "SkinnedVertex",
    "TextureAsset",
    "TextureFormat",
    "Vertex",
    "initialize",
    "registry",
]

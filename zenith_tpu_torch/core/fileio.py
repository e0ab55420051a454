"""File IO helpers (reference zenith-core/src/file.rs:6-9).

``load_with_memory_mapping`` mirrors the reference's memmap2-based loader:
it returns a read-only memoryview over an mmap'd file, avoiding a copy for
large asset blobs (glTF .bin buffers, baked caches).
"""

from __future__ import annotations

import mmap
from pathlib import Path


def load_with_memory_mapping(path: "str | Path") -> memoryview:
    """Memory-map ``path`` read-only and return a memoryview of its bytes."""
    with open(path, "rb") as f:
        # length=0 maps the whole file; ACCESS_READ keeps it copy-free.
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return memoryview(mm)


def load_bytes(path: "str | Path") -> bytes:
    return Path(path).read_bytes()

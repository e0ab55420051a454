"""Collections aliases (reference zenith-core/src/collections.rs:5-35).

The reference aliases hashbrown maps with a foldhash-seeded hasher and
smallvec. Python's builtins already are the optimized equivalents; the
aliases keep call sites reading the same, and ``default_hasher`` exposes the
framework's canonical stable content hash (used by the render-graph
structure key) — the foldhash analog, backed by the native module when
built (zenith_tpu_torch.native).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Set

HashMap = dict
HashSet = set
SmallVec = list


class FastEnum(enum.Enum):
    """Enum with C-speed identity hashing.

    ``enum.Enum.__hash__`` is a Python-level ``hash(self._name_)`` — measured
    at ~470 calls/frame inside the render-graph structure-key hash (the desc
    dataclasses are full of enum fields). Members are per-process singletons,
    so identity hashing is exactly as correct and runs in the C slot.
    """

    __hash__ = object.__hash__


class FastFlag(enum.Flag):
    """Flag with C-speed identity hashing (composed members are cached
    singletons via ``_value2member_map_``, so identity is stable)."""

    __hash__ = object.__hash__


def cached_hash(cls):
    """Class decorator for *frozen* dataclasses: memoize ``__hash__`` per
    instance (stored via ``object.__setattr__``).

    The render-graph structure key embeds pipeline/state descs and is hashed
    every frame; the descs are immutable and long-lived (renderers build them
    once), so re-deriving the field-tuple hash per frame is pure waste. The
    cache slot ``_zh_`` lives in ``__dict__`` and is invisible to the
    generated ``__eq__``/``__repr__`` (both walk declared fields only).

    Apply ABOVE ``@dataclass(frozen=True)`` so it overwrites the generated
    ``__hash__``.
    """

    field_names = tuple(cls.__dataclass_fields__)

    def __hash__(self):
        h = self.__dict__.get("_zh_")
        if h is None:
            d = self.__dict__
            h = hash(tuple(d[f] for f in field_names))
            object.__setattr__(self, "_zh_", h)
        return h

    cls.__hash__ = __hash__
    return cls


def default_hasher(data: bytes) -> int:
    """Stable 64-bit content hash (foldhash-seeded DefaultHasher analog)."""
    from zenith_tpu_torch.native import fast_hash

    return fast_hash(data)

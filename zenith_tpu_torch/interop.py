"""Host arrays → the port's tensors.

The reference package's results reach the port as numpy arrays (buffer
contents, ``TriangleRecords``, ``SegmentedBins``); these helpers turn them
into the port's tensors on a given device, field for field, so the same
inputs can be fed to both implementations.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zenith_tpu_torch.ops.binning import SegmentedBins
from zenith_tpu_torch.ops.geometry import TriangleRecords


def to_tensor(array: Any, device: "torch.device | str") -> torch.Tensor:
    """Any array-like (numpy, or anything ``np.asarray`` takes) → a tensor
    with the same dtype and contents on ``device``."""
    return torch.from_numpy(np.array(array, copy=True)).to(device)


def records_from_numpy(records: Any, device: "torch.device | str") -> TriangleRecords:
    """A (rast16, shade16, tri_id, valid, aabb) tuple of arrays → records."""
    return TriangleRecords(*[to_tensor(f, device) for f in records])


def bins_from_numpy(bins: Any, device: "torch.device | str") -> SegmentedBins:
    """The seven fields of a SegmentedBins, as arrays → SegmentedBins."""
    return SegmentedBins(*[to_tensor(f, device) for f in bins])

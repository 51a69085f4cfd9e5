"""Masked column values: a data tensor with an optional validity mask.

``mask=None`` means all-valid, so non-null columns stay mask-free end to
end.  Scalars are 0-d tensors.  (Counterpart of hdk_tpu/exec/masked.py.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# numpy dtype -> torch dtype for the engine's physical column types
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a logical type's ``physical_dtype()``."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


@dataclass
class MaskedCol:
    """data + validity (True = valid)."""

    data: torch.Tensor
    mask: Optional[torch.Tensor] = None  # bool, shaped like data, or None

    def valid_mask(self) -> torch.Tensor:
        """Materialized mask (all-True if mask is None)."""
        if self.mask is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return self.mask

    def fill(self, value) -> torch.Tensor:
        """Data with nulls replaced by ``value``."""
        if self.mask is None:
            return self.data
        return torch.where(self.mask, self.data,
                           torch.tensor(value, dtype=self.data.dtype,
                                        device=self.data.device))


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of optional masks (null-propagating ops)."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out


def nonzero_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """First ``n`` indices where mask is True, in order."""
    return torch.nonzero(mask).reshape(-1)[:n]


def from_numpy(data: np.ndarray, mask: Optional[np.ndarray],
               device) -> MaskedCol:
    """A MaskedCol on ``device`` from host arrays (copies)."""
    from ..storage.table import to_device

    device = torch.device(device)
    return MaskedCol(to_device(data, device),
                     None if mask is None else to_device(mask, device))

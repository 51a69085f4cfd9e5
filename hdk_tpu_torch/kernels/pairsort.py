"""Key-carrying sort of (group, value) pairs, group by group, for exact
per-group quantiles.

``group_sorted_keys`` launches ``csrc/pair_sort.cu`` on a CUDA tensor:
each row's float64 value becomes its 64-bit orderable key (bit for bit
``orderable_int64`` of a float64), the key is written into its group's
run (``starts[g]`` on), and each run is sorted in shared memory.  No
permutation is built and nothing is gathered through one.  A run holds at most ``CAPACITY`` keys: the
caller reads the largest group's count once and takes another route
above it.

``group_sorted_keys_ref`` is the plain version (two stable
``torch.sort`` passes over the live rows); a CPU tensor goes to it.
``group_sorted_keys.launches`` counts the calls that launched the kernels
and nothing else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# keys of one group the kernel sorts in shared memory: one block of 1024
# threads holding 16 keys each (csrc/pair_sort.cu, kCapacity)
CAPACITY = 16384

_LOW63 = 0x7FFFFFFFFFFFFFFF


def orderable_int64(data: torch.Tensor) -> torch.Tensor:
    """Map values to int64 preserving order (floats via the IEEE
    total-order trick: negative patterns flip all but the sign bit;
    +/-0.0 compare equal, NaN sorts above +inf)."""
    if data.dtype == torch.float32:
        b = data.view(torch.int32)
        o = b ^ ((b >> 31) & 0x7FFFFFFF)
        o = torch.where(data == 0, 0, o)
        return o.to(torch.int64)
    if data.is_floating_point():
        x = data.to(torch.float64)
        bits = x.view(torch.int64)
        o = bits ^ ((bits >> 63) & _LOW63)
        o = torch.where(x == 0, 0, o)
        return torch.where(torch.isnan(x), 0x7FF8000000000000, o)
    return data.to(torch.int64)


def values_of(keys: torch.Tensor) -> torch.Tensor:
    """float64 values of orderable keys (``orderable_int64`` of float64
    values) turned back: a key's bits with all but the sign flipped where
    it is negative, so +-0.0 come back as +0.0 and every NaN as
    ``0x7FF8000000000000``."""
    return (keys ^ ((keys >> 63) & _LOW63)).view(torch.float64)


def _check(vals, gid, valid, counts) -> None:
    if vals.dtype != torch.float64 or vals.dim() != 1:
        raise ValueError(f"values must be 1-D float64, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if gid.dtype != torch.int32 or gid.shape != vals.shape:
        raise ValueError(f"gid must be int32 of {tuple(vals.shape)}, got "
                         f"{gid.dtype} {tuple(gid.shape)}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != vals.shape):
        raise ValueError(f"validity must be bool of {tuple(vals.shape)}, "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise ValueError(f"counts must be 1-D int64, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    for t in (gid, counts) + (() if valid is None else (valid,)):
        if t.device != vals.device:
            raise ValueError(f"tensors on {vals.device} and {t.device}")


def group_sorted_keys_ref(vals: torch.Tensor, gid: torch.Tensor,
                          valid: Optional[torch.Tensor],
                          counts: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the live rows' keys sorted by key, then stably
    by group."""
    live = (gid >= 0) & (gid < counts.shape[0])
    if valid is not None:
        live = live & valid
    keys, order = torch.sort(orderable_int64(vals[live]), stable=True)
    _, by_group = torch.sort(gid[live][order], stable=True)
    out = torch.zeros(vals.shape, dtype=torch.int64, device=vals.device)
    out[:keys.shape[0]] = keys[by_group]
    return out, torch.cumsum(counts, 0) - counts


def group_sorted_keys(vals: torch.Tensor, gid: torch.Tensor,
                      valid: Optional[torch.Tensor], counts: torch.Tensor,
                      largest: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, starts): (N,) int64 keys, the orderable keys of the values
    of the rows r with 0 <= gid[r] < G and valid[r] (no validity: every
    such row), group g's ascending from ``starts[g]``, the exclusive
    prefix sums of ``counts``.  ``counts`` (G,) are the groups' counts of
    such rows, ``largest`` the largest of them (at most ``CAPACITY``).
    Entries past the last group's run hold nothing meaningful."""
    _check(vals, gid, valid, counts)
    if largest > CAPACITY:
        raise ValueError(f"a group of {largest} keys is more than the "
                         f"{CAPACITY} a block sorts")
    if vals.device.type == "cpu":
        return group_sorted_keys_ref(vals, gid, valid, counts)
    if vals.device.type != "cuda":
        raise ValueError(f"no pair-sort kernel for device {vals.device}")
    from . import build

    vals, gid, counts = (t.contiguous() for t in (vals, gid, counts))
    if valid is not None:
        valid = valid.contiguous()
    n_rows, n_groups = vals.shape[0], counts.shape[0]
    dev = vals.device
    starts = torch.cumsum(counts, 0) - counts
    out = torch.empty((n_rows,), dtype=torch.int64, device=dev)
    cursor = torch.empty((n_groups,), dtype=torch.int64, device=dev)
    work = torch.empty((n_groups + 1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.library().hdk_pair_sort(
            vals.data_ptr(), gid.data_ptr(),
            None if valid is None else valid.data_ptr(), n_rows, n_groups,
            largest, starts.data_ptr(), counts.data_ptr(), cursor.data_ptr(),
            work.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hdk_pair_sort: CUDA error {err}")
    group_sorted_keys.launches += 1
    return out, starts


group_sorted_keys.launches = 0

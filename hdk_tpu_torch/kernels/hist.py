"""Dense-histogram kernels of the perfect-hash GROUP BY.

Four wrappers keep the names of the TPU kernels they replace
(``hdk_tpu/ops/pallas_*.py``) and launch ``csrc/hist.cu`` on a CUDA tensor:

  * ``count_hist``     (K4, pallas_hist2.py)  counts of gid      -> (E,) int64
  * ``groupby_sums2``  (K2, pallas_groupby.py) bool slots       -> (E, S) int64
  * ``seg_sums_exact`` (K3, pallas_hist.py)   int8..int64 slots -> (L, E) int64
  * ``groupby_sums``   (K1, pallas_groupby.py) S f32/f64 columns -> (E, S) float64

Each computes, over the rows r with 0 <= gid[r] < E, the sum of the row's
slot values per gid; rows with gid outside [0, E) drop out.  The TPU
kernels' limits (E <= 4096, |v| <= 255, N < 2^24, f32 accumulators) came
from the MXU and do not apply: results are exact int64 (wrapping like
int64 addition) and float64.

Each wrapper has a plain PyTorch version beside it (``*_ref``).  A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel or
raises; any other device raises.  ``<wrapper>.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

# (L x E) shared-memory partials above this many bytes add straight into
# global memory instead (H100: 227 KB per block at most)
SMEM_LIMIT_BYTES = 200 * 1024

# K1 (csrc/hist.cu::k1_kernel): columns per launch, and the most entries
# for which each warp keeps a private (S x E) copy (above it one copy per
# block is faster: measured on one H100, PERF.md)
K1_MAX_COLS = 8
K1_PRIVATE_MAX_ENTRIES = 16

_INT_SUFFIX = {torch.int8: "i8", torch.int16: "i16", torch.int32: "i32",
               torch.int64: "i64"}
_FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _route(gid: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version; raises on a
    device that has neither, or on mixed devices."""
    for o in others:
        if o.device != gid.device:
            raise ValueError(f"tensors on {gid.device} and {o.device}")
    if gid.device.type == "cuda":
        return True
    if gid.device.type == "cpu":
        return False
    raise ValueError(f"no histogram kernel for device {gid.device}")


def _check_gid(gid: torch.Tensor) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError(f"gid must be 1-D int32, got {gid.dtype} "
                         f"{tuple(gid.shape)}")


def _check_rows(gid: torch.Tensor, vals: torch.Tensor) -> None:
    if vals.dim() != 2 or vals.shape[0] != gid.shape[0]:
        raise ValueError(f"slots {tuple(vals.shape)} do not match "
                         f"{gid.shape[0]} rows")


def _launch(name: str, gid: torch.Tensor, *args) -> None:
    from . import build

    if not (gid.is_contiguous()):
        raise ValueError(f"{name}: gid must be contiguous")
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        err = getattr(build.library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _use_shared(n_slots: int, n_entries: int, acc_bytes: int) -> int:
    return int(n_slots * n_entries * acc_bytes <= SMEM_LIMIT_BYTES)


def _live(gid: torch.Tensor, n: int) -> torch.Tensor:
    return (gid >= 0) & (gid < n)


# -- K4 ---------------------------------------------------------------------

def count_hist_ref(gid: torch.Tensor, n: int) -> torch.Tensor:
    live = _live(gid, n)
    return torch.bincount(gid[live].long(), minlength=n)[:n]


def count_hist(gid: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 counts of gid values in [0, n)."""
    _check_gid(gid)
    if not _route(gid):
        return count_hist_ref(gid, n)
    out = torch.zeros((n,), dtype=torch.int64, device=gid.device)
    _launch("hdk_count_hist", gid, gid.data_ptr(), gid.shape[0], n,
            out.data_ptr(), _use_shared(1, n, 4))
    count_hist.launches += 1
    return out


# -- K2 ---------------------------------------------------------------------

def groupby_sums2_ref(gid: torch.Tensor, vals: torch.Tensor,
                      n_entries: int) -> torch.Tensor:
    live = _live(gid, n_entries)
    out = torch.zeros((n_entries, vals.shape[1]), dtype=torch.int64,
                      device=gid.device)
    return out.index_add_(0, gid[live].long(), vals[live].to(torch.int64))


def groupby_sums2(gid: torch.Tensor, vals: torch.Tensor,
                  n_entries: int) -> torch.Tensor:
    """(n_entries, S) int64 per-gid sums of (N, S) bool slots (counts of
    True)."""
    _check_gid(gid)
    _check_rows(gid, vals)
    if vals.dtype != torch.bool:
        raise ValueError(f"groupby_sums2 takes bool slots, got {vals.dtype}")
    if not _route(gid, vals):
        return groupby_sums2_ref(gid, vals, n_entries)
    vals = vals.contiguous().view(torch.uint8)
    n_slots = vals.shape[1]
    out = torch.zeros((n_slots, n_entries), dtype=torch.int64,
                      device=gid.device)
    _launch("hdk_groupby_sums2_u8", gid, gid.data_ptr(), vals.data_ptr(),
            gid.shape[0], n_slots, n_entries, out.data_ptr(),
            _use_shared(n_slots, n_entries, 4))
    groupby_sums2.launches += 1
    return out.t()


# -- K3 ---------------------------------------------------------------------

def seg_sums_exact_ref(gid: torch.Tensor, slots: torch.Tensor,
                       n_entries: int) -> torch.Tensor:
    live = _live(gid, n_entries)
    out = torch.zeros((n_entries, slots.shape[1]), dtype=torch.int64,
                      device=gid.device)
    out.index_add_(0, gid[live].long(), slots[live].to(torch.int64))
    return out.t()


def seg_sums_exact(gid: torch.Tensor, slots: torch.Tensor,
                   n_entries: int) -> torch.Tensor:
    """(L, n_entries) int64 per-gid sums of (N, L) integer slots, each
    read at its own width (int8, int16, int32 or int64)."""
    _check_gid(gid)
    _check_rows(gid, slots)
    suffix = _INT_SUFFIX.get(slots.dtype)
    if suffix is None:
        raise ValueError(f"seg_sums_exact takes int8..int64 slots, got "
                         f"{slots.dtype}")
    if not _route(gid, slots):
        return seg_sums_exact_ref(gid, slots, n_entries)
    slots = slots.contiguous()
    n_slots = slots.shape[1]
    out = torch.zeros((n_slots, n_entries), dtype=torch.int64,
                      device=gid.device)
    _launch(f"hdk_seg_sums_exact_{suffix}", gid, gid.data_ptr(),
            slots.data_ptr(), gid.shape[0], n_slots, n_entries,
            out.data_ptr(), _use_shared(n_slots, n_entries, 8))
    seg_sums_exact.launches += 1
    return out


# -- K1 ---------------------------------------------------------------------

def _check_cols(gid: torch.Tensor, cols: List[torch.Tensor]) -> None:
    if not cols:
        raise ValueError("groupby_sums takes at least one column")
    dtype = cols[0].dtype
    if dtype not in _FLOAT_SUFFIX:
        raise ValueError(f"groupby_sums takes float32/float64 columns, got "
                         f"{dtype}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != gid.shape[0]:
            raise ValueError(f"column {tuple(c.shape)} does not match "
                             f"{gid.shape[0]} rows")
        if c.dtype != dtype:
            raise ValueError(f"groupby_sums takes columns of one dtype, got "
                             f"{dtype} and {c.dtype}")


def _k1_mode(n_slots: int, n_entries: int) -> int:
    """Where K1's warps add: 2 a private (S x E) copy per warp in shared
    memory, 1 one copy per block (shared atomics), 0 global atomics."""
    if n_entries <= K1_PRIVATE_MAX_ENTRIES:
        return 2
    return int(n_slots * n_entries * 8 <= SMEM_LIMIT_BYTES)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel's 16-byte loads can read it, else a
    contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def groupby_sums_ref(gid: torch.Tensor, cols: Sequence[torch.Tensor],
                     n_entries: int) -> torch.Tensor:
    live = _live(gid, n_entries)
    vals = torch.stack([c[live].to(torch.float64) for c in cols], dim=1)
    out = torch.zeros((n_entries, len(cols)), dtype=torch.float64,
                      device=gid.device)
    return out.index_add_(0, gid[live].long(), vals)


def groupby_sums(gid: torch.Tensor, cols: Sequence[torch.Tensor],
                 n_entries: int) -> torch.Tensor:
    """(n_entries, S) float64 per-gid sums of S 1-D float32 or float64
    columns of one dtype, read where they lie (a misaligned or strided
    column is copied first).  Up to ``K1_MAX_COLS`` columns a launch.  The
    summation order varies from run to run on the card."""
    _check_gid(gid)
    cols = list(cols)
    _check_cols(gid, cols)
    if not _route(gid, *cols):
        return groupby_sums_ref(gid, cols, n_entries)
    suffix = _FLOAT_SUFFIX[cols[0].dtype]
    gid = _aligned(gid)
    cols = [_aligned(c) for c in cols]
    out = torch.zeros((len(cols), n_entries), dtype=torch.float64,
                      device=gid.device)
    for s0 in range(0, len(cols), K1_MAX_COLS):
        chunk = cols[s0:s0 + K1_MAX_COLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*[c.data_ptr() for c in chunk])
        _launch(f"hdk_groupby_sums_cols_{suffix}", gid, gid.data_ptr(), ptrs,
                gid.shape[0], len(chunk), n_entries, out[s0].data_ptr(),
                _k1_mode(len(chunk), n_entries))
        groupby_sums.launches += 1
    return out.t()


KERNELS = (count_hist, groupby_sums2, seg_sums_exact, groupby_sums)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}

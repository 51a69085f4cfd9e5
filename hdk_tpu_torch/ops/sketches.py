"""Sketch accumulators of APPROX_COUNT_DISTINCT and APPROX_QUANTILE:
HyperLogLog and t-digest (counterpart of hdk_tpu/ops/sketches.py, whose
estimator and cluster rules this follows to the bit).

  * HLL: splitmix64 of the orderable int64 value; the low ``p`` bits pick
    the register, the rank is the leading-zero count of the rest plus one;
    a register keeps its maximum rank (``scatter_reduce_``).  Registers
    are integers, so they equal the JAX package's exactly.
  * t-digest: rows sorted by (group, value), clustered by the asin scale
    function of their quantile position; a centroid is the mean of its
    cluster.  The cluster sums go through ``onehot.seg_sums``.

torch has no logical right shift and no unsigned int64 arithmetic:
``_lsr`` masks the sign fill off an arithmetic shift, and the splitmix
constants are two's-complement int64 (multiplication wraps).  The merges
of per-shard digests (``tdigest_merge_*``) serve multi-device
aggregation: centroids of one group re-sorted by mean and re-clustered by
their cumulative weight, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import onehot
from .sortops import lexsort

# splitmix64 finalization constants as int64 two's complement
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_C2 = 0x94D049BB133111EB - (1 << 64)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of int64 (torch's ``>>`` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr(h, 30)
    h = h * _C1
    h = h ^ _lsr(h, 27)
    h = h * _C2
    return h ^ _lsr(h, 31)


def _bitlen(w: torch.Tensor) -> torch.Tensor:
    """Highest-set-bit position + 1 of non-negative int64 (0 -> 0), in
    six shift steps."""
    pos = torch.zeros_like(w)
    cur = w
    for s in (32, 16, 8, 4, 2, 1):
        hi = cur >> s
        take = hi > 0
        pos = pos + torch.where(take, s, 0)
        cur = torch.where(take, hi, cur)
    return torch.where(w > 0, pos + 1, 0)


def _pow2_f64(k: torch.Tensor) -> torch.Tensor:
    """Exact 2**k for integer k in [-1022, 1023] from its IEEE bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


# -- HyperLogLog --------------------------------------------------------

def effective_hll_p(p: int, n_groups: int, budget: int) -> int:
    """Shrink the precision until n_groups * 2^p registers fit the
    budget; 4 is the floor (the smallest m with an alpha constant)."""
    p = int(p)
    while p > 4 and (1 << p) * max(int(n_groups), 1) > budget:
        p -= 1
    return p


def hll_registers(data: torch.Tensor, valid, gid: torch.Tensor, n: int,
                  p: int) -> torch.Tensor:
    """(n, 2^p) int8 registers per group; ``valid`` is a bool mask or
    None, rows with gid >= n drop out."""
    from ..exec.groupby import _orderable_int64

    m = 1 << p
    h = _mix64(_orderable_int64(data))
    reg = h & (m - 1)
    rank = (64 - p - _bitlen(_lsr(h, p))) + 1
    live = gid < n
    if valid is not None:
        live = live & valid
    cid = torch.where(live, gid.to(torch.int64) * m + reg, n * m)
    regs = torch.zeros((n * m + 1,), dtype=torch.int64, device=data.device)
    regs.scatter_reduce_(0, cid, torch.where(live, rank, 0), "amax")
    return regs[:n * m].reshape(n, m).to(torch.int8)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def _beta(z: torch.Tensor) -> torch.Tensor:
    """LogLog-Beta polynomial, used at p = 14 only."""
    zf = z.to(torch.float64)
    zl = torch.log(zf + 1)
    return (-0.370393911 * zf + 0.070471823 * zl + 0.17393686 * zl**2
            + 0.16339839 * zl**3 - 0.09237745 * zl**4 + 0.03738027 * zl**5
            - 0.005384159 * zl**6 + 0.00042419 * zl**7)


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """(n, m) registers -> (n,) int64 estimates: alpha-adjusted harmonic
    mean, linear counting while the estimate is small, LogLog-Beta at
    p = 14."""
    _n, m = registers.shape
    p = int(math.log2(m))
    denom = _pow2_f64(-registers.to(torch.int64)).sum(dim=1)
    zeros = (registers == 0).to(torch.int64).sum(dim=1)
    est = (_alpha(m) * m * m) / denom
    linear = m * torch.log(m / torch.clamp(zeros, min=1).to(torch.float64))
    small = (est <= 2.5 * m) & (zeros > 0)
    if p == 14:
        beta_est = (_alpha(m) * m * (m - zeros).to(torch.float64)
                    / (_beta(zeros) + denom))
        est = torch.where(est <= 2.5 * m, est, beta_est)
    return torch.where(small, linear, est).to(torch.int64)


# -- t-digest -----------------------------------------------------------

def effective_td_c(c: int, n_groups: int, budget: int) -> int:
    """Halve the centroid count until n_groups * c fits the budget
    (floor 8)."""
    c = int(c)
    while c > 8 and c * max(int(n_groups), 1) > budget:
        c //= 2
    return c


def _td_cluster(q: torch.Tensor, c: int) -> torch.Tensor:
    """Cluster index of a quantile position under the asin scale
    function: clusters are finest at the tails."""
    k = (torch.asin(torch.clamp(2.0 * q - 1.0, -1.0, 1.0)) / math.pi
         + 0.5) * c
    return torch.clamp(torch.floor(k), 0, c - 1).to(torch.int64)


def _cluster_reduce(vals: torch.Tensor, weights: torch.Tensor,
                    cid: torch.Tensor, n: int, c: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted cluster sums -> ((n, c) means, (n, c) weights); cid
    values outside [0, n*c) drop out."""
    w, v = onehot.seg_sums([weights, vals * weights], cid.to(torch.int32),
                           n * c)
    means = v / torch.clamp(w, min=1e-300)
    return means.reshape(n, c), w.reshape(n, c)


def tdigest_build(data: torch.Tensor, valid, gid: torch.Tensor, n: int,
                  c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group digests from raw rows: ((n, c) float64 means, (n, c)
    float64 weights); ``valid`` is a bool mask or None, rows with
    gid >= n drop out."""
    from ..exec.groupby import _orderable_int64

    fv = data.to(torch.float64)
    live = gid < n
    if valid is not None:
        live = live & valid
    g = torch.where(live, gid.to(torch.int64), n)
    perm = lexsort([g, _orderable_int64(fv)])
    sg = g[perm]
    sv = fv[perm]
    nrows = sv.shape[0]
    counts = onehot.seg_sums([torch.ones_like(live)], sg.to(torch.int32),
                             n + 1, ones_ids=(0,))[0]
    gstarts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nrows, dtype=torch.int64, device=fv.device) - gstarts[sg]
    cnt = torch.clamp(counts[sg], min=1).to(torch.float64)
    cl = _td_cluster((pos.to(torch.float64) + 0.5) / cnt, c)
    cid = torch.where(sg < n, sg * c + cl, n * c)
    ones = torch.where(sg < n, 1.0, 0.0).to(torch.float64)
    return _cluster_reduce(sv, ones, cid, n, c)


def tdigest_merge_flat(means_flat: torch.Tensor, weights_flat: torch.Tensor,
                       gid_flat: torch.Tensor, starts_el: torch.Tensor,
                       ends_el: torch.Tensor, n: int, c: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-cluster flattened centroids into (n, c) digests.  ``gid_flat``
    is each centroid's group (>= n: dead), each group's centroids
    contiguous over the spans [starts_el, ends_el); zero-weight
    centroids add nothing."""
    from ..exec.groupby import _orderable_int64

    g = gid_flat.to(torch.int64)
    perm = lexsort([g, _orderable_int64(means_flat)])
    sg, sm, sw = g[perm], means_flat[perm], weights_flat[perm]
    cumw = torch.cumsum(sw, 0)
    cpad = torch.cat([torch.zeros((1,), dtype=cumw.dtype,
                                  device=cumw.device), cumw])
    live = sg < n
    last = max(starts_el.shape[0] - 1, 0)
    sgc = torch.clamp(torch.clamp(sg, max=n), max=last)
    prefix = cpad[starts_el][sgc]
    total_w = (cpad[ends_el] - cpad[starts_el])[sgc]
    mid = cumw - prefix - sw * 0.5
    cl = _td_cluster(mid / torch.clamp(total_w, min=1e-300), c)
    cid = torch.where(live, torch.clamp(sg, max=n) * c + cl, n * c)
    return _cluster_reduce(sm, torch.where(live, sw, 0.0), cid, n, c)


def tdigest_merge_rows(means2d: torch.Tensor, weights2d: torch.Tensor,
                       gid_sorted: torch.Tensor, row_starts: torch.Tensor,
                       row_ends: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row digests of key-sorted rows merged into per-group digests:
    (R, c) rows grouped contiguously by ``gid_sorted`` (dead rows carry
    zero weights), (n,) row spans per group -> (n, c)."""
    _r, c = means2d.shape
    gid_flat = torch.repeat_interleave(gid_sorted.to(torch.int64), c)
    return tdigest_merge_flat(means2d.reshape(-1), weights2d.reshape(-1),
                              gid_flat, row_starts.to(torch.int64) * c,
                              row_ends.to(torch.int64) * c, n, c)


def tdigest_merge_gathered(means2d: torch.Tensor, weights2d: torch.Tensor,
                           c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K digests per group side by side, (n, K*c) -> (n, c): the combine
    of the dense distributed route after an all_gather."""
    n, k = means2d.shape
    dev = means2d.device
    gid_flat = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), k)
    el = torch.arange(n + 1, dtype=torch.int64, device=dev) * k
    return tdigest_merge_flat(means2d.reshape(-1), weights2d.reshape(-1),
                              gid_flat, el[:-1], el[1:], n, c)


def tdigest_quantile(means2d: torch.Tensor, weights2d: torch.Tensor,
                     q: float) -> torch.Tensor:
    """Per-group quantile from digests by centroid-midpoint
    interpolation; 0.0 for an empty digest."""
    _n, c = means2d.shape
    cols = torch.arange(c, device=means2d.device)
    ordkey = torch.where(weights2d > 0, cols[None, :], c)
    order = torch.sort(ordkey, dim=1, stable=True).indices
    m = torch.gather(means2d, 1, order)
    w = torch.gather(weights2d, 1, order)
    nv = (weights2d > 0).to(torch.int64).sum(dim=1)
    t = q * w.sum(dim=1)
    mid = torch.cumsum(w, dim=1) - w * 0.5
    below = (mid <= t[:, None]) & (cols[None, :] < nv[:, None])
    kk = below.to(torch.int64).sum(dim=1) - 1
    last = torch.clamp(nv - 1, min=0)
    k0 = torch.minimum(torch.clamp(kk, min=0), last)
    k1 = torch.minimum(torch.clamp(kk + 1, min=0), last)

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    m0, m1 = take(m, k0), take(m, k1)
    d0, d1 = take(mid, k0), take(mid, k1)
    frac = torch.clamp((t - d0) / torch.clamp(d1 - d0, min=1e-300), 0.0, 1.0)
    out = torch.where(kk < 0, m[:, 0],
                      torch.where(k1 == k0, m0, m0 + (m1 - m0) * frac))
    return torch.where(nv > 0, out, 0.0)

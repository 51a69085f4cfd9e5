"""Exact per-group quantiles by the key-carrying pair sort
(``kernels/pairsort.py``, ``csrc/pair_sort.cu``) against the permutation
of the sorted (group, value) pairs (``exec/groupby.py::_group_quantile``).

On the CPU the new route runs its plain version
(``group_sorted_keys_ref``) and must equal the permutation by ``==``,
NaN where NaN, over NULLs and the discard segment, NaN, +-inf and +-0.0,
ties, empty groups, one group, each interpolation and float32 and
integer input; the gate's choice with a small capacity handed in; the
debug timer's two counters.  The ``cuda`` cases run the kernel at the
shapes of the main path and skip without a card.  Nothing here imports
jax.
"""

import numpy as np
import pytest
import torch

from hdk_tpu_torch.exec import groupby as gb
from hdk_tpu_torch.exec.masked import MaskedCol
from hdk_tpu_torch.kernels import pairsort
from hdk_tpu_torch.utils import timer

_SPECIALS = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.25, 5e-324,
             -5e-324, 1e308, -1e308]


def _case(name, rng):
    """(values, validity or None, gid, n) of one case."""
    rows, n = 3000, 40
    gid = rng.integers(0, n, rows)
    valid = None
    vals = rng.standard_normal(rows) * 100
    if name == "nulls_and_discard":
        valid = rng.random(rows) < 0.7
        gid[rng.random(rows) < 0.1] = n  # rows of no group
    elif name == "nan_inf_zeros":
        vals = rng.choice(np.array(_SPECIALS), rows)
        vals[rng.random(rows) < 0.5] = rng.standard_normal() * 0
    elif name == "ties":
        vals = rng.integers(-3, 4, rows).astype(np.float64)
    elif name == "empty_groups":
        gid = rng.choice(np.array([0, 3, 4, 17, 39]), rows)
        valid = gid != 17  # a group of NULLs only
    elif name == "one_group":
        n, gid = 1, np.zeros(rows, np.int64)
        valid = rng.random(rows) < 0.9
    elif name == "sizes":  # runs of 0, 1, 2 and ~600 rows
        gid = np.concatenate([np.full(600, 5), np.full(2, 7), [9],
                              rng.integers(0, n, 100)])
        vals = rng.standard_normal(gid.size)
    elif name == "float32":
        vals = (rng.standard_normal(rows) * 100).astype(np.float32)
        vals[::17] = -0.0
    elif name == "int32":
        vals = rng.integers(-50, 50, rows).astype(np.int32)
    elif name == "int64":
        vals = rng.integers(-2 ** 60, 2 ** 60, rows)
    data = torch.from_numpy(np.ascontiguousarray(vals))
    mask = None if valid is None else torch.from_numpy(valid)
    return (MaskedCol(data, mask), torch.from_numpy(gid).to(torch.int32), n)


def _counts(v, gid, n):
    """The groups' non-null rows, as ``_agg_slots`` hands them over."""
    nonnull = (torch.ones(gid.shape, dtype=torch.bool) if v.mask is None
               else v.mask)
    return gb._seg_sum(nonnull, gid, n + 1, is_ones=v.mask is None)[:n]


def _same(a, b, counts):
    """``a == b`` (NaN where NaN) wherever a group has values."""
    has = counts > 0
    a, b = a[has], b[has]
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


_CASES = ["nulls_and_discard", "nan_inf_zeros", "ties", "empty_groups",
          "one_group", "sizes", "float32", "int32", "int64"]


@pytest.mark.parametrize("interp,q", [("linear", 0.5), ("linear", 0.3),
                                      ("lower", 0.5), ("higher", 0.5),
                                      ("linear", 0.0), ("linear", 1.0)])
@pytest.mark.parametrize("case", _CASES)
def test_plain_route_equals_the_permutation(case, interp, q):
    v, gid, n = _case(case, np.random.default_rng(len(case)))
    counts = _counts(v, gid, n)
    want = gb._group_quantile(v, gid, n, n + 1, q, interp)
    got = gb._group_quantile_segsort(v, gid, n, q, interp, counts,
                                     int(counts.max()))
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert _same(got, want, counts)
    assert (got[counts == 0] == 0).all()


def test_values_invert_the_orderable_keys():
    x = np.array(_SPECIALS + [np.float64(-np.nan), 3.0, -7.5])
    bits = x.view(np.int64).copy()
    bits[0] |= 0x5  # a NaN with another payload
    x = torch.from_numpy(bits.view(np.float64))
    back = pairsort.values_of(gb._orderable_int64(x))
    same = (back == x) | (torch.isnan(back) & torch.isnan(x))
    assert bool(same.all())
    # +-0.0 come back as +0.0, every NaN as one NaN
    assert not bool(torch.signbit(back[(x == 0)]).any())
    nan_bits = back[torch.isnan(x)].view(torch.int64)
    assert set(nan_bits.tolist()) == {0x7FF8000000000000}


def test_plain_version_sorts_each_group_from_its_start():
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.standard_normal(500))
    gid = torch.from_numpy(rng.integers(-2, 9, 500)).to(torch.int32)
    valid = torch.from_numpy(rng.random(500) < 0.8)
    live = (gid >= 0) & (gid < 7) & valid
    counts = torch.bincount(gid[live].long(), minlength=7)
    out, starts = pairsort.group_sorted_keys(vals, gid, valid, counts,
                                             int(counts.max()))
    assert torch.equal(starts, torch.cumsum(counts, 0) - counts)
    for g in range(7):
        run = out[starts[g]:starts[g] + counts[g]]
        want = torch.sort(gb._orderable_int64(vals[live & (gid == g)]))
        want = want.values
        assert torch.equal(run, want)
    assert pairsort.group_sorted_keys.launches == 0


@pytest.mark.parametrize("bad", ["float32", "int64_gid", "int32_counts",
                                 "too_large", "meta"])
def test_wrapper_refuses(bad):
    vals = torch.zeros(8, dtype=torch.float64)
    gid = torch.zeros(8, dtype=torch.int32)
    counts = torch.tensor([8, 0])
    largest = 8
    if bad == "float32":
        vals = vals.float()
    elif bad == "int64_gid":
        gid = gid.long()
    elif bad == "int32_counts":
        counts = counts.int()
    elif bad == "too_large":
        largest = pairsort.CAPACITY + 1
    elif bad == "meta":
        vals, gid, counts = (t.to("meta") for t in (vals, gid, counts))
    with pytest.raises(ValueError):
        pairsort.group_sorted_keys(vals, gid, None, counts, largest)


def test_the_gate_takes_a_capacity():
    counts = torch.tensor([3, 7, 0, 5])
    cuda = torch.device("cuda")
    assert gb._segsort_largest(cuda, counts, 7) == 7
    assert gb._segsort_largest(cuda, counts, 6) is None  # a group past it
    assert gb._segsort_largest(torch.device("cpu"), counts, 7) is None
    assert gb._segsort_largest(cuda, counts[:0], 7) is None  # no group
    # the kernel's capacity is the default, at least 16384 keys
    assert pairsort.CAPACITY >= 16384
    v, gid, n = _case("ties", np.random.default_rng(5))
    counts = _counts(v, gid, n)
    small = int(counts.max()) - 1
    assert gb._segsort_largest(cuda, counts, small) is None
    assert gb._segsort_largest(cuda, counts, small + 1) == small + 1


def _counted(run):
    timer.enable_debug_timer(True)
    try:
        with timer.DebugTimer("query"):
            out = run()
        totals = timer.span_totals()
    finally:
        timer.enable_debug_timer(False)
    return out, tuple(sum(t.get(c, 0) for t in totals.values())
                      for c in ("pair_segsort", "pair_lexsort"))


def test_counters_count_the_route(monkeypatch):
    v, gid, n = _case("nulls_and_discard", np.random.default_rng(9))
    counts = _counts(v, gid, n)
    lex, seen = _counted(lambda: gb._quantile_slot(v, gid, n, n + 1, 0.5,
                                                   "linear", counts))
    assert seen == (0, 1)  # the CPU: the permutation
    # the route the gate admits, here through the plain version
    monkeypatch.setattr(gb, "_segsort_largest",
                        lambda device, c, cap: int(c.max()))
    seg, seen = _counted(lambda: gb._quantile_slot(v, gid, n, n + 1, 0.5,
                                                   "linear", counts))
    assert seen == (1, 0)
    assert _same(seg, lex, counts)


def test_sql_median_counts_one_reduction():
    import hdk_tpu_torch

    hdk = hdk_tpu_torch.HDK(device="cpu")
    rng = np.random.default_rng(2)
    hdk.import_pydict({"g": rng.integers(0, 5, 200).tolist(),
                       "v": rng.standard_normal(200).tolist()}, name="t")
    q = "SELECT g, MEDIAN(v) AS m FROM t GROUP BY g"
    _, seen = _counted(lambda: hdk.sql(q).to_numpy())
    assert seen == (0, 1)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _refuse_plain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("group_sorted_keys_ref ran on the card")

    monkeypatch.setattr(pairsort, "group_sorted_keys_ref", refuse)


def _groups_of_sizes(sizes, gen, device):
    """gid (int32, shuffled) giving group g sizes[g] rows."""
    gid = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=device),
        torch.tensor(sizes, device=device))
    return gid[torch.randperm(gid.numel(), device=device, generator=gen)]


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["normal", "six_decimals", "integers",
                                    "specials", "constant"])
def test_kernel_sorts_like_the_plain_version(card, monkeypatch, values):
    """Runs of 0 to 16384 keys (the warp kernel to 512, the block kernel
    above), with NULLs and rows of no group; constant digits skipped."""
    gen = torch.Generator(device=card).manual_seed(len(values))
    sizes = [0, 1, 2, 3, 31, 32, 33, 100, 511, 512, 513, 1000, 4097, 9999,
             pairsort.CAPACITY - 1, pairsort.CAPACITY, 7, 0, 250]
    gid = _groups_of_sizes(sizes, gen, card)
    rows = gid.numel()
    gid[torch.rand(rows, device=card, generator=gen) < 0.05] = len(sizes)
    valid = torch.rand(rows, device=card, generator=gen) < 0.9
    u = torch.rand(rows, device=card, generator=gen, dtype=torch.float64)
    vals = {"normal": torch.randn(rows, device=card, generator=gen,
                                  dtype=torch.float64) * 1e3,
            "six_decimals": torch.round(u * 1e8) / 1e6,
            "integers": torch.floor(u * 20) - 10,
            "specials": torch.tensor(_SPECIALS, dtype=torch.float64,
                                     device=card)[(u * len(_SPECIALS))
                                                  .long()],
            "constant": torch.full((rows,), -3.5, dtype=torch.float64,
                                   device=card)}[values]
    live = (gid < len(sizes)) & valid
    counts = torch.bincount(gid[live].long(), minlength=len(sizes))
    total = int(counts.sum())
    want, starts = pairsort.group_sorted_keys_ref(vals, gid, valid, counts)
    _refuse_plain(monkeypatch)
    before = pairsort.group_sorted_keys.launches
    got, got_starts = pairsort.group_sorted_keys(vals, gid, valid, counts,
                                                 int(counts.max()))
    torch.cuda.synchronize()
    assert pairsort.group_sorted_keys.launches == before + 1
    assert torch.equal(got_starts, starts)
    assert torch.equal(got[:total], want[:total])


def _main_path(card, gid, n, gen):
    """The quantile of six-decimal values (db-benchmark's v3) by ``gid``
    through ``_quantile_slot``, against the permutation: (counted
    routes)."""
    rows = gid.numel()
    u = torch.rand(rows, device=card, generator=gen, dtype=torch.float64)
    v = MaskedCol(torch.round(u * 1e8) / 1e6, None)
    counts = gb._seg_sum(torch.ones((rows,), dtype=torch.bool, device=card),
                         gid, n + 1, is_ones=True)[:n]
    for interp, q in (("linear", 0.5), ("lower", 0.25), ("higher", 0.9)):
        got, seen = _counted(lambda: gb._quantile_slot(
            v, gid, n, n + 1, q, interp, counts))
        want = gb._group_quantile(v, gid, n, n + 1, q, interp)
        assert _same(got, want, counts), (interp, q)
    return seen


@pytest.mark.cuda
def test_main_path_1e4_groups_of_1e4(card, monkeypatch):
    gen = torch.Generator(device=card).manual_seed(1)
    gid = torch.randint(0, 10_000, (100_000_000,), device=card,
                        generator=gen, dtype=torch.int32)
    _refuse_plain(monkeypatch)
    assert _main_path(card, gid, 10_000, gen) == (1, 0)


@pytest.mark.cuda
def test_main_path_1e6_groups_of_100(card, monkeypatch):
    gen = torch.Generator(device=card).manual_seed(2)
    gid = torch.randint(0, 1_000_000, (100_000_000,), device=card,
                        generator=gen, dtype=torch.int32)
    _refuse_plain(monkeypatch)
    assert _main_path(card, gid, 1_000_000, gen) == (1, 0)


@pytest.mark.cuda
def test_a_group_past_the_capacity_takes_the_permutation(card):
    gen = torch.Generator(device=card).manual_seed(3)
    sizes = [pairsort.CAPACITY + 1] + [50] * 99
    gid = _groups_of_sizes(sizes, gen, card)
    assert _main_path(card, gid, len(sizes), gen) == (0, 1)


def test_smoke_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 16 at a small size on the CPU, where the
    wrapper runs its plain version and the host clock stands in for the
    CUDA events."""
    import time

    import chip_smoke as cs

    def host_ms(fn, *a, **k):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(cs, "cuda_ms_batched", host_ms)
    cases = cs.pair_sort_phase("cpu", shapes=(("few", 20_000, 30),
                                              ("many", 20_000, 2_000)),
                               device="cpu")
    assert [c["label"] for c in cases] == ["few", "many"]
    for c in cases:
        assert c["largest"] <= pairsort.CAPACITY
        assert c["bound_ms"] == cs.pair_sort_bound_ms(20_000) > 0

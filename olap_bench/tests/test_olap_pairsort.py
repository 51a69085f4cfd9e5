"""The readers of the exact quantiles' pair sort: ``pair_segsort_per_query``
(the counter of reductions that sorted each group's keys in place) and
``pair_sort_kernel_pct`` (the pair-sort kernels' share of device-busy
time), each on a program that has what it reads and on one that lacks
it, where it reads None."""

import importlib

import pytest

from hdk_tpu_torch.kernels import build
from hdk_tpu_torch.utils import timer


def _reader(name):
    return importlib.import_module(f"olap_bench.metrics.{name}")


def test_pair_segsort_reader(monkeypatch):
    timer.enable_debug_timer(True)
    with timer.DebugTimer("step:Aggregate#1"):
        timer.count("pair_segsort")
        timer.count("pair_lexsort")
    timer.enable_debug_timer(False)
    read = _reader("pair_segsort_per_query").read
    assert read({"queries": 2}) == 0.5
    assert read({"queries": 0}) is None
    # a program whose timer has no such counter
    monkeypatch.setattr(timer, "COUNTERS", ("gid_array", "gid_keys"))
    assert read({"queries": 2}) is None


def test_pair_sort_kernel_reader(monkeypatch):
    ops = {"(anonymous namespace)::pair_scatter_kernel(double const*)": 0.1,
           "(anonymous namespace)::pair_sort_warp_kernel(long long*)": 0.05,
           "(anonymous namespace)::pair_sort_block_kernel(long long*)": 0.2,
           "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>": 0.3,
           "void (anonymous namespace)::k1_kernel<double>": 0.35}
    read = _reader("pair_sort_kernel_pct").read
    assert read({"trace": {"busy_s": 1.0, "ops_s": ops}}) == \
        pytest.approx(35.0)
    assert read({"trace": None}) is None
    # a program that builds no pair sort
    monkeypatch.setattr(build, "SOURCES", {"hist.cu": 2, "int_hist.cu": 6})
    assert read({"trace": {"busy_s": 1.0, "ops_s": ops}}) is None

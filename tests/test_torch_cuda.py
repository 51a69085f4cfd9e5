"""The CUDA kernels on the card: each against its plain version, in both
the shared-memory and the global-atomic mode, and the main path on a CUDA
session against the same session on the CPU.  Skips where there is no
card.  On the card, without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import hdk_tpu_torch
from hdk_tpu_torch.kernels import hist

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _refuse_plain_versions(monkeypatch):
    """From here on, a CUDA tensor must never reach a plain version."""
    for k in hist.KERNELS:
        def refuse(*a, _n=k.__name__):
            raise AssertionError(f"{_n}_ref ran on a CUDA tensor")
        monkeypatch.setattr(hist, k.__name__ + "_ref", refuse)


# E=7: shared-memory partials; E=70000 at 8-byte slots: global atomics
@pytest.mark.parametrize("n_entries", [7, 2000, 70_000])
def test_kernels_match_plain_versions(cuda, n_entries):
    gen = torch.Generator(device=cuda).manual_seed(n_entries)
    n = 1_000_000
    gid = torch.randint(-3, n_entries + 3, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    flags = torch.rand((n, 3), device=cuda, generator=gen) < 0.5
    ints = torch.randint(-2**62, 2**62, (n, 2), device=cuda, generator=gen,
                         dtype=torch.int64)
    small = torch.randint(-128, 128, (n, 1), device=cuda, generator=gen,
                          dtype=torch.int8)
    f32 = torch.rand((n, 2), device=cuda, generator=gen) * 100
    f64 = torch.rand((n, 2), device=cuda, generator=gen,
                     dtype=torch.float64) * 1e4
    refs = {k.__name__: getattr(hist, k.__name__ + "_ref")
            for k in hist.KERNELS}
    before = hist.launches()
    assert torch.equal(hist.count_hist(gid, n_entries),
                       refs["count_hist"](gid, n_entries))
    assert torch.equal(hist.groupby_sums2(gid, flags, n_entries),
                       refs["groupby_sums2"](gid, flags, n_entries))
    for v in (ints, small):
        assert torch.equal(hist.seg_sums_exact(gid, v, n_entries),
                           refs["seg_sums_exact"](gid, v, n_entries))
    for v in (f32, f64):
        # atomic float adds run in no fixed order
        torch.testing.assert_close(hist.groupby_sums(gid, v, n_entries),
                                   refs["groupby_sums"](gid, v, n_entries),
                                   rtol=1e-10, atol=0)
    after = hist.launches()
    assert {k: after[k] - before[k] for k in after} == {
        "count_hist": 1, "groupby_sums2": 1, "seg_sums_exact": 2,
        "groupby_sums": 2}


def test_main_path_on_the_card(cuda, monkeypatch):
    rng = np.random.default_rng(3)
    n = 200_000
    x = rng.integers(-10**12, 10**12, n)
    data = {"g": rng.integers(0, 300, n),
            "q": rng.integers(1, 51, n).astype(np.int8),
            "x": np.ma.MaskedArray(x, rng.random(n) < 0.1),
            "y": rng.gamma(2.0, 10.0, n).astype(np.float32)}
    sql = ("SELECT g, COUNT(*), COUNT(x), SUM(x), SUM(q), AVG(y) FROM t "
           "WHERE q < 40 GROUP BY g ORDER BY g")
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        hdk.import_pydict(data, name="t")
        hist.reset_launches()
        out.append(hdk.sql(sql).to_numpy())
    assert all(v > 0 for v in hist.launches().values())
    cpu, gpu = out
    for name in cpu:
        if cpu[name].dtype.kind == "f":
            np.testing.assert_allclose(gpu[name], cpu[name], rtol=1e-9)
        else:
            assert np.array_equal(gpu[name], cpu[name]), name

"""A whole run on the CPU with the timed path broken underneath comes
out not correct: half of each table left out (counts, and means taken
over the rest), and one value of every answer altered where the program
produces it."""

import numpy as np
import pytest

import hdk_tpu_torch
from olap_bench import harness
from olap_bench.tests.common import CELLS, SCALE, SEED


def _half_tables(monkeypatch):
    real = hdk_tpu_torch.HDK.import_arrow

    def half(self, at, name=None, schema=None):
        return real(self, at.slice(0, at.num_rows // 2), name, schema)

    monkeypatch.setattr(hdk_tpu_torch.HDK, "import_arrow", half)


def _altered_answer(monkeypatch):
    real = hdk_tpu_torch.QueryResult.to_numpy

    def altered(self):
        out = real(self)
        col = out[list(out)[-1]]
        data = np.ma.getdata(col)
        if data.size:
            data[0] = data[0] * (1 + 1e-6) if data.dtype.kind == "f" \
                else data[0] + 1
        return out

    monkeypatch.setattr(hdk_tpu_torch.QueryResult, "to_numpy", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_tables, _altered_answer],
                         ids=["half_of_the_rows", "answer_altered"])
def test_fault_is_caught(monkeypatch, cell, fault):
    fault(monkeypatch)
    res, lines = harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                                  scale=SCALE[cell])
    assert not res["correct"], lines
    assert res["failed"] > 0

"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``.

Both scripts run on the CPU in this process (the port's with
``device="cpu"``); every result row — window answers, the tenant's
standing-query answers and bounds — and the tenant's quantile answer of
the last window must be bitwise the reference's, except the quantile
query's rank bound, held to ``TOTAL_RTOL``: it divides by the sketch's
total weight, an f32 sum over its slots that the reference's compiled
reduction adds in an order of its own.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TOTAL_RTOL = 1e-5


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(
        np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def test_quickstart_torch_matches_the_reference_quickstart(monkeypatch):
    ref = runpy.run_path(str(EXAMPLES / "quickstart.py"))
    monkeypatch.syspath_prepend(str(EXAMPLES))
    sys.modules.pop("quickstart_torch", None)
    import quickstart_torch

    pipe, state, rows = quickstart_torch.main(device="cpu")
    assert pipe.device.type == "cpu"
    jrows, jpipe = ref["rows"], ref["pipe"]
    assert len(rows) == len(jrows) == 8
    for row, jrow in zip(rows, jrows):
        assert row.keys() == jrow.keys()
        for f in ("tick", "n_sampled"):
            assert row[f] == jrow[f], f
        for f in ("sum", "sum_var", "mean", "mean_var"):
            _bits(np.float32(row[f]), np.float32(jrow[f]), f)
        for f in ("histogram", "answers"):
            _bits(row[f], jrow[f], f)
        o, w, _ = pipe.query_layout()["quantiles"]
        clt = np.r_[0:o, o + w:len(jrow["bounds"])]
        _bits(row["bounds"][clt], jrow["bounds"][clt], "bounds")
        np.testing.assert_allclose(row["bounds"][o:o + w],
                                   jrow["bounds"][o:o + w], rtol=TOTAL_RTOL)
    _bits(pipe.answer(rows[-1]["answers"], "quantiles", tenant="demo"),
          jpipe.answer(jrows[-1]["answers"], "quantiles", tenant="demo"))
    assert pipe.telemetry_snapshot(state)["bound_2sigma"] == \
        jpipe.telemetry_snapshot(ref["state"])["bound_2sigma"]

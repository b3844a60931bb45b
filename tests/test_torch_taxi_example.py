"""``examples/taxi_analytics_torch.py`` against ``examples/taxi_analytics.py``.

Both scripts run their three pipelines (ApproxIoT, SRS, native) for two
measured ticks on the CPU in this process; every line that does not
report a wall-clock rate — the stream header, the accuracy losses, the
items kept and the SUM line with its realized bound — must be the
reference's.
"""
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_taxi_example_prints_the_reference_lines(monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["taxi_analytics.py", "--ticks", "2"])
    with redirect_stdout(buf):
        runpy.run_path(str(EXAMPLES / "taxi_analytics.py"))
    want = buf.getvalue().splitlines()
    monkeypatch.syspath_prepend(str(EXAMPLES))
    sys.modules.pop("taxi_analytics_torch", None)
    import taxi_analytics_torch

    buf = io.StringIO()
    with redirect_stdout(buf):
        taxi_analytics_torch.main("cpu", 0.1, 2)
    got = buf.getvalue().splitlines()
    keep = ("taxi-like", "accuracy loss", "items kept", "SUM ≈")
    pick = lambda lines: [ln for ln in lines  # noqa: E731
                          if ln.strip().startswith(keep)]
    assert pick(got) == pick(want)
    assert len(pick(got)) == 4

"""``--mesh N`` in the port's two CLIs, on gloo ranks on the CPU.

The analytics CLI's tenant-free mesh run prints the reference's lines:
the reference runs ``--mesh 2`` in a subprocess with two host devices
(its tenant-free lowering works under ``shard_map`` on jax 0.9.0; its
tenant lowering does not, see ``tests/test_torch_spmd.py``), so with
tenants, and for the serve CLI, the lines are held to the reference's
format strings. The serve CLI's mesh run prints the local one-shot
lines (the reference's, ``tests/test_torch_serve.py``) with the plane's
name and the merged bytes.
"""
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import analytics as JA  # noqa: E402
from repro_torch.launch import analytics as TA  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARGV = ["--ticks", "4"]
SMALL = ["--smoke", "--requests", "6", "--batch", "2", "--prompt-len", "5",
         "--decode-len", "3"]


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _shape(lines) -> list[str]:
    """The lines with every number blanked."""
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", ln) for ln in lines]


def _sum_line(lines):
    (line,) = [ln for ln in lines if ln.strip().startswith("SUM ≈")]
    return line


@pytest.fixture(scope="module")
def reference_mesh2():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.analytics", "--mesh", "2",
         *ARGV], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_analytics_mesh2_prints_the_reference_lines(reference_mesh2):
    got = _stdout(TA.main, ["--mesh", "2", "--device", "cpu", *ARGV])
    want = reference_mesh2
    assert got[0] == want[0] and got[0].endswith("mesh=2dev")
    assert _sum_line(got) == _sum_line(want)
    assert got[2] == want[2]                       # accuracy loss
    assert _shape(got[3:])[0].startswith(_shape(want[3:])[0].replace(
        "jitted dispatches)", "epoch dispatches)"))
    assert got[3].endswith("on cpu (gloo, 2 ranks)")


def test_analytics_mesh1_sum_line_and_the_local_scan():
    """``--mesh 1`` prints the reference's SUM line. The mesh path is one
    flat batch a tick, the scan path the 8 → 4 → 2 → 1 tree, so their
    SUM lines agree in the port exactly where they agree in the
    reference."""
    got = _sum_line(_stdout(TA.main, ["--mesh", "1", "--device", "cpu",
                                      *ARGV]))
    want = _sum_line(_stdout(JA.main, ["--mesh", "1", *ARGV]))
    assert got == want
    scan_port = _sum_line(_stdout(TA.main, ["--engine", "scan", "--device",
                                            "cpu", *ARGV]))
    scan_ref = _sum_line(_stdout(JA.main, ["--engine", "scan", *ARGV]))
    assert scan_port == scan_ref
    assert (got == scan_port) == (want == scan_ref)


def test_analytics_mesh2_with_tenants_prints_the_query_lines():
    queries = "sum,count,mean,q:0.5:0.99,hh"
    got = _stdout(TA.main, ["--mesh", "2", "--device", "cpu", "--queries",
                            queries, *ARGV])
    assert got[0].endswith("mesh=2dev")
    cross = [ln for ln in got if ln.strip().startswith("cross-device")]
    assert len(cross) == 1 and re.match(
        r"  cross-device   \d+ B/window of sketch summaries per device "
        r"\(reservoir all-gather would ship \d+ B and grow with the "
        r"sample budget\)$", cross[0]), cross
    # the standing-query block, in the reference's format
    i = got.index("  standing queries (last window, ± bound):")
    names = ["sum", "count", "mean", "quantile", "hh"]
    assert [ln.split()[0] for ln in got[i + 1:]] == names
    for ln in got[i + 1:]:
        assert re.match(r"    \S+ +\[[^]]*\] ± \[[^]]*\]$", ln), ln
    count = [ln for ln in got if ln.strip().startswith("count")][0]
    assert re.search(r"\[\d+\] ± \[0\]", count)


def test_serve_mesh2_prints_the_reference_lines(capsys):
    mean, exact = TSV.main(SMALL + ["--mesh", "2", "--device", "cpu",
                                    "--telemetry"])
    got = capsys.readouterr().out.splitlines()
    # the local one-shot run, whose lines tests/test_torch_serve.py holds
    # to the reference's
    TSV.main(SMALL + ["--device", "cpu", "--telemetry"])
    want = capsys.readouterr().out.splitlines()
    plane = "2-device SPMD mesh (merged sketch summaries)"
    assert plane in got[1]
    want = [ln.replace("2→1 hierarchy", plane) for ln in want]
    want[-1] += ", # sketch bytes merged"
    assert _shape(got) == _shape(want)
    # every record of the one-shot epoch reaches the merged root
    assert got[1].endswith("6/6 records at the root")
    assert np.isfinite(mean) and mean == pytest.approx(exact, rel=1e-5)

"""The port's train CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU.

Both print the same lines, numbers aside, and the numbers that do not
depend on the weights (the sampled share, the stragglers a step) are
equal: the token stream, ``whsamp``'s selection and the straggler
simulation are the reference's bit for bit. The port resumes from its
own checkpoint, and from one that the reference's CLI wrote: from the
same checkpoint and the same fresh stream, its first resumed loss is the
reference's to ``RESUME_RTOL`` 1e-4 (an f32 forward, summed in other
orders than XLA's). SIGTERM ends a run with a checkpoint of the step it
was in, from which a resume goes on. ``examples/approx_train_torch.py``
runs to its last line.
"""
import ast
import contextlib
import io
import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as JTRAIN  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RESUME_RTOL = 1e-4
SMALL = ["--smoke", "--batch", "4", "--seq", "64", "--log-every", "3",
         "--ckpt-every", "5", "--simulate-stragglers", "0.2"]


def _shape(text: str) -> list[str]:
    """The printed lines with every number blanked."""
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)
            for line in text.strip().splitlines()]


def _fields(text: str, name: str) -> list[str]:
    return re.findall(rf"{name} (\S+)", text)


@pytest.fixture(scope="module", autouse=True)
def _keep_sigterm():
    """The reference's ``main`` leaves its SIGTERM handler installed."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """12 steps of each CLI, each into its own checkpoint directory."""
    root = tmp_path_factory.mktemp("train")
    out = {}
    for name, main, extra in (("port", TTRAIN.main, ["--device", "cpu"]),
                              ("ref", JTRAIN.main, [])):
        ck = root / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = main(SMALL + ["--steps", "12", "--ckpt-dir", str(ck)]
                          + extra)
        out[name] = (buf.getvalue(), losses, ck)
    return out


def test_train_prints_the_reference_lines(runs):
    got, got_losses, _ = runs["port"]
    want, want_losses, _ = runs["ref"]
    assert _shape(got) == _shape(want)
    assert got.splitlines()[0].startswith("step     0 loss")
    assert got.splitlines()[-1].startswith("done: 12 steps in")
    for field in ("sampled", "stragglers"):
        assert _fields(got, field) == _fields(want, field)
    assert any(int(s) > 0 for s in _fields(got, "stragglers"))
    assert len(got_losses) == len(want_losses) == 12
    assert np.isfinite(got_losses).all()


def test_train_resumes_from_its_own_checkpoint(runs, capsys):
    _, _, ck = runs["port"]
    assert sorted(p.name for p in ck.iterdir()) == [
        "step_000000005", "step_000000010", "step_000000011"]
    losses = TTRAIN.main(SMALL + ["--steps", "16", "--ckpt-dir", str(ck),
                                  "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[resume] from step 12"
    assert lines[1].startswith("step    12 loss")
    assert len(losses) == 4 and np.isfinite(losses).all()
    # resumed again with every step taken: nothing to train, no error
    assert TTRAIN.main(SMALL + ["--steps", "16", "--ckpt-dir", str(ck),
                                "--device", "cpu"]) == []
    assert capsys.readouterr().out.splitlines() == [
        "[resume] from step 16",
        "done: resumed at step 16 of --steps 16; nothing to train"]


def test_train_resumes_from_the_reference_checkpoint(runs, tmp_path, capsys):
    """The reference's checkpoint (its own ``PyTreeDef`` manifest, its
    stacked layers) restores into the port; from it, the port's first
    step is the reference's own resumed first step."""
    _, _, ck = runs["ref"]
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    shutil.copytree(ck, mine)
    shutil.copytree(ck, theirs)
    got_losses = TTRAIN.main(SMALL + ["--steps", "15", "--ckpt-dir",
                                      str(mine), "--device", "cpu"])
    got = capsys.readouterr().out
    want_losses = JTRAIN.main(SMALL + ["--steps", "15", "--ckpt-dir",
                                       str(theirs)])
    want = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0] == \
        "[resume] from step 12"
    assert _shape(got) == _shape(want)
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses[0], want_losses[0],
                               rtol=RESUME_RTOL)


def test_train_defaults_to_cuda_and_the_example_runs(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTRAIN.main(SMALL + ["--steps", "2", "--ckpt-dir",
                                 str(tmp_path / "c")])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "approx_train_torch.py"),
         "--steps", "6", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ex")], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 6 steps at sampling fraction 50%" in out.stdout


def test_sigterm_checkpoints_the_step_and_resume_goes_on(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ck = tmp_path / "ck"
    base = [sys.executable, "-m", "repro_torch.launch.train"] + SMALL
    cmd = base + [
        "--steps", "100000", "--log-every", "1", "--ckpt-every", "100000",
        "--ckpt-dir", str(ck), "--device", "cpu"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("step     0 loss"), first
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=120)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0
    assert "[sigterm] checkpointed, exiting" in rest
    (step,) = [int(p.name.split("_")[1]) for p in ck.iterdir()]
    assert 0 <= step < 1000
    out = subprocess.run(base + ["--steps", str(step + 3), "--ckpt-dir",
                                 str(ck), "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == f"[resume] from step {step + 1}"
    assert "done: 2 steps" in out.stdout


def test_the_example_and_the_cuda_tests_import_no_reference():
    """``tests/test_torch_pipeline.py`` checks ``src/repro_torch``; this
    checks the files of the training slice outside it."""
    for path in (REPO / "examples" / "approx_train_torch.py",
                 REPO / "tests" / "test_torch_cuda_families.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "repro"), (path, name)

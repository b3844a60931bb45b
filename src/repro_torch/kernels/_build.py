"""Build the CUDA sources under ``repro_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused. Builds go to
``build/repro_torch_kernels/`` at the repository root (``.gitignore``
lists it); ``build_all`` starts one ``nvcc`` per source at once.

Flags: no ``--use_fast_math``, and ``-fmad=false`` so that no multiply
and add are contracted into an FMA — the allocation and Eq. 9 weight
arithmetic must round exactly like the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fused_level_tick", "stratified_stats", "sketch_update",
           "sample_mask", "segment_sum", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``; raises if there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _inputs(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists. Returns
    ``(popen, tmp_path, final_path)`` or ``None``."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source in parallel (one ``nvcc`` each) and
    return each one's compiler log (``-Xptxas -v``: registers, shared
    memory, spills); ``""`` for a library that was already built."""
    jobs = {name: _start(name) for name in names}
    logs = {}
    try:
        for name, job in jobs.items():
            logs[name] = "" if job is None else _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def plain_only(what: str, *tensors) -> None:
    """Raise if a DTensor reaches a kernel wrapper: the kernels take one
    rank's plain tensors (under a model mesh the models call them per
    rank, on each rank's local tensors, through ``local_map``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes plain tensors, not DTensors: under "
                        f"a model mesh call it on each rank's local "
                        f"tensors (models.layers._per_rank)")

"""Build and load of the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``repro_torch/csrc/`` with a
plain C interface. It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library at first use, keyed on a hash of the source and the
flags, under ``repro_torch/_build/`` (git-ignored), and loaded with
``ctypes``. Not ``torch.utils.cpp_extension``: a source that includes
PyTorch's headers takes minutes to build, a plain C one seconds.

``build(*sources)`` starts one ``nvcc`` for each source that is not built
yet, all together, and waits for every one of them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One built library: its path, the seconds from the start of its
    build to its end (0.0 when it was found built) and the compiler's
    report (registers, spills; empty when found built)."""
    path: Path
    seconds: float
    log: str


_built: dict[Path, Built] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME
                  else []) + [shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (CUDA_HOME unset and no nvcc on "
                       "PATH): cannot build the port's CUDA kernels")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(*sources: Path) -> list[Built]:
    """Build every source not built yet, one ``nvcc`` each, all started
    together; raises with the compiler's output if one fails. Observers
    of host preprocessing (``core.plan.plan_span``) see one
    ``kernel_load`` span over the finding and building of the sources
    this process had not loaded yet: ``built`` tells whether ``nvcc``
    ran, ``compile_s`` how long the builds took."""
    todo = [source for source in dict.fromkeys(sources)
            if source not in _built]
    if todo:
        from ..core.plan import plan_span
        with plan_span("kernel_load", source=" ".join(
                source.name for source in todo)) as sp:
            compile_s = _find_or_build(todo)
            sp.annotate(built=compile_s > 0.0, compile_s=compile_s)
    return [_built[source] for source in sources]


def _find_or_build(sources: list[Path]) -> float:
    """Fills ``_built`` for ``sources``; returns the seconds from the
    first ``nvcc``'s start to the last one's end (0.0 when every library
    was found built)."""
    t0 = time.perf_counter()
    running = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            _built[source] = Built(so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 str(source)], stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, so, tmp, log, proc))
    failures = []
    seconds = 0.0
    for source, so, tmp, log, proc in running:
        code = proc.wait()
        seconds = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        if code != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed to build {source.name} (exit "
                            f"{code}):\n{text}")
            continue
        os.replace(tmp, so)
        _built[source] = Built(so, seconds, text)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(source: Path) -> tuple[ctypes.CDLL, Built]:
    """The loaded library of ``source`` (built first if need be)."""
    built, = build(source)
    return ctypes.CDLL(str(built.path)), built

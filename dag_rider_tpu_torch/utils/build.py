"""Build-on-first-use for the port's CUDA sources.

Every ``csrc/*.cu`` of the package compiles with ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All
sources compile at once (one ``nvcc`` process each, started together).
A library's file name carries a hash of its source, the package's
headers and the flags, so an edit rebuilds and an unchanged tree reuses
the last build. The output goes to ``build/`` beside the package (listed
in ``.gitignore``), with the ``-Xptxas -v`` report (registers, spills)
kept next to each library.

Nothing here runs at import time: the CPU tests import the package on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: one build or load at a time: the nodes of one process reach their
#: first launch from their own threads
_LOCK = threading.RLock()

#: seconds the last :func:`build_all` spent in nvcc (0.0 when every
#: library was already built)
last_build_s = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path, header_bytes: bytes) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(header_bytes)
    h.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _ptxas_summary(log: str) -> List[str]:
    """The kernel-name, register and spill lines of a ``-Xptxas -v`` log."""
    keep = ("Compiling entry function", "registers", "spill")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns stem -> path.

    Raises RuntimeError with nvcc's output when a build fails."""
    with _LOCK:
        return _build_all()


def _build_all() -> Dict[str, Path]:
    global last_build_s
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    targets = {src.stem: (src, _target(src, headers)) for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for stem, (src, so) in todo.items():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp,
                so,
            )
        failed = []
        for stem, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
                continue
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
            print(f"[build] {so.name}", *_ptxas_summary(log), sep="\n  ", file=sys.stderr)
        last_build_s = time.perf_counter() - t0
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    else:
        last_build_s = 0.0
    return {stem: so for stem, (_, so) in targets.items()}


def ptxas_report(stem: str) -> List[str]:
    """Register and spill lines from the build of ``csrc/<stem>.cu``."""
    so = build_all()[stem]
    return _ptxas_summary(so.with_suffix(".log").read_text())


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
        return lib

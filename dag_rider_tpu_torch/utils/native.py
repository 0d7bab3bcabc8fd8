"""ctypes seam to the native host library (``csrc/challenge.cpp``).

The port's copy of ``dag_rider_tpu/utils/native.py``: batched Ed25519
challenge-scalar computation for the verify host path, one C call for a
whole row block. The library compiles on demand with ``g++ -O2 -shared
-fPIC`` into the repository's ``build/`` directory (listed in
``.gitignore``, shared with :mod:`dag_rider_tpu_torch.utils.build`); its
file name carries a hash of the source and the flags, so an edit rebuilds
and an unchanged tree reuses the last build. Nothing is ever written into
the JAX package's directory. When the toolchain or the compiled object is
unavailable :func:`load` returns None, and :func:`challenges` takes the
hashlib route, which stays the differential-testing oracle
(tests/test_torch_native.py asserts byte-identical outputs).

:data:`ROWS_HASHED` counts the rows each route hashed since the last
:func:`reset_rows`, so a run can show which route its rows took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.utils.build import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "challenge.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

#: seconds the last :func:`load` spent in g++ (0.0 when the library was
#: already built)
last_build_s = 0.0

#: rows hashed per route ("native", "hashlib") since :func:`reset_rows`
ROWS_HASHED: Dict[str, int] = {"native": 0, "hashlib": 0}
_rows_lock = threading.Lock()  # row blocks count from worker threads


def library_file(stem: str, src: Path, flags: Sequence[str]) -> Path:
    """``build/<stem>-<hash>.so``, the hash over the flags and the source."""
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def compile_library(cmd: Sequence[str], src: Path, so: Path) -> Tuple[bool, float]:
    """Run ``cmd -o <tmp> src``, then rename the output into ``so``
    atomically — two processes racing a cold cache must never load a
    half-written object. Returns (built, seconds)."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [*cmd, "-o", str(tmp), str(src)],
            capture_output=True,
            timeout=120,
        )
        if proc.returncode != 0 or not tmp.exists():
            return False, time.perf_counter() - t0
        os.replace(tmp, so)
        return True, time.perf_counter() - t0
    except (OSError, subprocess.TimeoutExpired):
        return False, time.perf_counter() - t0
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return library_file("libdagrider_native", SRC, GXX_FLAGS)


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable.
    Never raises — the caller takes the hashlib route instead."""
    global _lib, _tried, last_build_s
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        last_build_s = 0.0
        try:
            so = library_path()
            if not so.exists():
                built, last_build_s = compile_library(["g++", *GXX_FLAGS], SRC, so)
                if not built:
                    return None
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.dagrider_challenge_batch.argtypes = [
            u8p, u8p, u8p, u64p, ctypes.c_uint64, u8p,
        ]
        lib.dagrider_challenge_batch.restype = None
        _lib = lib
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def challenge_batch(
    rs: np.ndarray, pks: np.ndarray, msgs: Sequence[bytes]
) -> Optional[np.ndarray]:
    """k_i = SHA-512(R_i || A_i || M_i) mod L for the whole batch.

    rs/pks: uint8[n, 32]; msgs: n byte strings. Returns uint8[n, 32]
    little-endian scalars, or None when the native library is absent.

    Thread-safe and re-entrant: every buffer the C call reads or writes
    is allocated per call, the library keeps no global state, and ctypes
    releases the GIL for the duration of the foreign call — the parallel
    host-prep engine (verifier/prep.py) calls it concurrently from
    row-block worker threads.
    """
    lib = load()
    if lib is None:
        return None
    n = len(msgs)
    if rs.shape != (n, 32) or pks.shape != (n, 32):
        raise ValueError("rs/pks must be uint8[n, 32]")
    rs = np.ascontiguousarray(rs, dtype=np.uint8)
    pks = np.ascontiguousarray(pks, dtype=np.uint8)
    blob = b"".join(msgs)
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(m) for m in msgs], out=offs[1:])
    data = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
    out = np.zeros((n, 32), dtype=np.uint8)
    lib.dagrider_challenge_batch(
        _u8(rs),
        _u8(pks),
        _u8(data),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_uint64(n),
        _u8(out),
    )
    return out


def challenges(
    rs: np.ndarray, pks: np.ndarray, msgs: Sequence[bytes], use_native: bool
) -> np.ndarray:
    """The challenge scalars of :func:`challenge_batch` by the native
    route when ``use_native`` and the library loads, else by hashlib one
    row at a time; both give the same bytes. Counts the rows in
    :data:`ROWS_HASHED` under the route they took."""
    out = challenge_batch(rs, pks, msgs) if use_native else None
    route = "native"
    if out is None:
        route = "hashlib"
        out = np.zeros((len(msgs), 32), dtype=np.uint8)
        for j, m in enumerate(msgs):
            digest = hashlib.sha512(rs[j].tobytes() + pks[j].tobytes() + m).digest()
            k = int.from_bytes(digest, "little") % ed25519.L
            out[j] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
    with _rows_lock:
        ROWS_HASHED[route] += len(msgs)
    return out


def reset_rows() -> None:
    with _rows_lock:
        for route in ROWS_HASHED:
            ROWS_HASHED[route] = 0

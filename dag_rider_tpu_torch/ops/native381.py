"""Native batched GF(p) kernels for BLS12-381 — the ``native`` lane of
``crypto.bls12381.sign_many``.

The port's copy of ``dag_rider_tpu/ops/native381.py``, built as the port's
native challenge library is (``utils/native.py``): the C source
``csrc/native381.c`` compiles with ``gcc -O2 -shared -fPIC`` into the
repository's ``build/`` directory, keyed by a hash of the source and the
flags, and binds with ``ctypes`` (no cffi, no temp directory). It holds
batched Montgomery field ops and a batched Jacobian double-and-add ladder;
the Python layer marshals 48-byte little-endian limb arrays.

Bit-identity with the host oracle is structural: the C ladder transcribes
the exact ``_jac_double`` / ``_jac_madd`` formulas of
``crypto/bls12381.py``, both exceptional branches included, over exact
mod-p arithmetic.

When the compiler or the library is missing, :func:`available` is False
and the functions compute on the host (exact either way);
:data:`HOST_ROWS` counts those rows.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dag_rider_tpu_torch.utils import native

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

#: Montgomery radix 2^384: to_mont(x) = mont_mul(x, R2), from_mont = *1
_R_MONT = (1 << 384) % P
_R2 = pow(1 << 384, 2, P)

SRC = Path(__file__).resolve().parents[1] / "csrc" / "native381.c"
CC_FLAGS = ["-x", "c", "-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

#: seconds the last :func:`load` spent compiling (0.0 when the library was
#: already built)
last_build_s = 0.0

#: rows computed on the host because the library is unavailable, per
#: primitive, since :func:`reset_host_rows`
HOST_ROWS: Dict[str, int] = {"pow": 0, "ladder": 0}


def reset_host_rows() -> None:
    for k in HOST_ROWS:
        HOST_ROWS[k] = 0


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return native.library_file("libdagrider_native381", SRC, CC_FLAGS)


def load() -> Optional[ctypes.CDLL]:
    """The library, building it on first use; None if unavailable."""
    global _lib, _tried, last_build_s
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        last_build_s = 0.0
        so = library_path()
        if not so.exists():
            cc = shutil.which("gcc") or shutil.which("g++")
            if cc is None:
                return None
            ok, last_build_s = native.compile_library([cc, *CC_FLAGS], SRC, so)
            if not ok:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mont_mul_batch.argtypes = [u64p, u64p, u64p, ctypes.c_size_t]
        lib.mont_mul_batch.restype = None
        lib.mont_pow_batch.argtypes = [u64p, u64p, u64p, ctypes.c_int, ctypes.c_size_t]
        lib.mont_pow_batch.restype = None
        lib.g1_ladder_batch.argtypes = [
            u64p, u64p, u64p, u64p, u64p, u64p,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_size_t,
        ]
        lib.g1_ladder_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# --- limb marshalling (48-byte little-endian <-> uint64[6]) ----------------


def _to_u64(vals: Sequence[int]) -> np.ndarray:
    out = np.empty((len(vals), 6), dtype=np.uint64)
    for i, v in enumerate(vals):
        out[i] = np.frombuffer(int(v).to_bytes(48, "little"), dtype=np.uint64)
    return out


def _from_u64(arr: np.ndarray) -> List[int]:
    return [int.from_bytes(arr[i].tobytes(), "little") for i in range(arr.shape[0])]


def _p(arr: np.ndarray):
    if arr.dtype != np.uint64 or not arr.flags.c_contiguous:
        raise ValueError("native381 buffers must be C-contiguous uint64")
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _mul(lib, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    lib.mont_mul_batch(_p(out), _p(a), _p(b), a.shape[0])
    return out


def _to_mont(lib, arr: np.ndarray) -> np.ndarray:
    r2 = np.ascontiguousarray(np.broadcast_to(_to_u64([_R2])[0], arr.shape))
    return _mul(lib, arr, r2)


def _from_mont(lib, arr: np.ndarray) -> np.ndarray:
    one = np.ascontiguousarray(np.broadcast_to(_to_u64([1])[0], arr.shape))
    return _mul(lib, arr, one)


def _exp_words(exp: int) -> Tuple[np.ndarray, int]:
    nbits = exp.bit_length()
    nwords = (nbits + 63) // 64
    words = np.frombuffer(exp.to_bytes(nwords * 8, "little"), dtype=np.uint64).copy()
    return words, nbits


# --- the two batch primitives sign_many builds on --------------------------


def pow_p_batch(values: Sequence[int], exp: int) -> List[int]:
    """[v^exp mod p for v in values] — the batched square-root / inversion
    power map; CPython ``pow`` when the library is unavailable."""
    if not values:
        return []
    lib = load()
    if lib is None:
        HOST_ROWS["pow"] += len(values)
        return [pow(v % P, exp, P) for v in values]
    base = _to_mont(lib, _to_u64([v % P for v in values]))
    out = np.empty_like(base)
    words, nbits = _exp_words(exp)
    lib.mont_pow_batch(_p(out), _p(base), _p(words), nbits, base.shape[0])
    return _from_u64(_from_mont(lib, out))


def g1_ladder_batch(
    scalars: Sequence[int], points: Sequence[Tuple[int, int]]
) -> Tuple[List[Optional[Tuple[int, int]]], List[bool]]:
    """Batched [k_i]P_i over E(Fp), exact oracle semantics.

    Returns (results, fallback_mask). A result of None means the scalar
    multiple landed on the identity. The fallback mask is all False — the
    C ladder covers every exceptional branch — and all True only when the
    library is unavailable.
    """
    n = len(scalars)
    if n == 0:
        return [], []
    lib = load()
    if lib is None:
        HOST_ROWS["ladder"] += n
        return [None] * n, [True] * n
    nbits = max(int(s).bit_length() for s in scalars)
    if nbits == 0:
        return [None] * n, [False] * n
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(
        b"".join(int(s).to_bytes(nbytes, "big") for s in scalars), dtype=np.uint8
    ).reshape(n, nbytes)
    bits = np.ascontiguousarray(np.unpackbits(raw, axis=1)[:, nbytes * 8 - nbits :])
    px = _to_mont(lib, _to_u64([p[0] for p in points]))
    py = _to_mont(lib, _to_u64([p[1] for p in points]))
    X = np.zeros((n, 6), dtype=np.uint64)
    Y = np.zeros((n, 6), dtype=np.uint64)
    Z = np.zeros((n, 6), dtype=np.uint64)
    rone = _to_u64([_R_MONT])[0].copy()
    lib.g1_ladder_batch(
        _p(X), _p(Y), _p(Z), _p(px), _p(py), _p(rone),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), nbits, n,
    )
    inf = ~Z.any(axis=1)
    # one batched inversion pass: z^-1 = z^(p-2), then affine conversion
    zi = np.empty_like(Z)
    words, pbits = _exp_words(P - 2)
    lib.mont_pow_batch(_p(zi), _p(Z), _p(words), pbits, n)
    zi2 = _mul(lib, zi, zi)
    xa = _from_u64(_from_mont(lib, _mul(lib, X, zi2)))
    ya = _from_u64(_from_mont(lib, _mul(lib, _mul(lib, Y, zi2), zi)))
    results: List[Optional[Tuple[int, int]]] = [
        None if inf[i] else (xa[i], ya[i]) for i in range(n)
    ]
    return results, [False] * n

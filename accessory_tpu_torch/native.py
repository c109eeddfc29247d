"""ctypes bindings for the port's native host library (``csrc/packing.cc``).

Port of ``accessory_tpu/native.py`` (pack_stream, pad_batch, pack_u4,
unpack_u4, available). The port builds its own copy of the source with g++
at first use into ``accessory_tpu_torch/build/`` (named by the source's hash,
beside the CUDA libraries ``kernels`` builds), so nothing is written next to
the source. Every entry has a numpy version, the plain version, which runs
where no library can be built; ``available()`` says which one runs (a caller
that must have the C path, such as chip_smoke.py, asserts it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "packing.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None       # why the last build failed, if it did


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"packing-{h.hexdigest()[:16]}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = lib_path()
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                               capture_output=True, text=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            i32, u32, long_ = (ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
                               ctypes.c_long)
            lib.pack_stream.argtypes = [i32, long_, long_, i32]
            lib.pack_stream.restype = long_
            lib.pad_batch.argtypes = [i32, ctypes.POINTER(long_), long_, long_, ctypes.c_int32,
                                      i32]
            lib.pack_u4.argtypes = [i32, long_, long_, u32]
            lib.unpack_u4.argtypes = [u32, long_, long_, i32]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            build_error = getattr(e, "stderr", None) or str(e)
            _lib = None
        return _lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def pack_stream(tokens: np.ndarray, max_words: int) -> np.ndarray:
    """Slice a 1-D int32 token stream into (n_seqs, max_words)."""
    tokens = np.ascontiguousarray(tokens, np.int32)
    n_seqs = len(tokens) // max_words
    lib = _load()
    if lib is None:
        return tokens[: n_seqs * max_words].reshape(n_seqs, max_words).copy()
    out = np.empty((n_seqs, max_words), np.int32)
    lib.pack_stream(_ptr(tokens, ctypes.c_int32), len(tokens), max_words,
                    _ptr(out, ctypes.c_int32))
    return out


def pad_batch(items: List[np.ndarray], max_words: int, pad_id: int = 0) -> np.ndarray:
    """Assemble variable-length int32 sequences into a padded batch."""
    lib = _load()
    if lib is None:
        out = np.full((len(items), max_words), pad_id, np.int32)
        for i, it in enumerate(items):
            n = min(len(it), max_words)
            out[i, :n] = it[:n]
        return out
    flat = np.concatenate([np.ascontiguousarray(i, np.int32) for i in items]) \
        if items else np.empty((0,), np.int32)
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(i) for i in items], out=offsets[1:])
    out = np.empty((len(items), max_words), np.int32)
    lib.pad_batch(_ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_long),
                  len(items), max_words, pad_id, _ptr(out, ctypes.c_int32))
    return out


def pack_u4(q: np.ndarray) -> np.ndarray:
    """(k, n) int32 in [0,16) -> (k//8, n) uint32 nibble-packed along k."""
    q = np.ascontiguousarray(q, np.int32)
    k, n = q.shape
    if k % 8:
        raise ValueError(f"pack_u4: k {k} is not a multiple of 8")
    lib = _load()
    if lib is None:
        qq = q.astype(np.uint32).reshape(k // 8, 8, n)
        shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :, None]
        return np.bitwise_or.reduce(qq << shifts, axis=1).astype(np.uint32)
    out = np.empty((k // 8, n), np.uint32)
    lib.pack_u4(_ptr(q, ctypes.c_int32), k, n, _ptr(out, ctypes.c_uint32))
    return out


def unpack_u4(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of ``pack_u4``: the first ``k`` rows (k, n) int32."""
    packed = np.ascontiguousarray(packed, np.uint32)
    n = packed.shape[1]
    lib = _load()
    if lib is None:
        shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :, None]
        vals = (packed[:, None, :] >> shifts) & np.uint32(0xF)
        return vals.reshape(-1, n)[:k].astype(np.int32)
    out = np.empty((packed.shape[0] * 8, n), np.int32)
    lib.unpack_u4(_ptr(packed, ctypes.c_uint32), packed.shape[0] * 8, n,
                  _ptr(out, ctypes.c_int32))
    return out[:k]


def available() -> bool:
    """Whether the C library is built and loaded (else the numpy versions run)."""
    return _load() is not None

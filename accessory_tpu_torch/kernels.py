"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C functions (pointers, ints, a stream;
each returns its ``cudaError_t``). It is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/<name>-<hash>.so`` and loaded with ``ctypes``. The hash covers
the source, the shared headers and the flags, so an edited source rebuilds.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Every wrapper that launches a kernel calls ``check(name, rc)``, which counts
the launch when it returned 0, and nowhere else, so a run can show which
kernels its main path went through (``launch_counts`` /
``reset_launch_counts``). Counts are kept per C entry point (``KERNELS``), not
per source file: the GQA and MHA decode kernels, their bf16 and int8, fused
and read-only forms, each of the cache writes, the paged decode and
paged write entries (the read-only paged decode too), the two passes of the
flash-attention backward, the context-parallel (sequence-sharded) forward and
its two backward passes, the W8, std-W4 and magic-W4 matmuls and the fused W4
FFN show their own count.

A CUDA graph runs its kernels without calling a wrapper, so its launches are
counted by replay: ``counting_capture`` takes the launches a capture's
wrappers counted back out of the counts (a capture runs nothing) and hands
them to the captured step, and ``count_replay`` adds them at each replay.
``launch_counts`` then reads the same for a run of replays as for the same
steps run eagerly. Every library must be built and loaded before the first
capture (one eager step does it): nvcc cannot run inside a capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("w4_matmul", "w4_matmul_bigm", "decode_attention", "decode_attention_mha",
           "flash_attention", "kv_write", "paged_decode", "paged_write", "w4_dequant",
           "flash_attention_bwd", "w8_matmul", "w4_matmul_std", "w4_matmul_magic", "ffn_fused")
# launch-count name of each C entry point -> the source that holds it
KERNELS = {
    "w4_matmul": "w4_matmul",
    "w4_matmul_bigm": "w4_matmul_bigm",
    "decode_attention": "decode_attention",
    "decode_attention8": "decode_attention",
    "decode_attention_ro": "decode_attention",
    "decode_attention8_ro": "decode_attention",
    "decode_attention_mha": "decode_attention_mha",
    "decode_attention_mha8": "decode_attention_mha",
    "decode_attention_mha_ro": "decode_attention_mha",
    "decode_attention_mha8_ro": "decode_attention_mha",
    "flash_attention": "flash_attention",
    "kv_write": "kv_write",
    "kv_write_q8": "kv_write",
    "kv_write_col": "kv_write",
    "kv_write_col_q8": "kv_write",
    "kv_write_stacked": "kv_write",
    "kv_write_stacked_col": "kv_write",
    "kv_write_stacked_q8": "kv_write",
    "paged_decode": "paged_decode",
    "paged_decode8": "paged_decode",
    "paged_decode_ro": "paged_decode",
    "paged_write": "paged_write",
    "paged_write_q8": "paged_write",
    "w4_dequant": "w4_dequant",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkdv": "flash_attention_bwd",
    "w8_matmul": "w8_matmul",
    "w4_matmul_std": "w4_matmul_std",
    "w4_matmul_magic": "w4_matmul_magic",
    "ffn_fused": "ffn_fused",
    "flash_attention_cp": "flash_attention",
    "flash_attention_cp_bwd_dq": "flash_attention_bwd",
    "flash_attention_cp_bwd_dkdv": "flash_attention_bwd",
}
# -Xptxas=-v: registers, shared memory and spills land in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


@contextlib.contextmanager
def counting_capture() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: yields a dict that, at the block's end,
    holds the launches the wrappers counted inside it (by entry point), which
    are taken back out of the counts."""
    before = dict(_launches)
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name, n in before.items():
            if _launches[name] != n:
                recorded[name] = _launches[name] - n
                _launches[name] = n


def count_replay(recorded: Dict[str, int]) -> None:
    """Count one replay of a captured graph whose capture recorded
    ``recorded`` (``counting_capture``'s dict)."""
    for name, n in recorded.items():
        _launches[name] += n


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    proc.tmp = tmp  # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    out = lib_path(name)
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{log}")
    os.replace(proc.tmp, out)  # type: ignore[attr-defined]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing kernel library, one nvcc per source in parallel."""
    names = list(names)
    with _lock:
        procs = {n: _start_build(n) for n in names}
        try:
            for n, p in procs.items():
                if p is not None:
                    _finish_build(n, p)
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    return {n: lib_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) for a built source."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of csrc/<name>.cu with its argument types."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise if the launch of entry point ``name`` (a key of ``KERNELS``)
    returned a CUDA error; count it otherwise."""
    if rc != 0:
        msg = load(KERNELS[name]).kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
    _launches[name] += 1


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on t's device (kernels launch there)."""
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

"""Native (C++) components, loaded with ctypes over a C ABI.

The port's counterpart of ``ldpc_sims_tpu.native``: the PEG builder
``peg.cc`` (its own copy) is compiled with ``g++ -O3 -shared -fPIC`` into
``build/native/`` of the checkout on first use, under a name keyed by the
source's content. Concurrent first uses (test workers) each build to a
temporary name and move it into place atomically. Without a compiler the
builder raises; nothing falls back to the Python PEG, which gives another
graph for the same seed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "peg_construct_native"]

SOURCE = Path(__file__).resolve().parent / "peg.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def build() -> Path:
    """Compile ``peg.cc`` once per source content; returns the library."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libpeg_{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            res = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                 str(SOURCE)], capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(
                "native PEG library unavailable: g++ not found") from None
        if res.returncode != 0:
            raise RuntimeError(
                f"native PEG library unavailable: g++ failed with code "
                f"{res.returncode}:\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    return lib


def native_available() -> bool:
    """Whether the PEG library is built, or builds now, under
    ``build/native/``: false when g++ is absent or fails; never raises."""
    try:
        build()
    except (RuntimeError, OSError):
        return False
    return True


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.peg_construct.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.peg_construct.restype = ctypes.c_int32
    return lib


def peg_construct_native(n: int, m: int, col_deg: int,
                         seed: int = 0) -> np.ndarray:
    """(m, n) uint8 parity-check matrix from the C++ PEG builder."""
    out = np.zeros(n * col_deg, dtype=np.int32)
    rc = _library().peg_construct(
        n, m, col_deg, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"peg_construct failed with code {rc}")
    H = np.zeros((m, n), dtype=np.uint8)
    H[out.reshape(n, col_deg), np.arange(n)[:, None]] = 1
    return H

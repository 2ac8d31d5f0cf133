"""CUDA QC-LDPC min-sum decode kernels and their ctypes wrapper.

The port of the Pallas kernel ``bp_qc_pallas``
(``ldpc_sims_tpu/kernels/minsum_qc.py:603-810``) in its two fixed-iteration
min-sum forms: ``minsum_qc_flooding`` and ``minsum_qc_layered``, both in
``csrc/minsum_qc.cu`` (its header says how they work and what bounds them
on the H100). The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` of the checkout on first use and loaded with ctypes.

:func:`bp_qc_cuda` launches the kernel for a CUDA tensor and runs the
plain version (:func:`..ops.bp_roll.decode_roll`) for a CPU tensor;
nothing else selects the plain version. ``LAUNCHES`` counts the kernel
launches per kernel name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ldpc_sims_tpu_torch.codes.library import QcStructure
from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan

__all__ = [
    "LAUNCHES",
    "KERNELS",
    "SOURCE",
    "bp_qc_cuda",
    "build",
    "minsum_qc_cuda",
    "reset_launch_counts",
    "smem_bytes",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "minsum_qc.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add: keeps the arithmetic equal to the plain version
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# kernel name per schedule
KERNELS = {"flooding": "minsum_qc_flooding", "layered": "minsum_qc_layered"}
# launches per kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in KERNELS.values()}
# dynamic shared memory one H100 CTA may use
_SMEM_LIMIT = 232_448


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the decode kernels")
    return path


def build() -> tuple[Path, str]:
    """Compile the kernels once per source content.

    Returns the shared library's path and ptxas's register and
    shared-memory report from the build that made it.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libminsum_qc_{tag}.so"
    report = BUILD_DIR / f"libminsum_qc_{tag}.ptxas.txt"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {res.returncode}:\n{res.stderr}"
            )
        report.write_text(res.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    return lib, report.read_text() if report.exists() else ""


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.minsum_qc_decode.argtypes = [
        i32, vp, vp, i32, vp, vp, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, vp,
    ]
    lib.minsum_qc_decode.restype = i32
    lib.minsum_qc_error_string.argtypes = [i32]
    lib.minsum_qc_error_string.restype = ctypes.c_char_p
    return lib


def _plan_array(qc: QcStructure) -> np.ndarray:
    """The kernels' int32 plan table (layout in csrc/minsum_qc.cu)."""
    planes, group_c, group_v = qc_plan(qc)
    row_ptr = np.cumsum([0] + [len(ps) for ps in group_c])
    col_ptr = np.cumsum([0] + [len(ps) for ps in group_v])
    return np.concatenate([
        row_ptr,
        [j for _, j, _ in planes],
        [s % qc.z for _, _, s in planes],
        col_ptr,
        [p for ps in group_v for p in ps],
    ]).astype(np.int32)


def smem_bytes(qc: QcStructure) -> int:
    """Dynamic shared memory of one CTA: plan, c2v planes, posterior."""
    P = len(qc_plan(qc)[0])
    plan = (qc.mb + 1 + 3 * P + qc.nb + 1 + 3) // 4 * 4
    return 4 * (plan + P * qc.z + qc.nb * qc.z)


def _ab_table(alpha, beta, iterations: int) -> np.ndarray:
    """(iterations, 2) float32 rows of (α, β); scalars repeat."""
    cols = []
    for v, name in ((alpha, "alpha"), (beta, "beta")):
        if isinstance(v, (tuple, list)):
            if len(v) != iterations:
                raise ValueError(
                    f"per-iteration {name} must have length {iterations}, "
                    f"got {len(v)}"
                )
            cols.append(np.asarray(v, np.float32))
        else:
            cols.append(np.full(iterations, v, np.float32))
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=64)
def _device_tables(qc: QcStructure, alpha, beta, iterations: int,
                   device: str) -> tuple[torch.Tensor, torch.Tensor]:
    plan = torch.from_numpy(_plan_array(qc)).to(device)
    ab = torch.from_numpy(_ab_table(alpha, beta, iterations)).to(device)
    return plan, ab


def bp_qc_cuda(
    llr: torch.Tensor,
    qc: QcStructure,
    iterations: int = 20,
    alpha=1.0,
    beta=0.0,
    clamp: float | None = None,
    schedule: str = "flooding",
    output: str = "hard",
) -> torch.Tensor:
    """(batch, n) f32 channel LLRs (log Pr1/Pr0) → hard bits or posterior.

    Min-sum, ``iterations`` fixed; ``alpha``/``beta`` scalars or
    length-``iterations`` tuples (a frozen per-iteration schedule);
    ``clamp`` bounds each c2v message; ``schedule`` 'flooding' or
    'layered' (serial-C); ``output`` 'hard' (int8 bits) or 'posterior'
    (f32, log(Pr1/Pr0)). Any batch size ≥ 1 works.
    """
    if schedule not in KERNELS:
        raise ValueError(f"unknown schedule {schedule!r}")
    if output not in ("hard", "posterior"):
        raise ValueError(f"kernel output must be 'hard' or 'posterior', "
                         f"got {output!r}")
    if isinstance(alpha, list):
        alpha = tuple(alpha)
    if isinstance(beta, list):
        beta = tuple(beta)
    _ab_table(alpha, beta, iterations)  # validates tuple lengths
    if llr.device.type == "cpu":
        return decode_roll(llr, qc, iterations=iterations, alpha=alpha,
                           beta=beta, clamp=clamp, output=output,
                           schedule=schedule)
    if llr.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {llr.device}")
    if llr.dtype != torch.float32:
        raise ValueError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != qc.nb * qc.z:
        raise ValueError("llr width does not match the QC code")
    if llr.shape[0] < 1:
        raise ValueError("empty batch")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    smem = smem_bytes(qc)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"code needs {smem} B of shared memory per codeword, more than "
            f"the {_SMEM_LIMIT} B a CTA can have"
        )
    plan, ab = _device_tables(qc, alpha, beta, iterations, str(llr.device))
    B, n = llr.shape
    hard = output == "hard"
    out = torch.empty((B, n), dtype=torch.int8 if hard else torch.float32,
                      device=llr.device)
    lib = _library()
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    P = len(qc_plan(qc)[0])
    err = lib.minsum_qc_decode(
        int(schedule == "layered"), llr.data_ptr(), out.data_ptr(),
        int(hard), plan.data_ptr(), ab.data_ptr(), B, qc.z, qc.mb, qc.nb,
        P, iterations, math.inf if clamp is None else float(clamp), stream,
    )
    if err != 0:
        msg = lib.minsum_qc_error_string(err).decode()
        raise RuntimeError(f"{KERNELS[schedule]} launch failed: {msg}")
    LAUNCHES[KERNELS[schedule]] += 1
    return out


def minsum_qc_cuda(llr, qc, **kw):
    """Alias of :func:`bp_qc_cuda` (the JAX package's ``minsum_qc_pallas``)."""
    return bp_qc_cuda(llr, qc, **kw)

"""CUDA QC-LDPC decode kernels, their ctypes wrapper and the two early-stop
drivers.

The port of the Pallas kernel ``bp_qc_pallas``
(``ldpc_sims_tpu/kernels/minsum_qc.py:603-810``) in its min-sum and
sum-product forms, each with and without message quantization:
``{minsum,sumproduct}_qc_flooding`` and ``_layered`` (fixed iterations,
with the optional ``done_in`` skip and ``hard_unsat`` count; the layered
forms also group-serial, ``layered_group > 1``), their ``_es`` forms
(per-codeword early stop) and ``_w`` forms (per-edge neural-BP weights),
and the ``_msgq`` form of each, each with f32, bf16 (``_bf16``) and int8
(``_i8``) message storage, all in ``csrc/minsum_qc.cu`` (its header says
how they work and what bounds them on the H100). The min-sum forms,
serial-C and flooding, keep a compressed check state (two stored
magnitudes and a word of signs and index a check, :func:`compressed_state`):
serial-C reads each edge's posterior once, flooding rebuilds each
posterior from its checks' states. The sum-product forms, serial-C and
flooding, keep a check's slots in registers (:func:`sumproduct_registers`):
full messages, each edge's message and posterior read once, the plan in
the kernel parameter. The group-serial forms (``layered_group > 1``) of
both rules take the ``_gs`` kernels: the per-group plan of
:func:`group_plan` in the kernel parameter, a private plane's change
folded at once and only the shared planes through the scratch, min-sum on
the compressed state and sum-product with its slots in registers. Codes
beyond the limits by their row degree alone (rows of 8-18 slots: the
rate-2/3, 3/4 and 5/6 qc648 and qc1944 codes) take the same designs with
each row's slots unrolled to its degree (``WIDE_LIMITS``): the ``_cw``
kernels for min-sum flooding and serial-C (the compressed state with a
32-bit word), the ``_rw`` kernels for sum-product serial-C and the
``_gw`` kernels for the group-serial forms of both rules; their
sum-product flooding, and every form of any other code beyond the limits,
keeps the full messages with the plan in shared memory. The source is
compiled with ``nvcc`` for ``sm_90a``, once per storage type in
parallel, into ``build/kernels/`` of the checkout on first use, linked
into one library and loaded with ctypes. The drivers :func:`bp_qc_requeue` and
:func:`bp_qc_probe_requeue` port the JAX functions of the same names
(``:820-901``, ``:912-1053``). :func:`default_threads` and
``_LAUNCH_TABLE`` are the counterparts of JAX's ``default_tile`` and
``_TILE_TABLE`` (``:86-96``), filled from H100 sweeps of
:mod:`.tune`; :mod:`.compare` times the kernels of two checkouts on one
card.

:func:`bp_qc_cuda` launches a kernel for a CUDA tensor and runs the
plain version (:func:`..ops.bp_roll.decode_roll`) for a CPU tensor, and
so do the drivers through it; nothing else selects the plain version.
``LAUNCHES`` counts the kernel launches per kernel name (the form),
``ENTRY_LAUNCHES`` per CUDA entry point launched (:func:`entry_point`:
the form's kernel of the design its code takes).
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
from ldpc_sims_tpu_torch.ops.bp_roll import (
    NO_GRADIENT,
    EdgeTables,
    decode_roll,
    msg_qstep,
    needs_gradient,
    pack_edge_weights,
    qc_plan,
    storage_dtype,
)

__all__ = [
    "COMPRESSED_LIMITS",
    "ENTRY_LAUNCHES",
    "LAUNCHES",
    "KERNELS",
    "KERNELS_W",
    "SOURCE",
    "WIDE_LIMITS",
    "bp_qc_cuda",
    "bp_qc_probe_requeue",
    "bp_qc_requeue",
    "build",
    "compressed_state",
    "default_threads",
    "design",
    "entry_point",
    "group_plan",
    "group_plan_bytes",
    "kernel_name",
    "probe_capacity",
    "minsum_qc_cuda",
    "reset_launch_counts",
    "smem_bytes",
    "sumproduct_registers",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "minsum_qc.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add: keeps the arithmetic equal to the plain version
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
METHODS = ("min-sum", "sum-product")
# the source's storage code (-DQC_STORAGE, bp_qc_decode's dtype) and the
# suffix of its entry points, per message storage type
STORAGE = {torch.float32: (0, ""), torch.bfloat16: (1, "_bf16"),
           torch.int8: (2, "_i8")}
# entry point of csrc/minsum_qc.cu per (method, schedule, early_stop,
# quantized): minsum_qc_flooding, ..., sumproduct_qc_layered_es_msgq
KERNELS = {
    (m, s, es, q): (f"{m.replace('-', '')}_qc_{s}" + ("_es" if es else "")
                    + ("_msgq" if q else ""))
    for m in METHODS for s in ("flooding", "layered")
    for es in (False, True) for q in (False, True)
}
# the weighted entry points per (method, schedule, quantized):
# minsum_qc_flooding_w, ..., sumproduct_qc_layered_w_msgq
KERNELS_W = {
    (m, s, q): f"{m.replace('-', '')}_qc_{s}_w" + ("_msgq" if q else "")
    for m in METHODS for s in ("flooding", "layered") for q in (False, True)
}
# launches per kernel (kernel_name) since the last reset_launch_counts()
LAUNCHES = {name + sfx: 0 for _, sfx in STORAGE.values()
            for name in (*KERNELS.values(), *KERNELS_W.values())}
# launches per CUDA entry point (entry_point) since the last
# reset_launch_counts(); only the entry points launched appear
ENTRY_LAUNCHES: dict[str, int] = {}
# dynamic shared memory one H100 CTA may use
_SMEM_LIMIT = 232_448
# the limits of the compressed check state and of the sum-product slots in
# registers (csrc/minsum_qc.cu: kCsMaxDeg, kCsMaxRows, kCsMaxPlanes,
# kCsMaxCols): row degree (a thread's register arrays and the state word's
# 8 sign bits), block rows, planes and block columns (the kernel
# parameter's plan)
COMPRESSED_LIMITS = (8, 64, 192, 64)
# the compressed state's wide word (csrc/minsum_qc.cu: kCwMaxDeg,
# CwDegrees): its sign bits, and the row degrees its kernels have a body
# for (those of the library's codes with rows above 8 slots); the block
# rows, planes and block columns are COMPRESSED_LIMITS'
WIDE_LIMITS = (24, (8, 9, 11, 12, 17, 18))
# the kernel designs, bp_qc_decode's `design` (csrc/minsum_qc.cu:
# kDesignFull, kDesignCs, kDesignSr, kDesignGs, kDesignCw, kDesignGw,
# kDesignRw) and the entry points' suffix
DESIGNS = {"full": (0, ""), "compressed": (1, "_cs"), "registers": (2, "_sr"),
           "group": (3, "_gs"), "compressed-wide": (4, "_cw"),
           "group-wide": (5, "_gw"), "registers-wide": (6, "_rw")}
# the group-serial designs
GROUP_DESIGNS = ("group", "group-wide")
# the group-serial plan in the kernel parameter (csrc/minsum_qc.cu:
# GroupPlan): groups (G ≥ 2 over at most 64 block rows) and fold entries
# (two planes or more each, of at most 192), and the bytes a kernel's
# parameters may take on sm_90 (CUDA 12.1 and later)
GROUP_PLAN_LIMITS = (32, 96)
PARAM_BYTES_LIMIT = 32_764
# the flooding forms' CTA size where an H100 sweep (kernels/tune.py) found
# one faster than 256 (by more than 0.5%), keyed by (n, dtype name,
# schedule, method); the layered kernels size their own CTA.
# Min-sum, from the sweep of threads 128, 256, 512, 1024 × the three types,
# flooding-20 on the compressed check state, wifi1944 at batch 32768 and
# the 5G-class codes at 16384 (PERF.md §6, row 14; NVIDIA H100 80GB HBM3,
# 700 W): a 5G-class codeword fills most of an SM's shared memory (one to
# three CTAs an SM), so more threads a CTA are more warps an SM; wifi1944
# keeps 256 but at bf16, where 128 measured 0.7% faster. Sum-product, from
# the sweep of the kernels with a check's slots in registers (wifi1944 at
# 32768 over 128-512 threads, wifi648 at 4096 and 32768 over 64-384, the
# 5G-class codes at 16384 over 256-1024), where its best beat min-sum's
# entry by more than 0.5%: its 52-59 registers a thread hold a 256-thread
# CTA to four an SM, and at wifi648 the 12 block rows' tasks fill four
# warps evenly; wifi1944 int8 takes 384 (0.55% faster than 256).
_LAUNCH_TABLE: dict[tuple[int, str, str, str], int] = {
    (1944, "bfloat16", "flooding", "min-sum"): 128,
    (8448, "float32", "flooding", "min-sum"): 1024,
    (8448, "bfloat16", "flooding", "min-sum"): 512,
    (8448, "int8", "flooding", "min-sum"): 1024,
    (12288, "float32", "flooding", "min-sum"): 1024,
    (12288, "bfloat16", "flooding", "min-sum"): 1024,
    (12288, "int8", "flooding", "min-sum"): 1024,
    (648, "float32", "flooding", "sum-product"): 128,
    (648, "bfloat16", "flooding", "sum-product"): 128,
    (648, "int8", "flooding", "sum-product"): 128,
    (1944, "bfloat16", "flooding", "sum-product"): 128,
    (1944, "int8", "flooding", "sum-product"): 384,
    (8448, "float32", "flooding", "sum-product"): 1024,
    (8448, "bfloat16", "flooding", "sum-product"): 512,
    (8448, "int8", "flooding", "sum-product"): 512,
    (12288, "float32", "flooding", "sum-product"): 1024,
    (12288, "bfloat16", "flooding", "sum-product"): 512,
    (12288, "int8", "flooding", "sum-product"): 1024,
}


def default_threads(qc: QcStructure, dtype=torch.float32,
                    schedule: str = "flooding",
                    method: str = "min-sum") -> int:
    """The measured-best flooding CTA size for this (code, dtype,
    schedule, method): ``_LAUNCH_TABLE``'s entry, else 256."""
    name = str(storage_dtype(dtype)).removeprefix("torch.")
    return _LAUNCH_TABLE.get((qc.nb * qc.z, name, schedule, method), 256)


def kernel_name(method: str, schedule: str, early_stop: bool = False,
                quantized: bool = False, weighted: bool = False,
                dtype=torch.float32) -> str:
    """The entry point of csrc/minsum_qc.cu for a form: ``KERNELS`` or
    ``KERNELS_W``'s name plus the storage suffix (``_bf16``, ``_i8``)."""
    base = (KERNELS_W[method, schedule, quantized] if weighted
            else KERNELS[method, schedule, early_stop, quantized])
    return base + STORAGE[storage_dtype(dtype)][1]


def entry_point(qc: QcStructure, method: str, schedule: str,
                early_stop: bool = False, quantized: bool = False,
                weighted: bool = False, dtype=torch.float32,
                layered_group: int = 1) -> str:
    """The entry point of csrc/minsum_qc.cu that a decode of this form on
    this code launches: :func:`kernel_name`'s, with ``_cs`` before the
    storage suffix on the compressed check state (serial-C and flooding
    min-sum), ``_sr`` with the sum-product slots in registers (serial-C and
    flooding sum-product) and ``_gs`` for the group-serial forms of both
    rules, or on the wide rows ``_cw``, ``_rw`` and ``_gw`` for the same
    forms (:func:`design`)."""
    sfx = DESIGNS[design(qc, method, schedule, layered_group)][1]
    return (kernel_name(method, schedule, early_stop, quantized, weighted)
            + sfx + STORAGE[storage_dtype(dtype)][1])


# the JAX pallas backend pads the batch to 128 lanes (ldpc_sims_tpu/ops/
# bp.py:608-615); the probe driver's overflow rule depends on it
_JAX_TILE = 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ENTRY_LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the decode kernels")
    return path


def build() -> tuple[Path, str]:
    """Compile the kernels once per source content: one ``nvcc`` per
    storage type, all started together, then one link.

    Returns the shared library's path and ptxas's register and
    shared-memory report from the build that made it.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libminsum_qc_{tag}.so"
    report = BUILD_DIR / f"libminsum_qc_{tag}.ptxas.txt"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        objs = [lib.with_name(f"{lib.stem}.{code}.{os.getpid()}.o")
                for code, _ in STORAGE.values()]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-DQC_STORAGE={code}", "-c", "-o",
             str(obj), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for (code, _), obj in zip(STORAGE.values(), objs)]
        logs = []
        for proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n{err}")
        res = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with code {res.returncode}:\n"
                f"{res.stderr}")
        for obj in objs:
            obj.unlink()
        report.write_text("".join(logs))
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    return lib, report.read_text() if report.exists() else ""


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    lib.bp_qc_decode.argtypes = [
        i32, i32, i32, i32, i32, vp, vp, i32, vp, vp, vp, vp, vp, i32, vp,
        vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, f32, f32, f32,
        f32, f32, i32, vp,
    ]
    lib.bp_qc_decode.restype = i32
    lib.bp_qc_max_row_degree.argtypes = []
    lib.bp_qc_max_row_degree.restype = i32
    lib.bp_qc_compressed_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_qc_compressed_limits.restype = i32
    limits = (ctypes.c_int * len(COMPRESSED_LIMITS))()
    lib.bp_qc_compressed_limits(limits)
    if tuple(limits) != COMPRESSED_LIMITS:
        raise RuntimeError(f"the library's compressed-state limits "
                           f"{tuple(limits)} are not {COMPRESSED_LIMITS}")
    lib.bp_qc_wide_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_qc_wide_limits.restype = i32
    wide = (ctypes.c_int * 2)()
    lib.bp_qc_wide_limits(wide)
    want = (WIDE_LIMITS[0], sum(1 << d for d in WIDE_LIMITS[1]))
    if tuple(wide) != want:
        raise RuntimeError(f"the library's wide-word limits (slots, degree "
                           f"mask) {tuple(wide)} are not {want}")
    lib.bp_qc_group_plan_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_qc_group_plan_limits.restype = i32
    group = (ctypes.c_int * 3)()
    lib.bp_qc_group_plan_limits(group)
    want = (group_plan_bytes(), *GROUP_PLAN_LIMITS)
    if tuple(group) != want:
        raise RuntimeError(f"the library's group-serial plan (bytes, groups, "
                           f"fold entries) {tuple(group)} is not {want}")
    lib.bp_qc_error_string.argtypes = [i32]
    lib.bp_qc_error_string.restype = ctypes.c_char_p
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


def _within_limits(qc: QcStructure, wide: bool = False) -> bool:
    """A code within ``COMPRESSED_LIMITS`` (row degree, block rows, planes,
    block columns): its plan fits the kernel parameter and its rows the
    register arrays. ``wide``: within them but for the row degree, each
    row's degree one of ``WIDE_LIMITS``' (the wide word's bodies)."""
    planes, group_c, _ = qc_plan(qc)
    degree = max(len(ps) for ps in group_c)
    max_deg, max_rows, max_planes, max_cols = COMPRESSED_LIMITS
    if wide:
        rows_fit = all(len(ps) in WIDE_LIMITS[1] for ps in group_c)
    else:
        rows_fit = degree <= max_deg
    return (rows_fit and qc.mb <= max_rows
            and len(planes) <= max_planes and qc.nb <= max_cols)


def compressed_state(qc: QcStructure, method: str = "min-sum",
                     schedule: str = "layered",
                     layered_group: int = 1) -> bool:
    """Whether a decode keeps the compressed check state (csrc/minsum_qc.cu:
    two stored magnitudes and a word of signs and index a check): the
    min-sum forms, flooding, serial-C and group-serial, on a code within
    ``COMPRESSED_LIMITS`` (row degree, block rows, planes, block columns),
    and on the wide word on a code beyond them by its row degree alone
    (:func:`design`). Every other form keeps the full messages."""
    return (method == "min-sum"
            and design(qc, method, schedule, layered_group) != "full")


def sumproduct_registers(qc: QcStructure, method: str = "sum-product",
                         schedule: str = "layered",
                         layered_group: int = 1) -> bool:
    """Whether a decode runs the sum-product kernels with a check's slots in
    registers (csrc/minsum_qc.cu, the _sr and _gs kernels: full messages,
    each edge's message and posterior read once, the slots unrolled to the
    check's degree, the plan in the kernel parameter): the sum-product
    forms of every schedule and group on a code within
    ``COMPRESSED_LIMITS``, the register arrays' 8 slots and the
    parameter's plan, and on a code beyond them by its row degree alone
    (each row's degree one of ``WIDE_LIMITS``') serial-C and group-serial
    on the _rw and _gw kernels. The other decodes keep the full-message
    kernels with the plan in shared memory."""
    return (method == "sum-product"
            and design(qc, method, schedule, layered_group) != "full")


def design(qc: QcStructure, method: str, schedule: str,
           layered_group: int = 1) -> str:
    """The kernel design a decode launches, a key of ``DESIGNS``, on a code
    within ``COMPRESSED_LIMITS``: 'group' for the group-serial forms
    (layered, ``min(layered_group, mb) > 1``), else 'compressed'
    (min-sum) or 'registers' (sum-product). Beyond the limits by the row
    degree alone (each row's degree one of ``WIDE_LIMITS``': the rate-2/3,
    3/4 and 5/6 qc648 and qc1944 codes), the same forms on the wide rows:
    'group-wide', 'compressed-wide' or 'registers-wide', but for
    sum-product flooding, which keeps 'full' there (its kernel with the
    slots in registers measured slower, PERF.md). Every other decode
    beyond the limits takes 'full'."""
    group = schedule == "layered" and min(layered_group, qc.mb) > 1
    if _within_limits(qc):
        rows = ""
    elif _within_limits(qc, wide=True):
        rows = "-wide"
        if method == "sum-product" and schedule == "flooding":
            return "full"
    else:
        return "full"
    if group:
        return "group" + rows
    return ("compressed" if method == "min-sum" else "registers") + rows


def group_plan_bytes() -> int:
    """The bytes of the group-serial plan in the kernel parameter
    (csrc/minsum_qc.cu: GroupPlan, its arrays sized for the largest code
    within ``COMPRESSED_LIMITS``), each array at its element's alignment:
    ParamPlan's row_ptr (int) and planes (int4), FloodPlan's col_ptr (int)
    and column entries (int4), then fold_ptr and scratch (int) and the
    fold entries (int4)."""
    _, rows, planes, cols = COMPRESSED_LIMITS
    groups, folds = GROUP_PLAN_LIMITS
    size = 0
    for count, nbytes, align in ((rows + 1, 4, 4), (planes, 16, 16),
                                 (cols + 1, 4, 4), (planes, 16, 16),
                                 (groups + 1, 4, 4), (planes, 4, 4),
                                 (folds, 16, 16)):
        size = -(-size // align) * align + count * nbytes
    return -(-size // 16) * 16


@functools.lru_cache(maxsize=256)
def group_plan(qc: QcStructure, layered_group: int) -> np.ndarray:
    """The group-serial kernels' per-group plan (csrc/minsum_qc.cu:
    GroupPlan) as the int32 host ints the launcher copies into the kernel
    parameter, for groups of G = ``min(layered_group, mb)`` block rows (the
    last one possibly shorter). A plane is private when it is the only
    plane of its column block within its group (its change folds at once),
    else shared (its change waits in the group's scratch, in variable
    orientation). Layout:

    * a header: G, groups, fold entries F, shared planes, and the largest
      group's shared planes (its scratch rows);
    * ``fold_ptr[groups + 1]``: group g's fold entries are
      ``[fold_ptr[g], fold_ptr[g + 1])``;
    * per plane, its scratch row times z within its group, or −1 (private);
    * per fold entry (col·z, row·z, count): a column block that count ≥ 2
      planes of its group meet, and the first of their scratch rows; they
      take consecutive rows in block-row order (the plain version's fold
      order).

    Raises ValueError when the plan does not fit ``GROUP_PLAN_LIMITS``."""
    planes, group_c, _ = qc_plan(qc)
    z, mb = qc.z, qc.mb
    G = min(layered_group, mb)
    if G < 2:
        raise ValueError(f"a group-serial plan needs G ≥ 2, got {G}")
    scratch = [-1] * len(planes)
    fold_ptr, fold = [0], []
    widest = shared = 0
    for g0 in range(0, mb, G):
        by_col: dict[int, list[int]] = {}
        for i in range(g0, min(g0 + G, mb)):  # block rows in order
            for p in group_c[i]:
                by_col.setdefault(planes[p][1], []).append(p)
        rows = 0
        for j, ps in sorted(by_col.items()):
            if len(ps) < 2:
                continue
            fold.append((j * z, rows * z, len(ps)))
            for p in ps:
                scratch[p] = rows * z
                rows += 1
        fold_ptr.append(len(fold))
        widest, shared = max(widest, rows), shared + rows
    groups = len(fold_ptr) - 1
    max_groups, max_folds = GROUP_PLAN_LIMITS
    if groups > max_groups or len(fold) > max_folds:
        raise ValueError(
            f"the group-serial plan of G={G} has {groups} groups and "
            f"{len(fold)} fold entries; the kernel parameter takes at most "
            f"{max_groups} and {max_folds}")
    return np.array([G, groups, len(fold), shared, widest, *fold_ptr,
                     *scratch, *(x for f in fold for x in f)], np.int32)


def smem_bytes(qc: QcStructure, layered_group: int = 1,
               dtype=torch.float32, method: str = "min-sum",
               schedule: str = "flooding") -> int:
    """Dynamic shared memory of one CTA: the int32 plan (not for flooding
    on the compressed state, the sum-product slots in registers or the
    group-serial kernels, whose plan is the kernel's parameter); the c2v
    planes (4, 2 or 1 B a message for f32, bf16, int8) or, on the
    compressed state (:func:`compressed_state`), two stored magnitudes and
    a 2-byte word a check (a 4-byte word on the wide word's kernels,
    'compressed-wide' and 'group-wide'); the posterior (2 B a variable for
    bf16, else 4), and the LLRs in its type for the flooding forms that
    read their plan from the parameter; and for a group-serial launch the
    f32 scratch of the message changes: the largest group's shared planes
    (:func:`group_plan`) for the group-serial kernels, a group's planes (at
    most ``min(P, G·row degree)``) for the full-message kernels, each z
    floats; each region on a 16-byte boundary."""
    planes, group_c, _ = qc_plan(qc)
    P = len(planes)

    def a16(nbytes: int) -> int:
        return -(-nbytes // 16) * 16

    dtype = storage_dtype(dtype)
    msg = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    post = 2 if dtype == torch.bfloat16 else 4
    G = min(layered_group, qc.mb)
    degree = max(len(ps) for ps in group_c)
    checks = qc.mb * qc.z
    kind = design(qc, method, schedule, layered_group)
    sr = kind in ("registers", "registers-wide")
    gs = kind in GROUP_DESIGNS
    cs = compressed_state(qc, method, schedule, layered_group)
    if gs:
        scratch = int(group_plan(qc, G)[4]) * qc.z
    else:
        scratch = min(P, G * degree) * qc.z if G > 1 else 0
    flooding = schedule == "flooding"
    word = 4 if kind in ("compressed-wide", "group-wide") else 2
    state = (a16(2 * msg * checks) + a16(word * checks) if cs
             else a16(msg * P * qc.z))
    param_plan = (cs and flooding) or sr or gs
    plan = 0 if param_plan else a16(4 * (qc.mb + 1 + 3 * P + qc.nb + 1))
    # the LLRs beside the posterior
    posts = (2 if flooding and param_plan else 1) * a16(post * qc.nb * qc.z)
    return plan + state + posts + 4 * scratch


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
def _host_plan(qc: QcStructure) -> np.ndarray:
    """The plan on the host, which the compressed forms read into their
    kernel parameter (kept alive here for the pointer)."""
    return np.ascontiguousarray(_plan_array(qc))


@functools.lru_cache(maxsize=64)
def _device_tables(qc: QcStructure, alpha, beta, iterations: int,
                   device: str) -> tuple[torch.Tensor, torch.Tensor]:
    plan = torch.from_numpy(_plan_array(qc)).to(device)
    ab = torch.from_numpy(_ab_table(alpha, beta, iterations)).to(device)
    return plan, ab


def _check_weights(llr, weights, early_stop: bool, done_in) -> None:
    """JAX's early-stop check of kernel weights (the packer checks their
    flavor), and the port's: the kernels carry no gradient, so LLRs or
    weights that need one raise rather than lose it."""
    tensors = () if weights is None else (
        weights if isinstance(weights, EdgeTables) else weights.values())
    if needs_gradient(llr, *tensors):
        raise NotImplementedError(NO_GRADIENT)
    if weights is not None and (early_stop or done_in is not None):
        raise ValueError("neural-BP weights with early stop is unsupported")


def bp_qc_cuda(
    llr: torch.Tensor,
    qc: QcStructure,
    iterations: int = 20,
    alpha=1.0,
    beta=0.0,
    clamp: float | None = None,
    schedule: str = "flooding",
    output: str = "hard",
    early_stop: bool = False,
    es_check_every: int = 1,
    done_in: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    method: str = "min-sum",
    msg_qbits: int | None = None,
    msg_qclip: float = 20.0,
    weights=None,
    layered_group: int = 1,
    dtype=torch.float32,
    threads: int | None = None,
):
    """(batch, n) f32 channel LLRs (log Pr1/Pr0) → hard bits or posterior.

    ``method``: 'min-sum' with ``alpha``/``beta`` scalars or
    length-``iterations`` tuples (a frozen per-iteration schedule), or
    'sum-product' (stable log domain; scalar α/β are ignored, tuples
    raise). ``clamp`` bounds each c2v message;
    ``msg_qbits`` then quantizes it to ``2**msg_qbits − 1`` levels over
    ±``msg_qclip``. ``weights``: edge-flavor neural-BP weights (JAX's
    dict, packed here, or :class:`EdgeTables` packed once by the caller)
    for the ``_w`` entry points; not with early stop or ``done_in``, and
    not with tensors that need a gradient (the kernels carry none:
    :data:`NO_GRADIENT`), nor may ``llr`` need one.
    ``schedule`` 'flooding' or 'layered'; ``layered_group``: block rows
    per serial group of the layered schedule (1 = serial-C). ``output``:
    'hard' (int8 bits), 'posterior' (f32, log(Pr1/Pr0)), 'hard_unsat' ((bits,
    (batch,) int32 unsatisfied-check counts) after a fixed decode) or,
    with ``early_stop``, 'hard_iters' ((bits, (batch,) int32 iterations
    run)). ``early_stop``: each codeword stops at its first
    syndrome-satisfying state, checked at entry and every
    ``es_check_every`` iterations (K must divide ``iterations``).
    ``done_in``: (batch,) mask of codewords not to decode: their rows of
    the output are not written (unspecified in a fresh output) and, under
    early stop, their iteration count is 0. ``out``: an optional (batch,
    n) output buffer to write into. Any batch size ≥ 1 works.
    ``dtype``: the message storage, torch.float32, torch.bfloat16
    (messages, posterior and LLRs) or torch.int8 (messages on the
    255-level grid over ±``msg_qclip``), with the Pallas kernel's
    semantics (:func:`..ops.bp_roll.decode_roll`); the posterior output
    is f32 either way. ``threads``: the flooding forms' CTA size, a
    multiple of 32 in [32, 1024] (JAX's ``tile``); None takes
    :func:`default_threads`. The layered kernels size their own CTA (z
    threads a block row, or the group-serial kernels' warps), so a layered
    decode takes no ``threads``.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if output not in ("hard", "posterior", "hard_iters", "hard_unsat"):
        raise ValueError(f"kernel output must be 'hard' or 'posterior', or "
                         f"'hard_iters'/'hard_unsat', got {output!r}")
    if output == "hard_iters" and not early_stop:
        raise ValueError("output='hard_iters' requires early_stop=True")
    if output == "hard_unsat" and early_stop:
        raise ValueError(
            "output='hard_unsat' is the fixed-decode fused-syndrome path; "
            "early_stop computes syndromes already"
        )
    if es_check_every < 1 or iterations % es_check_every:
        raise ValueError(
            f"es_check_every={es_check_every} must divide "
            f"iterations={iterations}"
        )
    if isinstance(alpha, list):
        alpha = tuple(alpha)
    if isinstance(beta, list):
        beta = tuple(beta)
    if method not in METHODS:
        raise ValueError(f"unsupported kernel method {method!r}")
    if isinstance(alpha, torch.Tensor) or isinstance(beta, torch.Tensor):
        raise TypeError("per-iteration alpha/beta must be tuples of floats "
                        "(ops.bp.freeze_minsum_weights)")
    if method != "min-sum" and (isinstance(alpha, tuple)
                                or isinstance(beta, tuple)):
        raise ValueError("per-iteration alpha/beta require min-sum")
    if layered_group < 1 or (layered_group > 1 and schedule != "layered"):
        raise ValueError("layered_group needs schedule='layered'")
    _check_weights(llr, weights, early_stop, done_in)
    dtype = storage_dtype(dtype)
    if threads is not None and schedule == "layered":
        raise ValueError("threads sets the flooding forms' CTA size; a "
                         "layered CTA is sized by its kernel")
    if threads is None:
        threads = default_threads(qc, dtype, schedule, method)
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads={threads!r} must be a multiple of 32 "
                         "in [32, 1024]")
    if dtype == torch.int8 and not msg_qclip > 0:
        raise ValueError(f"int8 storage needs msg_qclip > 0, got "
                         f"{msg_qclip!r}")
    qstep = msg_qstep(msg_qbits, msg_qclip)
    _ab_table(alpha, beta, iterations)  # validates tuple lengths
    B = llr.shape[0]
    if done_in is not None and tuple(done_in.shape) != (B,):
        raise ValueError(f"done_in must have shape ({B},)")
    hard = output != "posterior"
    out_dtype = torch.int8 if hard else torch.float32
    if out is not None and (out.shape != llr.shape or out.dtype != out_dtype
                            or out.device != llr.device
                            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous {out_dtype} tensor of shape "
            f"{tuple(llr.shape)} on {llr.device}"
        )
    if llr.device.type == "cpu":
        res = decode_roll(llr, qc, iterations=iterations, alpha=alpha,
                          beta=beta, clamp=clamp, output=output,
                          schedule=schedule, early_stop=early_stop,
                          es_check_every=es_check_every, done_in=done_in,
                          method=method, msg_qbits=msg_qbits,
                          msg_qclip=msg_qclip, weights=weights,
                          layered_group=layered_group, dtype=dtype)
        if out is None:
            return res
        main = res[0] if isinstance(res, tuple) else res
        rows = slice(None) if done_in is None else ~done_in.bool()
        out[rows] = main[rows]
        return (out, res[1]) if isinstance(res, tuple) else out
    if llr.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {llr.device}")
    if llr.dtype != torch.float32:
        raise ValueError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != qc.nb * qc.z:
        raise ValueError("llr width does not match the QC code")
    if B < 1:
        raise ValueError("empty batch")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    smem = smem_bytes(qc, layered_group, dtype, method, schedule)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"code needs {smem} B of shared memory per codeword with "
            f"{dtype} storage, more than the {_SMEM_LIMIT} B a CTA can have"
        )
    lib = _library()
    planes, group_c, _ = qc_plan(qc)
    degree = max(len(ps) for ps in group_c)
    # the sum-product kernels keep a check's lt values in a per-thread array
    cap = lib.bp_qc_max_row_degree()
    if method == "sum-product" and degree > cap:
        raise ValueError(
            f"the QC code with a {qc.mb}x{qc.nb} base of z={qc.z} has a "
            f"check of degree {degree}; the sum-product kernels take at "
            f"most {cap}"
        )
    kind = design(qc, method, schedule, layered_group)
    # the group-serial kernels' per-group plan (raises when it does not fit
    # the kernel parameter)
    group = (group_plan(qc, layered_group) if kind in GROUP_DESIGNS
             else None)
    plan, ab = _device_tables(qc, alpha, beta, iterations, str(llr.device))
    wm = wl = None
    if weights is not None:
        wt = pack_edge_weights(weights, qc, iterations, llr.device)
        if wt.msg.device != llr.device or wt.llr.device != llr.device:
            raise ValueError(f"edge tables must lie on {llr.device}")
        wm, wl = wt.msg.contiguous(), wt.llr.contiguous()
    if out is None:
        out = torch.empty(llr.shape, dtype=out_dtype, device=llr.device)
    flags = None
    if done_in is not None:
        flags = done_in.to(device=llr.device, dtype=torch.int32).contiguous()
    aux = None
    if early_stop or output == "hard_unsat":
        # zeros: a skipped codeword reports 0 iterations
        aux = torch.zeros(B, dtype=torch.int32, device=llr.device)
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    quant = qstep is not None
    # the int8 grid's step and reciprocal, taken in double (decode_roll)
    sstep = 2.0 * msg_qclip / 255.0 if dtype == torch.int8 else 1.0
    err = lib.bp_qc_decode(
        STORAGE[dtype][0],
        int(method == "sum-product"), int(schedule == "layered"),
        int(early_stop), int(quant), llr.data_ptr(),
        out.data_ptr(), int(hard),
        None if flags is None else flags.data_ptr(),
        None if aux is None else aux.data_ptr(),
        plan.data_ptr(), _host_plan(qc).ctypes.data,
        None if group is None else group.ctypes.data, DESIGNS[kind][0],
        ab.data_ptr(),
        None if wm is None else wm.data_ptr(),
        None if wl is None else wl.data_ptr(),
        B, qc.z, qc.mb, qc.nb, len(planes), degree, iterations,
        es_check_every,
        layered_group, math.inf if clamp is None else float(clamp),
        qstep if quant else 1.0, float(msg_qclip) if quant else math.inf,
        sstep, 1.0 / sstep, threads, stream,
    )
    entry = entry_point(qc, method, schedule, bool(early_stop), quant,
                        wm is not None, dtype, layered_group)
    if err != 0:
        msg = lib.bp_qc_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")
    LAUNCHES[kernel_name(method, schedule, bool(early_stop), quant,
                         wm is not None, dtype)] += 1
    ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + 1
    if output in ("hard_iters", "hard_unsat"):
        return out, aux
    return out


def minsum_qc_cuda(llr, qc, **kw):
    """Alias of :func:`bp_qc_cuda` (the JAX package's ``minsum_qc_pallas``)."""
    return bp_qc_cuda(llr, qc, **kw)


def bp_qc_requeue(
    llr: torch.Tensor,
    qc: QcStructure,
    iterations: int = 20,
    probe_iters: int = 4,
    alpha=1.0,
    beta=0.0,
    clamp: float | None = None,
    es_check_every: int = 2,
    schedule: str = "flooding",
    output: str = "hard",
    method: str = "min-sum",
    msg_qbits: int | None = None,
    msg_qclip: float = 20.0,
    layered_group: int = 1,
    dtype=torch.float32,
    threads: int | None = None,
):
    """Early-stop decode as an early-stop probe, then a full-budget
    early-stop pass over the codewords the probe did not finish.

    The JAX function's results: ``done = iters1 < probe_iters``; bits are
    the probe's where done, else the second pass's; iterations are
    ``iters1`` where done, else ``probe_iters + iters2``. A frozen
    per-iteration schedule runs its prefix in the probe; ``method``, the
    message quantization, ``layered_group``, the storage ``dtype`` and
    ``threads`` apply to both passes, which read the same f32 LLRs (JAX's
    compact pass gathers them in their own type). The TPU sorts the
    converged lanes to the front so that whole tiles skip; a CTA decodes
    one codeword, so the second pass is one launch over the whole batch
    with ``done_in = done``, writing straight into the probe's bits.
    """
    if output not in ("hard", "hard_iters"):
        raise ValueError("bp_qc_requeue outputs hard bits only")
    a_probe = alpha[:probe_iters] if isinstance(alpha, tuple) else alpha
    b_probe = beta[:probe_iters] if isinstance(beta, tuple) else beta
    kw = dict(clamp=clamp, schedule=schedule, output="hard_iters",
              early_stop=True, es_check_every=es_check_every, method=method,
              msg_qbits=msg_qbits, msg_qclip=msg_qclip,
              layered_group=layered_group, dtype=dtype, threads=threads)
    bits, iters1 = bp_qc_cuda(llr, qc, probe_iters, alpha=a_probe,
                              beta=b_probe, **kw)
    # converged := finished under budget at a checked state; a codeword
    # that converged exactly at the budget is re-decoded, which is merely
    # redundant
    done = iters1 < probe_iters
    _, iters2 = bp_qc_cuda(llr, qc, iterations, alpha=alpha, beta=beta,
                           done_in=done, out=bits, **kw)
    if output == "hard_iters":
        return bits, torch.where(done, iters1, probe_iters + iters2)
    return bits


def probe_capacity(batch: int) -> int:
    """The JAX probe driver's straggler capacity C for a batch padded to
    the TPU's lane tile T: ``min(B, max(T, ⌈B/(4·T)⌉·T))``."""
    padded = -(-batch // _JAX_TILE) * _JAX_TILE
    return min(padded,
               max(_JAX_TILE, -(-padded // (4 * _JAX_TILE)) * _JAX_TILE))


def bp_qc_probe_requeue(
    llr: torch.Tensor,
    qc: QcStructure,
    iterations: int = 20,
    probe_iters: int = 6,
    alpha=1.0,
    beta=0.0,
    probe_alpha=None,
    probe_beta=None,
    clamp: float | None = None,
    schedule: str = "layered",
    output: str = "hard",
    method: str = "min-sum",
    msg_qbits: int | None = None,
    msg_qclip: float = 20.0,
    layered_group: int = 1,
    dtype=torch.float32,
    threads: int | None = None,
):
    """Adaptive decode: a fixed ``probe_iters`` probe with the fused
    unsatisfied-check count, then a fixed full-budget pass over the
    codewords whose syndrome fails.

    The JAX function's results, its overflow rule included: with C =
    :func:`probe_capacity` of the batch, ``overflowed = (B − n_done) > C``
    and on overflow every codeword re-decodes at the full budget (bits
    from the second pass, ``probe_iters + iterations`` for all);
    otherwise done codewords keep the probe's bits and report
    ``probe_iters``. ``overflowed`` is computed on the device and becomes
    part of the second pass's ``done_in`` mask, so the driver never reads
    the device from the host. The probe's (α, β) is ``probe_alpha``/
    ``probe_beta`` or else the full schedule; a tuple of another length
    than ``probe_iters`` is cut to its first ``probe_iters`` entries, as
    the JAX function does (silently). ``method``, the message
    quantization, ``layered_group``, the storage ``dtype`` and
    ``threads`` apply to both passes.
    """
    if output not in ("hard", "hard_iters"):
        raise ValueError("bp_qc_probe_requeue outputs hard bits only")
    pa = alpha if probe_alpha is None else probe_alpha
    pb = beta if probe_beta is None else probe_beta
    for t, nm in ((pa, "es_probe_alpha"), (pb, "es_probe_beta")):
        if isinstance(t, tuple) and len(t) < probe_iters:
            raise ValueError(
                f"{nm} has {len(t)} entries for probe_iters={probe_iters}"
            )
    if isinstance(pa, tuple):
        pa = pa[:probe_iters]
    if isinstance(pb, tuple):
        pb = pb[:probe_iters]
    kw = dict(clamp=clamp, schedule=schedule, method=method,
              msg_qbits=msg_qbits, msg_qclip=msg_qclip,
              layered_group=layered_group, dtype=dtype, threads=threads)
    bits, unsat = bp_qc_cuda(llr, qc, probe_iters, alpha=pa, beta=pb,
                             output="hard_unsat", **kw)
    done = unsat == 0
    overflowed = (llr.shape[0] - done.sum()) > probe_capacity(llr.shape[0])
    keep = done & ~overflowed
    bp_qc_cuda(llr, qc, iterations, alpha=alpha, beta=beta, done_in=keep,
               out=bits, **kw)
    if output == "hard_iters":
        iters = torch.where(keep, probe_iters, probe_iters + iterations)
        return bits, iters.to(torch.int32)
    return bits

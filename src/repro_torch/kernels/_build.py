"""Build the CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``kernels/build/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags. The first :func:`library` call starts one
``nvcc`` per source, all at once, and waits for them; later calls reuse
the loaded handles. A missing ``nvcc`` or a failed build raises — there
is no fallback.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` with no
``--use_fast_math``: every product and sum rounds on its own, exactly as
PyTorch's separate eager ops round, so a kernel's float32 update matches
its plain version bit for bit and cannot flip a bf16 rounding.
``flash_attention.cu`` is held to a tolerance, not bitwise: its
bfloat16 kernel takes its products on the tensor cores (``wgmma``, which
the flag does not touch) and its float32 kernel writes them as explicit
``fmaf`` (fused whatever the flag). ptxas's report of each kernel
(registers, spills, shared memory) is kept beside its library, so that
:data:`build_info` has it whether or not this process built it.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("opt_step", "avg_disp", "mix_disp", "avg_disp_outer",
           "compressed_mix", "flash_attention", "rglru_scan", "rwkv6_scan")
#: worker rows the plane kernels take (their register arrays and the
#: shared-memory mixing matrix are sized for at most this many)
MAX_WORKERS = 64

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ULL = ctypes.c_ulonglong
#: C signatures of the entry points (see the .cu files)
SIGNATURES = {
    "opt_step": ("opt_step_launch",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I,
                  _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _F, _I, _ULL,
                  _ULL, _P]),
    "avg_disp": ("avg_disp_launch",
                 [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _ULL, _P]),
    "mix_disp": ("mix_disp_launch",
                 [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _ULL, _P]),
    "avg_disp_outer": ("avg_disp_outer_launch",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _F,
                        _F, _I, _P]),
    "compressed_mix": ("compressed_mix_launch",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I,
                        _I, _I, _I, _I, _ULL, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P]),
    "rglru_scan": ("rglru_scan_launch", [_P, _P, _P, _I, _I, _I, _P]),
    "rwkv6_scan": ("rwkv6_scan_launch",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}

_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, the sources built, and per source
#: ptxas's resources of each kernel (:func:`ptxas_resources`), read back
#: from beside the library where it was built before
build_info: dict = {}


def ptxas_resources(log: str) -> list[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log, under its mangled name
    (``...emit_colsILi64ELi0EE...`` is ``emit_cols<64, 0>``): registers,
    spill stores and loads, stack frame and shared memory, in bytes."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            # static shared memory; a kernel with only dynamic shared
            # memory prints none
            sm = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)),
                       smem=int(sm.group(1)) if sm else 0)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _ptxas_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas.json")


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``build_info``."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_info.setdefault("ptxas", {})[n] = ptxas_resources(log)
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (exit {proc.returncode}):\n{log}")
            else:
                _ptxas_path(n).write_text(
                    json.dumps(build_info["ptxas"][n]))
                os.replace(tmp, _lib_path(n))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for n in SOURCES:
        if n not in todo and _ptxas_path(n).exists():
            build_info.setdefault("ptxas", {})[n] = json.loads(
                _ptxas_path(n).read_text())
    build_info["seconds"] = time.perf_counter() - t0
    build_info["built"] = todo
    return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (builds on first use)."""
    if name not in _libs:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check_plane(what: str, name: str, t, like) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous float32 tensor
    of ``like``'s shape on ``like``'s device."""
    import torch
    if (t.device != like.device or t.dtype != torch.float32
            or t.shape != like.shape or not t.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(like.shape)} on {like.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_matrix(what: str, W, plane) -> None:
    """Raise ``ValueError`` unless ``W`` is a contiguous float32 (M, M)
    matrix on the (M, P) ``plane``'s device."""
    import torch
    m = plane.shape[0]
    if (W.device != plane.device or W.dtype != torch.float32
            or tuple(W.shape) != (m, m) or not W.is_contiguous()):
        raise ValueError(
            f"{what}: W must be a contiguous float32 ({m}, {m}) tensor on "
            f"{plane.device}, got {W.dtype} {tuple(W.shape)} on "
            f"{W.device} (contiguous={W.is_contiguous()})")


def check_workers(what: str, m: int) -> None:
    """Raise ``ValueError`` unless the kernels take ``m`` worker rows."""
    if not 1 <= m <= MAX_WORKERS:
        raise ValueError(f"{what}'s kernel takes 1..{MAX_WORKERS} worker "
                         f"rows, got {m}")


def row_bits(what: str, mask, m: int) -> int:
    """An (M,) 0/1 row mask (numpy, a sequence or a tensor; a CUDA
    tensor is copied back) as the 64-bit word the masked plane kernels
    take by value: bit i is row i. Raises ``ValueError`` for a mask of
    another length, for entries other than 0 and 1, and for more rows
    than the kernels take."""
    import numpy as np
    check_workers(what, m)
    if hasattr(mask, "detach"):
        mask = mask.detach().cpu().numpy()
    a = np.asarray(mask, np.float64).reshape(-1)
    if a.shape != (m,):
        raise ValueError(f"{what}: a row mask of {m} rows, got shape "
                         f"{np.shape(mask)}")
    if not np.all((a == 0.0) | (a == 1.0)):
        raise ValueError(f"{what}: a row mask holds 0 or 1, got {a}")
    return sum(1 << i for i in np.flatnonzero(a).tolist())


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")

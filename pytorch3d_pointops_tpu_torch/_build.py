"""Builds the CUDA kernels in ``csrc/`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/lib<name>_<hash>.so`` at the repository root, named by a
hash of its source and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing builds at import: the first kernel launch
(or ``build_all``) compiles every missing library, one ``nvcc`` process per
source, all started together. Every C entry point takes pointers and the
CUDA stream as ``void*`` and returns its ``cudaError_t``; ``check`` raises on
anything but success.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
SOURCES = ("knn", "chamfer_nn", "scatter", "ball_query", "fps")

# -fmad=false keeps every multiply and add rounded on its own, as PyTorch's
# elementwise ops round them, so distances match the plain versions bit for
# bit; the kernels also spell the distance arithmetic with __f*_rn.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns ``{name: compiler output}`` for the sources it compiled, with
    each kernel's registers, shared memory and spills from ``ptxas -v``.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{lib_path(name)}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v",
               os.path.join(CSRC_DIR, f"{name}.cu"), "-o", tmp]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + "\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _LOCK:
        if name not in _LIBS:
            if not os.path.exists(lib_path(name)):
                build_all()
            _LIBS[name] = ctypes.CDLL(lib_path(name))
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned anything but ``cudaSuccess``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

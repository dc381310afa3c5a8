"""Builds the CUDA kernels and the host library in ``csrc/`` and loads them
with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/lib<name>_<hash>.so`` at the repository root, named by a
hash of its source and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing builds at import: the first kernel launch
(or ``build_all``) compiles every missing library, one ``nvcc`` process per
source, all started together. Every C entry point takes pointers and the
CUDA stream as ``void*`` and returns its ``cudaError_t``; ``check`` raises on
anything but success.

The host library ``csrc/pointops_cpu.cpp`` (``native.py``) compiles with the
C++ compiler (``$CXX``, else ``g++``) into ``build/libpointops_cpu_<hash>.so``
at its first ``load_host()``, never from ``build_all``: a machine that only
runs kernels starts no ``g++``. Its flags hold ``-march=native``, so the hash
also covers the machine, the compiler's version and the instruction sets that
``-march=native`` turns on there: a ``build/`` copied to another CPU builds
anew instead of loading code that CPU may not run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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

# The JAX package's flags for the same source: the two builds are bit-equal.
HOST_SOURCE = "pointops_cpu"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-pthread")

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


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if not found:
        raise ImportError(f"the host library needs a C++ compiler: {cxx!r} not found")
    return found


def host_lib_path() -> str:
    """Where the host library is built: a hash of its source, the flags, the
    machine, the compiler's version and the macros ``-march=native`` defines
    (the instruction sets it compiles for)."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout
    isa = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                         capture_output=True, text=True, check=True).stdout
    with open(os.path.join(CSRC_DIR, f"{HOST_SOURCE}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read())
    for part in (" ".join(CXX_FLAGS), platform.machine(), version, isa):
        digest.update(part.encode())
    return os.path.join(BUILD_DIR, f"lib{HOST_SOURCE}_{digest.hexdigest()[:16]}.so")


def load_host() -> ctypes.CDLL:
    """The loaded host library, compiled at the first call. Several processes
    may build at once: each writes its own temporary file and moves it into
    place. Raises ``ImportError`` when there is no compiler or it fails."""
    with _LOCK:
        if HOST_SOURCE not in _LIBS:
            try:
                path = host_lib_path()
                if not os.path.exists(path):
                    os.makedirs(BUILD_DIR, exist_ok=True)
                    tmp = f"{path}.tmp{os.getpid()}"
                    subprocess.run(
                        [_cxx(), *CXX_FLAGS,
                         os.path.join(CSRC_DIR, f"{HOST_SOURCE}.cpp"), "-o", tmp],
                        check=True, capture_output=True, text=True,
                    )
                    os.replace(tmp, path)
                _LIBS[HOST_SOURCE] = ctypes.CDLL(path)
            except subprocess.CalledProcessError as e:
                raise ImportError(f"the host library did not build: {e.stderr}") from e
            except OSError as e:
                raise ImportError(f"the host library did not build or load: {e}") from e
        return _LIBS[HOST_SOURCE]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned anything but ``cudaSuccess``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, as a raw pointer. Reads it
    without building a ``torch.cuda.Stream`` (which costs microseconds of
    host time per launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))

"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` for ``sm_90a`` into its
own shared library with a C interface and loaded with ``ctypes``.  Libraries
go to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of every source in ``csrc/`` (the ``.cuh`` headers are
shared), so an edited source is rebuilt and an unchanged one is loaded as it
is.  All sources are compiled in parallel, one ``nvcc`` each.

Every library links ``libcuda`` (``NVCC_LIBS``): the bf16 path of
``flash_attention.cu`` encodes its TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``.

``--use_fast_math`` is deliberately absent: it replaces ``sincosf``,
``log1pf`` and ``tanf`` by approximations, and Cauchy draws give phases of
any size that need ``sincosf``'s accurate large-argument reduction.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero value.  There is no fallback: a missing ``nvcc`` or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("prng", "rff", "rff_gram_stream_fused", "centered_gram", "quantize", "segment_reduce",
           "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_LIBS = ("-lcuda",)  # after the source, so the linker keeps it

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"{name}-{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *NVCC_LIBS]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        ptxas_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def ptxas(name: str) -> str:
    """The ptxas report (registers, spills) of the library ``name``: from
    this process's build, or from a compile into a temporary file when the
    library was built before."""
    out = ptxas_log.get(name)
    if out is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{name}-{os.getpid()}.ptxas.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *NVCC_LIBS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        tmp.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
        out = ptxas_log[name] = proc.stdout
    return out


def sass(name: str) -> str:
    """The SASS of the library ``name`` (``cuobjdump -sass``, beside nvcc)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(_lib_path(name))], capture_output=True,
                          text=True, check=True).stdout


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


VP = ctypes.c_void_p
I32 = ctypes.c_int
U32 = ctypes.c_uint32
I64 = ctypes.c_int64
F32 = ctypes.c_float


def fn(lib_name: str, sym: str, argtypes: list) -> ctypes._CFuncPtr:
    """A typed C entry point; every one returns ``int`` (a cudaError_t)."""
    f = getattr(load(lib_name), sym)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream

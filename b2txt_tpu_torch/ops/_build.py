"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (``nvcc -shared``, no PyTorch headers, so a build takes
seconds). The library lands in ``b2txt_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source builds anew and an
unchanged one loads at once. Nothing is built when a module is imported: the
first wrapper call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float       # 0.0 when an existing library was loaded
    ptxas_report: str    # nvcc's -Xptxas -v output (registers, smem, spills)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` (if not built yet) and load it. The build is
    keyed by the source, the shared headers ``csrc/*.cuh`` and the flags."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    report_path = lib_path.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not lib_path.exists():
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        report_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)  # atomic: concurrent builders never load half a file
    report = report_path.read_text() if report_path.exists() else ""
    return Built(ctypes.CDLL(str(lib_path)), lib_path, seconds, report)


def _declare(built: Built, fn_name: str, n_pointers: int, n_ints: int,
             n_floats: int = 0) -> Built:
    """Declare ``fn_name(n_pointers pointers, n_ints ints, n_floats floats,
    stream) -> int`` and the library's error-string function."""
    fn = getattr(built.lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = built.lib.b2t_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


@functools.lru_cache(maxsize=None)
def gru_fwd_library() -> Built:
    """K1, ``csrc/gru_fwd.cu``, with its C signature declared."""
    return _declare(build("gru_fwd.cu"), "b2t_gru_fwd", 6, 4)


@functools.lru_cache(maxsize=None)
def gru_bwd_library() -> Built:
    """K2, ``csrc/gru_bwd.cu``, with its C signature declared."""
    return _declare(build("gru_bwd.cu"), "b2t_gru_bwd", 11, 4)


@functools.lru_cache(maxsize=None)
def row_gather_library() -> Built:
    """K4, ``csrc/row_gather.cu``, with its C signature declared."""
    return _declare(build("row_gather.cu"), "b2t_row_gather", 3, 3)


@functools.lru_cache(maxsize=None)
def preprocess_library() -> Built:
    """K3, ``csrc/preprocess.cu``, with its C signature declared."""
    return _declare(build("preprocess.cu"), "b2t_preprocess", 5, 10, 3)


@functools.lru_cache(maxsize=None)
def moe_grouped_library() -> Built:
    """K5, ``csrc/moe_grouped.cu``, with its C signature declared."""
    return _declare(build("moe_grouped.cu"), "b2t_moe_experts", 8, 6)


@functools.lru_cache(maxsize=None)
def beam_step_library() -> Built:
    """K6, ``csrc/beam_step.cu``, with its C signatures declared."""
    built = _declare(build("beam_step.cu"), "b2t_beam_step", 22, 17, 5)
    for name in ("b2t_beam_step_smem", "b2t_beam_step_fixed", "b2t_beam_step_work"):
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
    return built

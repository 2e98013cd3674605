"""Build, load and launch the port's hand-written Hopper kernels.

The CUDA C++ sources under ``csrc/`` expose a plain C interface.  At first use
they are compiled by ``nvcc`` for ``sm_90a`` into one shared library,
``build/torch_kernels/libcoda_torch_kernels.so`` at the root of the checkout,
and loaded with ``ctypes``.  The build runs again whenever a hash of the
sources and flags changes.  A failed build or load raises: there is no
fallback to the plain PyTorch versions.

Each C entry point takes device pointers, sizes and PyTorch's current stream,
launches its kernel, and returns ``cudaGetLastError()``; ``launch`` raises
when that is not 0 and counts the launch in ``LAUNCHES``.  ``LAUNCHES`` is
the only place a kernel launch is counted, so a run can show that its main
path went through every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libcoda_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"fps": 0, "ball_query": 0, "gather": 0, "attention": 0, "vit_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> (kernel name, argument types after the pointers' values)
_SIGNATURES = {
    "coda_fps": ("fps", [_P, _P, _I, _I, _I, _P]),
    "coda_ball_query": ("ball_query", [_P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "coda_gather": ("gather", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "coda_attention": (
        "attention", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    ),
    "coda_vit_attention": ("vit_attention", [_P, _P, _P, _P, _I, _I, _I, _F, _P]),
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def build() -> Path:
    """Compile csrc/*.cu into LIBRARY unless a build of the same sources exists."""
    digest = _source_hash()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = tmp.name
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp_path, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}); log in {BUILD_DIR / 'build.log'}:\n"
            + proc.stderr[-4000:]
        )
    os.replace(tmp_path, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (_, argtypes) in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.coda_fps_max_points.argtypes = []
            lib.coda_fps_max_points.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(fn: str, *args) -> None:
    """Call C entry point `fn` with `args` on the current stream; raise on error.

    Tensors in `args` are passed as their data pointers; the caller keeps them
    alive and has checked device, dtype, shape and contiguity.
    """
    name, _ = _SIGNATURES[fn]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = getattr(library(), fn)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def check_cuda_inference(*tensors: torch.Tensor) -> None:
    """Kernels are forward only: refuse inputs that would need a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA kernels are inference only; run under torch.inference_mode()"
        )

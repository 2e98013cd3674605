"""Build, load and launch the port's hand-written Hopper kernels.

The CUDA C++ sources under ``csrc/`` expose a plain C interface.  At first use
they are compiled by ``nvcc`` for ``sm_90a``, one process a source, all at
once, and linked into one shared library,
``build/torch_kernels/libcoda_torch_kernels.so`` at the root of the checkout,
and loaded with ``ctypes``.  The build runs again whenever a hash of the
sources and flags changes, under the inter-process file lock of
``native.build_lock``: ranks that start at once run one nvcc build between
them, and the others load its library.  A failed build or load raises: there is no
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

from coda_neurips2023_tpu_torch.native import build_lock, is_current

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libcoda_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"fps": 0, "ball_query": 0, "gather": 0, "attention": 0, "vit_attention": 0,
            "ball_query_group": 0, "ball_query_tile": 0, "attention_bf16": 0,
            "vit_attention_bf16": 0, "crop": 0, "tower_gemm": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# C entry point -> (kernel name, argument types after the pointers' values)
_SIGNATURES = {
    "coda_fps": ("fps", [_P, _P, _I, _I, _I, _I, _P]),
    # kernel B's grid build (counted under "ball_query", or under
    # "ball_query_group" or "ball_query_tile" where kernel F's or G's wrapper
    # launches it) and query
    "coda_bq_grid_cells": ("ball_query", [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
    "coda_bq_grid_pack": ("ball_query", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "coda_ball_query": ("ball_query", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]),
    "coda_gather": ("gather", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "coda_attention": (
        "attention", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _I, _P]
    ),
    # kernel D's second launch when it splits the keys: counted under
    # "attention", or under "attention_bf16" where kernel D-bf16's wrapper
    # launches it
    "coda_attention_combine": ("attention", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "coda_attention_bf16": (
        "attention_bf16",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _U, _F, _I, _I, _I, _P],
    ),
    "coda_vit_attention": ("vit_attention", [_P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "coda_vit_attention_bf16": ("vit_attention_bf16", [_P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "coda_ball_query_group": (
        "ball_query_group", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
    ),
    "coda_ball_query_tile": (
        "ball_query_tile", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]
    ),
    "coda_crop": ("crop", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "coda_tower_gemm": ("tower_gemm", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_lib = None
_entry_points = {}  # C entry point -> its ctypes function


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
    if is_current(LIBRARY, digest):
        return LIBRARY
    with build_lock(BUILD_DIR):
        if not is_current(LIBRARY, digest):  # another process may have built it meanwhile
            _compile(digest)
    return LIBRARY


def _compile(digest: str) -> None:
    with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = tmp.name
    nvcc = _nvcc()
    # one nvcc a source, all at once, then one link
    units = [p for p in _sources() if p.suffix == ".cu"]
    objects = [BUILD_DIR / (p.name + ".o") for p in units]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(units, objects)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_path, *map(str, objects)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        cmds.append(link)
        outputs.append(proc.stdout)
        if proc.returncode != 0:
            failed.append(link)
    (BUILD_DIR / "build.log").write_text(
        "".join(" ".join(c) + "\n" + out for c, out in zip(cmds, outputs))
    )
    if failed:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"nvcc failed on {' '.join(failed[0])}; log in {BUILD_DIR / 'build.log'}:\n"
            + outputs[cmds.index(failed[0])][-4000:]
        )
    os.replace(tmp_path, LIBRARY)
    LIBRARY.with_suffix(".so.sha256").write_text(digest)


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
            # a timing of kernel A's loop without its work, launched by
            # measurement scripts through the library, never counted
            lib.coda_fps_barrier_floor.argtypes = _SIGNATURES["coda_fps"][1]
            lib.coda_fps_barrier_floor.restype = ctypes.c_int
            lib.coda_fps_resident_clusters.argtypes = [ctypes.c_int]
            lib.coda_fps_resident_clusters.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(fn: str, *args, count_as: str | None = None) -> None:
    """Call C entry point `fn` with `args` on the current stream; raise on error.

    Tensors in `args` are passed as their data pointers (None as a null
    pointer); the caller keeps them alive and has checked device, dtype,
    shape and contiguity.  The launch counts under `count_as`, by default
    the entry point's kernel name.
    """
    name = count_as or _SIGNATURES[fn][0]
    entry = _entry_points.get(fn)
    if entry is None:
        entry = _entry_points.setdefault(fn, getattr(library(), fn))
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = entry(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Refuse inputs that would need a gradient, for kernels without a
    backward (A, B, E, F, G, H, E-bf16, the crops: point coordinates, images
    and the frozen CLIP tower take none).  Kernels C, D and D-bf16 have one,
    through their autograd Functions."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; its inputs must not require grad")

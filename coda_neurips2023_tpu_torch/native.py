"""ctypes binding of the port's host library (csrc/host/coda_native.cpp).

Counterpart of coda_neurips2023_tpu/native.py, for the functions the AP
stack calls: `nms_3d_samecls` (utils/ap_calculator.py) and
`box3d_iou_eval_batch` (utils/eval_det.py; in C it clips the footprints
with `clip_area_eval_cpu`).

The library is built with g++ at first use into
``build/torch_kernels/libcoda_native_host.so`` at the root of the checkout
(the kernels' build directory, which git ignores), and built again when a
hash of the source and flags changes.  The build writes a temporary file and
renames it, so no process loads a half-written library, and it runs under
`build_lock`, an inter-process file lock in the build directory, so
processes that need the library at once (ranks, AP workers, test workers)
run one build between them and the others load its result.  The JAX package's ``native/libcoda_native.so``
is never read or written.  Without g++ `available()` is False and the
callers take their numpy versions.  This module imports numpy only, so the
AP worker processes never import torch.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "host" / "coda_native.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libcoda_native_host.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_failed = False


@contextlib.contextmanager
def build_lock(build_dir: Path):
    """Hold an exclusive lock on <build_dir>/.build.lock (fcntl.flock): one
    process at a time checks a build's stamp, compiles and renames its
    output; the others wait here and then find the stamp current."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def is_current(library: Path, digest: str) -> bool:
    """Whether `library` exists beside a stamp holding `digest`."""
    stamp = library.with_suffix(".so.sha256")
    return library.exists() and stamp.exists() and stamp.read_text() == digest


def build() -> Path:
    """Compile SOURCE into LIBRARY unless a build of the same source exists."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()
    if is_current(LIBRARY, digest):
        return LIBRARY
    with build_lock(BUILD_DIR):
        if is_current(LIBRARY, digest):  # another process built it while this one waited
            return LIBRARY
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], check=True,
                           capture_output=True)
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, LIBRARY)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".sha256")
        with os.fdopen(fd, "w") as f:
            f.write(digest)
        os.replace(tmp, LIBRARY.with_suffix(".so.sha256"))
    return LIBRARY


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when g++ is missing or fails."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        path = build()
    except (subprocess.CalledProcessError, FileNotFoundError):
        _failed = True
        return None
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.nms_3d_samecls_cpu.argtypes = [f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int, i32p]
    lib.nms_3d_samecls_cpu.restype = ctypes.c_int
    lib.box3d_iou_eval_cpu.argtypes = [f32p, f32p, ctypes.c_int, f64p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def box3d_iou_eval_batch(bb: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Eval-path rotated 3D IoU of one (8, 3) box against (M, 8, 3) boxes."""
    bb = np.ascontiguousarray(bb, np.float32)
    gts = np.ascontiguousarray(gts, np.float32)
    out = np.zeros((gts.shape[0],), np.float64)
    get_lib().box3d_iou_eval_cpu(bb, gts, gts.shape[0], out)
    return out


def nms_3d_samecls(boxes: np.ndarray, thresh: float, old_type: bool = False) -> np.ndarray:
    """(K, 8) [x1, y1, z1, x2, y2, z2, score, cls] -> the kept rows' indices, ascending."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    keep = np.zeros((boxes.shape[0],), np.int32)
    get_lib().nms_3d_samecls_cpu(boxes, boxes.shape[0], thresh, int(old_type), keep)
    return np.where(keep)[0]

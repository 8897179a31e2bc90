"""The C++ LBVH construction (csrc/lbvh.cpp of the repository), built
with g++ at first use into build/rtxpt_tpu_torch/ of the checkout and
bound with ctypes (counterpart of rtxpt_tpu/accel/native.py).

Unlike the JAX package's binding, this one never falls back: a missing
compiler, a failed build or an error of the C++ code raises
RuntimeError. Callers that want the numpy version ask for it
(`lbvh.build_bvh(..., use_native=False)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from rtxpt_tpu_torch.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "lbvh.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not SOURCE.exists():
        raise RuntimeError(f"the LBVH source {SOURCE} is missing")
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"librtxpt_lbvh_{tag}.so"
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build the LBVH "
                               "library")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp.so"
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the LBVH library failed:\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.rtxpt_build_lbvh.restype = ctypes.c_int
    lib.rtxpt_build_lbvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return lib


def build_packed_native(positions: np.ndarray, indices: np.ndarray):
    """Run the C++ LBVH code: (packed nodes [2T-1, 17] f32, prim_tri [T] i32
    leaf -> original triangle)."""
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    n = len(indices)
    nodes = np.empty((2 * n - 1, 17), np.float32)
    prim_tri = np.empty((n,), np.int32)
    rc = lib.rtxpt_build_lbvh(
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(positions),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        prim_tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"the C++ LBVH failed (code {rc}) on {n} "
                           f"triangles")
    return nodes, prim_tri

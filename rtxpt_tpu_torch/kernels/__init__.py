"""Build-and-bind layer for the hand-written CUDA kernels.

Each kernel library is compiled from `rtxpt_tpu_torch/csrc/` with nvcc
into a shared library with a plain C interface, at first use, under
`build/rtxpt_tpu_torch/` of the checkout, and bound with ctypes. Nothing
here runs at import: the module imports on a machine without nvcc or a
GPU, and only `CudaLibrary.load()` needs them.

Build flags: sm_90a (Hopper), -O3, no --use_fast_math, and -fmad=false so
that the kernels round every multiply and add the way the plain PyTorch
versions do (the parity switch; see PERF.md for its cost).

`launches` counts kernel launches by name; each wrapper adds one where it
launches its kernel, so a run can show which kernels its path went
through. An instanced variant counts under its own name
("cluster_closest_inst", "cluster_shadow_inst"), and so do the shading
kernels' texture and environment variants ("bounce_fused_tex",
"bounce_fused_env", "bounce_fused_tex_env", "bounce_fused_final", and the
same for "cluster_shade": bounce_fused.variant_name), and so do the
micromap variants ("bounce_fused_omm_tex", "shadow_occlusion_omm",
"cluster_closest_omm", "cluster_shade_omm_tex", "cluster_shadow_omm",
"bvh_traverse_omm"), and so do the nested-priority variants of the shading
kernels ("bounce_fused_prio", "bounce_fused_omm_tex_prio",
"cluster_shade_omm_tex_prio" and so on), and so do their split-channel
variants ("bounce_fused_split", "bounce_fused_tex_split_env",
"bounce_fused_final_split", "cluster_shade_split" and so on), and so do
K1's restart instantiations ("bounce_fused_inj", "bounce_fused_inj_split"
and so on: bounce 0 of a stable-planes fill; "bounce_fused_nodirect..."
for the later bounces of a first_direct=False fill), and so do
the per-row kernels
K6 and K7 ("cluster_rows_closest_shade" with its "_env", "_tex",
"_tex_env" and "_final" variants, "cluster_rows_shadow"), and so do the
probes K10-K12 ("probe_cluster", "probe_flat", and one
"probe_constructs_<name>" for each of the seven constructs). `build_all()`
builds every library at once, one nvcc process per source.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rtxpt_tpu_torch"

DEFAULT_CUDA_HOME = "/usr/local/cuda"   # the CUDA toolkit's install prefix

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


def check_tensor(name, x, dtype, shape, device):
    """Raise unless x is a contiguous tensor of `dtype` and `shape` on
    `device`: what a kernel's C interface takes."""
    import torch

    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def find_cuobjdump() -> str:
    """cuobjdump beside nvcc; raises when there is none."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    return str(tool)


def find_nvcc() -> str:
    """nvcc from PATH or the CUDA toolkit; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One shared library built from csrc/ sources and bound with ctypes.

    `functions` maps each C entry point to its ctypes argtypes; every
    entry returns a cudaError_t as int (0 = success)."""

    def __init__(self, name: str, sources, functions: dict):
        self.name = name
        self.sources = list(sources)
        self.functions = functions
        self._lib = None
        self.build_seconds = None
        self.ptxas_log = ""
        self.path = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC.glob("*.cu*")):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    def load(self) -> ctypes.CDLL:
        """Build (unless an up-to-date build exists) and bind the library."""
        if self._lib is not None:
            return self._lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"lib{self.name}_{self._digest()}"
        so = BUILD_DIR / f"{stem}.so"
        log = BUILD_DIR / f"{stem}.ptxas.txt"
        t0 = time.perf_counter()
        if not so.exists():
            tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(CSRC / s) for s in self.sources]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.name}:\n"
                                   f"{res.stdout}\n{res.stderr}")
            log.write_text(res.stdout + res.stderr)
            os.replace(tmp, so)
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = log.read_text() if log.exists() else ""
        self.path = so
        lib = ctypes.CDLL(str(so))
        for fname, argtypes in self.functions.items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = _I
        err = lib.rtxpt_error_string
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def sass_opcodes(self, opcodes) -> dict:
        """{kernel (mangled name): {opcode: count}} of the instructions
        with one of `opcodes` (`count_sass`), from cuobjdump -sass of the
        built library (built first if need be)."""
        self.load()
        sass = subprocess.run([find_cuobjdump(), "-sass", str(self.path)],
                              capture_output=True, text=True, check=True)
        return count_sass(sass.stdout, opcodes)

    def launch(self, fname: str, *args) -> None:
        """Call one entry point; raise if it reports a CUDA error."""
        lib = self.load()
        rc = getattr(lib, fname)(*args)
        if rc != 0:
            msg = lib.rtxpt_error_string(rc).decode()
            raise RuntimeError(f"{fname}: CUDA error {rc} ({msg})")


# K1: the fused bounce kernel (replaces rtxpt_tpu/pt/bounce_pallas.py
# _bounce_kernel); wrapper in pt/bounce_fused.py.
BOUNCE_FUSED = CudaLibrary(
    "bounce_fused", ["bounce_fused.cu"],
    {"rtxpt_bounce_fused": [
        _P, _P, _P, _P, _P,            # fs, is_, fs_out, is_out, hit_out
        _P,                            # surf_out (external modes) | NULL
        _P, _P,                        # fs2, fs2_out (split) | NULL
        _P, _P, _P, _P,                # tri_coef, attr, mat, light rows
        _P,                            # env table | NULL
        _P, _P, _I, _I,                # tex | NULL, tex_meta, n_tex,
        #                                tex_maps
        _P, _P,                        # micromap words, covers | NULL
        _P, _P, _I,                    # coefficient tile, scales, T8
        _I, _I, _I, _I,                # n, n_tris, tpad, n_lights
        _U,                            # sample_idx
        _I, _I, _F, _I, _I, _F,        # nee_mode, mis, firefly, rr, min_rr,
        #                                max_travel
        _I, _I, _I,                    # low_discrepancy, energy_comp, maxb
        _I, _I,                        # final_env, prio
        _P],                           # cudaStream_t
     "rtxpt_bounce_fused_screen_stats": [
        _I, _P]})                      # enable, 6 host u64 | NULL

# K1's real-time fill (the same TPU kernel with inject / first_direct=False):
# the V-buffer restart, a library of its own; wrapper bounce_fused.bounce.
BOUNCE_FUSED_RESTART = CudaLibrary(
    "bounce_fused_restart", ["bounce_fused_restart.cu"],
    {"rtxpt_bounce_fused_restart": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # K1's state, hit, surf, fs2 rows
        _P, _P, _P, _P, _P,            # tri_coef, attr, mat, light, env
        _P, _P, _I, _I, _P, _P,        # textures, micromaps
        _P, _P, _I,                    # coefficient tile, scales, T8
        _I, _I, _I, _I, _U,            # n, n_tris, tpad, n_lights, sample
        _I, _I, _F, _I, _I, _F,        # nee_mode, mis, firefly, rr, min_rr,
        #                                max_travel
        _I, _I, _I, _I,                # low_discrepancy, energy_comp, maxb,
        #                                prio
        _P, _I,                        # injected V-buffer rows | NULL,
        #                                first_direct
        _P],                           # cudaStream_t
     "rtxpt_bounce_fused_restart_screen_stats": [
        _I, _P]})                      # enable, 6 host u64 | NULL

# K1's 32 entry functions by launch name (a part of each mangled name):
# the switches (texture, micromaps, priorities, split) of the reference-mode
# kernel and of the restart's, as bounce_fused.variant_name names them
# (the environment variants share the instantiations)
BOUNCE_FUSED_ENTRIES = {
    ("bounce_fused" + restart + ("_omm" if omm else "")
     + ("_tex" if tex else "") + ("_prio" if prio else "")
     + ("_split" if split else "")):
    f"bounce_fused{kernel}_kernelILb{tex:d}ELb{omm:d}ELb{prio:d}ELb{split:d}E"
    for restart, kernel in (("", ""), ("_inj", "_restart"))
    for tex in (False, True) for omm in (False, True)
    for prio in (False, True) for split in (False, True)}

# K2: the shadow any-hit kernel of external NEE (replaces rtxpt_tpu/pt/
# bounce_pallas.py _shadow_kernel); wrapper bounce_fused.occlusion.
SHADOW_OCCLUSION = CudaLibrary(
    "shadow_occlusion", ["shadow_occlusion.cu"],
    {"rtxpt_shadow_occlusion": [
        _P, _P, _P, _P,                # sh, occ, tests|NULL, tri_coef
        _P, _P,                        # micromap words, covers | NULL
        _P, _P, _I,                    # tri_tile, tri_scale, t8
        _I, _I,                        # n, n_tris
        _P],                           # cudaStream_t
     "rtxpt_shadow_occlusion_screen_stats": [_I, _P]})
# K2's two instantiations of the tensor-core screen (SASS check)
SHADOW_OCCLUSION_ENTRIES = {
    "shadow_occlusion": "shadow_occlusion_kernelILb0E",
    "shadow_occlusion_omm": "shadow_occlusion_kernelILb1E"}

# K3: the clustered closest-hit kernel (replaces rtxpt_tpu/pt/
# bounce_clustered.py _kernel_a1, flat and instanced); wrapper
# bounce_clustered.closest_hit.
CLUSTER_CLOSEST = CudaLibrary(
    "cluster_closest", ["cluster_closest.cu"],
    {"rtxpt_cluster_closest": [
        _P, _P, _P,                    # cand, od, blocks
        _P,                            # micromap words | NULL
        _P, _P,                        # ha, visits|NULL
        _I, _I, _F, _I,                # n_groups, kslots, max_travel, noprune
        _P],                           # cudaStream_t
     "rtxpt_cluster_closest_inst": [
        _P, _P, _P, _P,                # cand, od, blocks, xf
        _P, _P,                        # ha, visits|NULL
        _I, _I, _F, _I,                # n_groups, kslots, max_travel, noprune
        _P]})                          # cudaStream_t

# K3's entry functions by launch name (a part of each mangled name)
CLUSTER_CLOSEST_ENTRIES = {
    "cluster_closest": "cluster_closest_kernelILb0ELb0E",
    "cluster_closest_omm": "cluster_closest_kernelILb0ELb1E",
    "cluster_closest_inst": "cluster_closest_kernelILb1ELb0E"}
# the tensor cores' instructions: mma.sync (HMMA) and wgmma (HGMMA)
TENSOR_OPCODES = ("HMMA", "HGMMA")

# K4: the clustered shading kernel (replaces _kernel_a2); wrapper
# bounce_clustered.shade.
CLUSTER_SHADE = CudaLibrary(
    "cluster_shade", ["cluster_shade.cu"],
    {"rtxpt_cluster_shade": [
        _P, _P, _P, _P, _P, _P, _P,    # ha, fs, is_, fs_out, is_out, sh, hit
        _P,                            # surf_out (external modes) | NULL
        _P, _P,                        # fs2, fs2_out (split) | NULL
        _P, _P, _P,                    # mat, light rows, env table | NULL
        _P, _P, _I, _I,                # tex | NULL, tex_meta, n_tex,
        #                                tex_maps
        _I, _I,                        # omm, prio
        _I, _I, _U,                    # n, n_lights, sample_idx
        _I, _I, _F, _I, _I,            # nee_mode, mis, firefly, rr, min_rr
        _I, _I, _I,                    # low_discrepancy, energy_comp, maxb
        _I,                            # final_env
        _P]})                          # cudaStream_t

# K4's sixteen instantiations (ptxas report): tex, omm, prio, split
CLUSTER_SHADE_ENTRIES = {
    "cluster_shade" + "_omm" * o + "_tex" * t + "_prio" * p + "_split" * s:
    f"cluster_shade_kernelILb{t:d}ELb{o:d}ELb{p:d}ELb{s:d}E"
    for t in (False, True) for o in (False, True)
    for p in (False, True) for s in (False, True)}

# K5: the clustered shadow any-hit kernel (replaces _kernel_b1 and
# _kernel_b1_inst); wrapper bounce_clustered.occlusion; its screen counters
# bounce_clustered.occlusion_screen_stats.
CLUSTER_SHADOW = CudaLibrary(
    "cluster_shadow", ["cluster_shadow.cu"],
    {"rtxpt_cluster_shadow": [
        _P, _P, _P,                    # cand, sh, blocks
        _P, _P,                        # micromap words, covers | NULL
        _P, _P,                        # occ, tests|NULL
        _I, _I,                        # n_groups, kslots
        _P],                           # cudaStream_t
     "rtxpt_cluster_shadow_inst": [
        _P, _P, _P, _P,                # cand, sh, blocks, xf
        _P, _P,                        # occ, tests|NULL
        _I, _I,                        # n_groups, kslots
        _P],                           # cudaStream_t
     "rtxpt_cluster_shadow_screen_stats": [
        _I, _P]})                      # enable, 3 host u64 | NULL

# K5's entry functions by launch name (a part of each mangled name)
CLUSTER_SHADOW_ENTRIES = {
    "cluster_shadow": "cluster_shadow_kernelILb0ELb0E",
    "cluster_shadow_omm": "cluster_shadow_kernelILb0ELb1E",
    "cluster_shadow_inst": "cluster_shadow_kernelILb1ELb0E"}

# K6 and K7: the per-row clustered kernels (replace rtxpt_tpu/pt/
# bounce_clustered.py _kernel_a, closest hit and shading in one kernel,
# and _kernel_b, per-row shadow any-hit); wrappers
# bounce_clustered.closest_shade and occlusion_rows; their screen counters
# bounce_clustered.rows_screen_stats.
CLUSTER_ROWS = CudaLibrary(
    "cluster_rows", ["cluster_rows.cu"],
    {"rtxpt_cluster_rows_closest_shade": [
        _P, _P, _P,                    # cand, fs, is_
        _P, _P, _P, _P,                # fs_out, is_out, sh, hit
        _P,                            # visited | NULL
        _P, _P, _P, _P,                # blocks, mat, light, env | NULL
        _P, _P, _I, _I,                # tex | NULL, tex_meta, n_tex,
        #                                tex_maps
        _I, _I, _F, _I,                # n_groups, kslots, max_travel, noprune
        _I, _U,                        # n_lights, sample_idx
        _I, _I, _F, _I, _I,            # nee_mode, mis, firefly, rr, min_rr
        _I, _I, _I,                    # low_discrepancy, energy_comp, maxb
        _I,                            # final_env
        _P],                           # cudaStream_t
     "rtxpt_cluster_rows_shadow": [
        _P, _P, _P,                    # cand, sh, blocks
        _P, _P,                        # occ, tests | NULL
        _I, _I,                        # n_groups, kslots
        _P],                           # cudaStream_t
     "rtxpt_cluster_rows_screen_stats": [
        _I, _P]})                      # enable, 6 host u64 | NULL

# K6's and K7's entry functions by launch name (a part of each mangled
# name); K6's environment and final variants share the instantiations
CLUSTER_ROWS_ENTRIES = {
    "cluster_rows_closest_shade": "closest_shade_kernelILb0EE",
    "cluster_rows_closest_shade_tex": "closest_shade_kernelILb1EE",
    "cluster_rows_shadow": "shadow_rows_kernel"}

# K8: the brute-force closest hit of the general tier (replaces rtxpt_tpu/
# accel/brute_pallas.py _kernel); wrapper accel/brute.py closest.
BRUTE_CLOSEST = CudaLibrary(
    "brute_closest", ["brute_closest.cu"],
    {"rtxpt_brute_closest": [
        _P, _P, _P, _P, _P,            # o, d, tmin, tmax, table
        _P, _P, _I,                    # tile, scale | NULL, t8
        _P, _P, _P, _P,                # t, prim, uv, front
        _I, _I,                        # n, n_tris
        _P],                           # cudaStream_t
     "rtxpt_brute_closest_screen_stats": [_I, _P]})
# K8's two routes' kernels (ptxas report, SASS check)
BRUTE_CLOSEST_ENTRIES = {
    "brute_closest": "brute_closest_kernelILb0E",
    "brute_closest_mma": "brute_closest_kernel_mmaILb0E"}

# K9: the BVH walk of the general tier (replaces rtxpt_tpu/accel/
# traverse_pallas.py _step_kernel); wrapper accel/traverse.py walk.
BVH_TRAVERSE = CudaLibrary(
    "bvh_traverse", ["bvh_traverse.cu"],
    {"rtxpt_bvh_traverse": [
        _P, _P, _P, _P, _P, _P,        # o, d, tmin, tmax, wide, wide_tris
        _P,                            # micromap words | NULL
        _P, _P, _P, _P,                # t, prim, uv, front
        _P, _P,                        # visits|NULL, tests|NULL
        _I, _I,                        # n, any_hit
        _P]})                          # cudaStream_t

# K9's four instantiations: closest-hit and any-hit, each without and with
# micromaps (ptxas report)
BVH_TRAVERSE_ENTRIES = {
    "bvh_traverse" + ("_any" if a else "") + ("_omm" if m else ""):
    f"bvh_traverse_kernelILb{a:d}ELb{m:d}E"
    for a in (False, True) for m in (False, True)}

# K10: the cluster-visit probe (replaces scripts/micro_cluster_kernel.py
# kernel); wrapper probes/micro_cluster_kernel.py run.
PROBE_CLUSTER = CudaLibrary(
    "probe_cluster", ["probe_cluster.cu"],
    {"rtxpt_probe_cluster": [
        _P, _P, _P, _P,                # counts, cands, cols, tris
        _P,                            # best [G, 8, 128]
        _I,                            # n_groups
        _P]})                          # cudaStream_t

# K11: the all-rows flat-lane probe (replaces scripts/micro_flat_kernel.py
# kernel); wrapper probes/micro_flat_kernel.py run.
PROBE_FLAT = CudaLibrary(
    "probe_flat", ["probe_flat.cu"],
    {"rtxpt_probe_flat": [
        _P, _P, _P,                    # cand, od, blocks
        _P, _P,                        # t, prim
        _I,                            # n_groups
        _P]})                          # cudaStream_t

# K12: the seven construct probes (replace scripts/micro_constructs.py
# kernel); wrapper probes/micro_constructs.py run, counted as
# "probe_constructs_<name>".
PROBE_CONSTRUCTS = CudaLibrary(
    "probe_constructs", ["probe_constructs.cu"],
    {"rtxpt_probe_tile8": [_P, _P, _P, _P],            # x, b, o, stream
     "rtxpt_probe_subl_concat": [_P, _P, _P, _P],
     "rtxpt_probe_mm_concat": [_P, _P, _P, _I, _P],    # ..., n, stream
     "rtxpt_probe_unflat": [_P, _P, _P, _P],
     "rtxpt_probe_scratch32": [_P, _P, _P, _P, _P],    # x, b, scratch, o
     "rtxpt_probe_iota_sel": [_P, _P, _P, _I, _I, _P]})  # ..., strides

_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)")


def count_sass(text: str, opcodes) -> dict:
    """{function: {opcode: count}} of a cuobjdump -sass listing: the
    instructions whose opcode (the mnemonic before its first '.') is one
    of `opcodes`, for every function of the listing."""
    out = {}
    current = None
    for line in text.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
            continue
        m = _SASS_OPCODE.search(line)
        if m and current is not None:
            for op in opcodes:
                if m.group(1).split(".")[0] == op:
                    current[op] += 1
    return out


LIBRARIES = (BOUNCE_FUSED, BOUNCE_FUSED_RESTART, SHADOW_OCCLUSION,
             CLUSTER_CLOSEST, CLUSTER_SHADE, CLUSTER_SHADOW, CLUSTER_ROWS,
             BRUTE_CLOSEST, BVH_TRAVERSE, PROBE_CLUSTER, PROBE_FLAT,
             PROBE_CONSTRUCTS)


def build_all(libraries=LIBRARIES) -> dict:
    """Build and bind every library, one nvcc process per source, all
    started together; returns {name: seconds} and raises the first build
    error."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    wall = time.perf_counter() - t0
    return dict({lib.name: lib.build_seconds for lib in libraries},
                wall=wall)

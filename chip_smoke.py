#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtxpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repository root, one GPU
    python3 chip_smoke.py --record out.json # also write every phase's details

Phases, one line of output each:

  1. device  -- card name and power limit (nvidia-smi), torch and CUDA
                versions; TF32 off.
  2. build   -- compiles every CUDA kernel of the main path from
                rtxpt_tpu_torch/csrc with nvcc; seconds, registers, spills.
  3. k1      -- one launch of the fused bounce kernel (K1) against its plain
                PyTorch version on the same 65,536 Cornell camera rays, at
                bounce 0 and at bounce 2 (Russian roulette on): integer rows
                and prim ids equal on >= 99.9% of lanes, every float row
                within rtol = atol = 2e-3 on >= 99.9% of lanes, image-mean
                radiance within 1e-3 relative. Times both at the main path's
                2^18 rays per launch.
  4. golden  -- Cornell 32x32, 8 spp, 3 bounces through the kernel against
                tests/goldens/cornell_32_8spp.npy: RMSE < 5e-3, PSNR > 40.
  5. main    -- the main path: Cornell 1920x1080, 4 bounces, power NEE,
                2^18 rays per chunk, 1 warm-up and 4 timed samples through
                rtxpt_tpu_torch.pt.integrator.render_sample; K1 must launch
                chunks x bounces x spp times, the image must be finite.

The line before the last holds {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed phase, a missing GPU or a missing
package exits non-zero without those lines. Imports nothing of JAX.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback

RAYS_K1 = 1 << 16            # phase 3 comparison width
RAYS_TIMED = 1 << 18         # the main path's rays per launch
TOL = 2e-3
LANE_FRACTION = 0.999
MEAN_RTOL = 1e-3


def _fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def _cuda_ms(fn, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()                                   # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _ptxas_summary(log):
    regs = re.findall(r"Used (\d+) registers", log)
    spill_st = re.findall(r"(\d+) bytes spill stores", log)
    spill_ld = re.findall(r"(\d+) bytes spill loads", log)
    return dict(registers=max(map(int, regs)) if regs else None,
                spill_store_bytes=max(map(int, spill_st)) if spill_st else None,
                spill_load_bytes=max(map(int, spill_ld)) if spill_ld else None)


def _compare(kernel_out, plain_out):
    """Lane agreement of one bounce: (summary dict, max_abs_err)."""
    import torch
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    (kf, ki, kh), (pf, pi, ph) = kernel_out, plain_out
    int_eq = (ki == pi).all(0) & (kh[1] == ph[1])
    rows = {}
    max_err = 0.0
    for name, k, p in (("fs", kf, pf), ("hit", kh, ph)):
        for r in range(k.shape[0]):
            ok = torch.isclose(k[r], p[r], rtol=TOL, atol=TOL, equal_nan=True)
            rows[f"{name}{r}"] = float(ok.float().mean())
            both = int_eq & torch.isfinite(k[r]) & torch.isfinite(p[r])
            if both.any():
                max_err = max(max_err, float((k[r] - p[r])[both].abs().max()))
    lk = kf[bf.FS_L:bf.FS_L + 3]
    lp = pf[bf.FS_L:bf.FS_L + 3]
    mean_k, mean_p = float(lk.mean()), float(lp.mean())
    return dict(int_lanes_equal=float(int_eq.float().mean()),
                worst_float_row=min(rows.values()), float_rows=rows,
                L_mean_kernel=mean_k, L_mean_plain=mean_p,
                L_mean_rel=abs(mean_k - mean_p) / max(abs(mean_p), 1e-30),
                max_abs_err=max_err), max_err


def main(record_path=None):
    import torch

    record = {}

    def dump():
        if record_path:
            _write_record(record, record_path)
    if not torch.cuda.is_available():
        _fail("device: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU")

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    record["device"] = dict(nvidia_smi=smi, torch=torch.__version__,
                            cuda=torch.version.cuda, name=kind,
                            count=torch.cuda.device_count())
    print(f"device ok: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render, render_sample)
    from rtxpt_tpu_torch.scene.procedural import cornell_box, default_camera
    from rtxpt_tpu_torch.utils.image import psnr, rmse

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.BOUNCE_FUSED.load()
    build_s = time.perf_counter() - t0
    ptxas = _ptxas_summary(kernels.BOUNCE_FUSED.ptxas_log)
    record["build"] = dict(seconds=build_s, **ptxas,
                           ptxas_log=kernels.BOUNCE_FUSED.ptxas_log)
    print(f"build ok: bounce_fused in {build_s:.1f}s, {ptxas['registers']} "
          f"registers, spill stores {ptxas['spill_store_bytes']} B, spill "
          f"loads {ptxas['spill_load_bytes']} B", flush=True)

    # ---- 3. K1 against its plain version -----------------------------------
    host = cornell_box()
    scene = prepare(host, device=dev)
    tables = scene.bounce_tables
    cfg_k1 = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER)
    kcfg = bf.KernelConfig.from_cfg(cfg_k1)
    side = 256                                     # RAYS_K1 rays
    cam = default_camera(host, side, side, device=dev)
    px, py = _pixel_grid(side, side, dev)
    sample = 1
    o, d, spread = camera_rays(cam, cfg_k1, px, py, sample)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    k1 = {}
    max_err = 0.0
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, tables, kcfg, sample)
        if b in (0, 2):
            kern = bf.bounce(fs, is_, tables, kcfg, sample)
            torch.cuda.synchronize()
            summary, err = _compare(kern, plain)
            max_err = max(max_err, err)
            k1[f"bounce{b}"] = summary
            print(f"k1 bounce {b}: int lanes equal "
                  f"{summary['int_lanes_equal']:.6f}, worst float row "
                  f"{summary['worst_float_row']:.6f}, L mean "
                  f"{summary['L_mean_kernel']:.6f} vs "
                  f"{summary['L_mean_plain']:.6f}, max abs err {err:.3g}",
                  flush=True)
            if summary["int_lanes_equal"] < LANE_FRACTION \
                    or summary["worst_float_row"] < LANE_FRACTION \
                    or summary["L_mean_rel"] > MEAN_RTOL:
                record["k1"] = k1
                dump()
                _fail(f"k1: kernel disagrees with its plain version at "
                      f"bounce {b}")
        fs, is_ = plain[0], plain[1]          # carry the state onward
    # time both at the main path's launch width (2^18 rays, bounce 0)
    side_t = 512                                   # RAYS_TIMED rays
    cam_t = default_camera(host, side_t, side_t, device=dev)
    px_t, py_t = _pixel_grid(side_t, side_t, dev)
    o, d, spread = camera_rays(cam_t, cfg_k1, px_t, py_t, sample)
    fs_t, is_t = bf.initial_state(o, d, spread, px_t, py_t)
    k1_ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tables, kcfg, sample), 20)
    plain_ms = _cuda_ms(
        lambda: bf.bounce_reference(fs_t, is_t, tables, kcfg, sample), 3)
    k1.update(ms=k1_ms, plain_ms=plain_ms, rays=RAYS_TIMED)
    record["k1"] = k1
    print(f"k1 ok: {RAYS_TIMED} rays/launch, kernel {k1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({smi})", flush=True)

    # ---- 4. golden --------------------------------------------------------
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "goldens", "cornell_32_8spp.npy")
    import numpy as np
    golden = np.load(golden_path)
    before = kernels.launches["bounce_fused"]
    cam32 = default_camera(host, 32, 32, device=dev)
    hdr, _, _ = render(scene, cam32, PathTracerConfig(max_bounces=3),
                       32, 32, spp=8)
    img = hdr.cpu().numpy()
    e, p = rmse(img, golden), psnr(img, golden)
    used = kernels.launches["bounce_fused"] - before
    record["golden"] = dict(rmse=e, psnr=p, launches=used)
    print(f"golden: RMSE {e:.6f} PSNR {p:.2f} dB over {used} K1 launches",
          flush=True)
    if not (e < 5e-3 and p > 40 and used == 8 * 3):
        dump()
        _fail("golden: the kernel-rendered Cornell box misses the golden")

    # ---- 5. the main path ---------------------------------------------------
    width, height, spp = 1920, 1080, 4
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=1 << 18)
    cam_m = default_camera(host, width, height, device=dev)
    out = render_sample(scene, cam_m, cfg, width, height, 0)     # warm-up
    torch.cuda.synchronize()
    n_chunks = -(-(width * height) // cfg.ray_chunk)
    kernels.launches.clear()
    t0 = time.perf_counter()
    acc, rays = None, 0
    for s in range(1, 1 + spp):
        out = render_sample(scene, cam_m, cfg, width, height, s)
        acc = out["L"] if acc is None else acc + out["L"]
        rays = rays + out["ray_count"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = dict(kernels.launches)
    rays = int(rays)
    hdr = acc / spp
    finite = bool(torch.isfinite(hdr).all())
    want = n_chunks * cfg.max_bounces * spp
    mrays = rays / dt / 1e6
    ms_frame = dt / spp * 1e3
    record["main"] = dict(res=f"{width}x{height}", spp_timed=spp,
                          bounces=cfg.max_bounces, chunks=n_chunks,
                          launches=launched, expected=want, rays=rays,
                          seconds=dt, mrays_per_s=mrays,
                          ms_per_frame_1spp=ms_frame,
                          L_mean=float(hdr.mean()), finite=finite,
                          tier=out["kernel_tier"], card=smi)
    print(f"main: Cornell {width}x{height} {cfg.max_bounces} bounces, "
          f"{spp} spp: {mrays:.3f} Mrays/s, {ms_frame:.3f} ms per 1-spp "
          f"frame, {rays} rays, K1 launches {launched.get('bounce_fused', 0)}"
          f" of {want}, mean L {float(hdr.mean()):.5f} ({smi})", flush=True)
    if launched.get("bounce_fused", 0) != want or not finite \
            or out["kernel_tier"] != "fused":
        dump()
        _fail("main: the main path did not run every bounce through K1 "
              "or gave non-finite values")
    dump()

    kernel_line = {"kernels": [{
        "name": "bounce_fused", "route": "cuda",
        "source": "rtxpt_tpu_torch/csrc/bounce_fused.cu",
        "replaces": "rtxpt_tpu/pt/bounce_pallas.py:1389",
        "launches": launched["bounce_fused"], "max_abs_err": max_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def _write_record(record, path):
    """Every phase's details as JSON at `path` (best effort)."""
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    except OSError as e:
        print(f"note: could not write the phase record: {e}", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", metavar="PATH",
                        help="write every phase's details as JSON to PATH")
    args = parser.parse_args()
    try:
        main(args.record)
    except Exception:
        traceback.print_exc()
        _fail("an exception ended the run")

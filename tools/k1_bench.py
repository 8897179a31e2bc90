#!/usr/bin/env python3
"""K1, the fused bounce kernel, on one NVIDIA GPU: its bounce-0 launch
times, its device time per 1080p frame, its registers and build time, and
(--check) its lanes against the plain version; with --parent, a parent
checkout's K1 and this one's in turns. `--kernel k9`, `k2`, `k8` and `k4`
measure the BVH walk K9, the external-NEE shadow kernel K2, the general
tier's brute-force closest hit K8 and the clustered shading kernel K4 the
same way (see `measure_k9`, `measure_k2`, `measure_k8`, `measure_k4`).

    python3 tools/k1_bench.py [--kernel k1|k9|k2|k8|k4] [--check] \\
        [--profile] [--sweep] [--stacks 16,24,32] [--parent PARENT_DIR] \\
        [--out out.json]

Cases, each at 1920x1080 with 4 bounces: the Cornell box (power NEE, nee
slot 2), rooms_scene(16) (NEE-AT, slot 3), kitchen_scene() (stochastic
texture filtering, power NEE on the external route: slot 5 with the
texture switch) and the curtain Cornell box (stochastic filtering, power
NEE: the omm_tex variant in slot 2); --stacks adds stacks of that many
triangles (quads in front of single_triangle's camera, as
tests/test_torch_cuda.py builds them; power NEE). For each: K1 timed at
the bounce-0 launch of 2^18 camera rays spread over the frame (the
paths' chunk) with CUDA events around 20 launches, and the same
launches' kernel time from the profiler beside the host's time per call
(the events time the host where it is the slower); with --check K1 against bounce_reference on
65,536 such rays at bounces 0 and 2 (the state carried by the plain
version): the lanes whose outputs differ bit-wise, and the screen's
counters. With --profile one 1-spp frame of the Cornell, rooms
(render_sample with a NEE-AT state) and kitchen paths under
torch.profiler: K1's device time and launches. The registers, stack
frame and spills of each K1 instantiation come from the build's ptxas
log, its HMMA count from the SASS.

--parent PARENT_DIR (the parent commit's `git archive`, unpacked) runs
the same measurement four times, each in its own process with its own
build: on the parent's package, this checkout's, this checkout's, the
parent's. The timing, comparison, profile and ptxas helpers are
chip_smoke.py's, loaded from this checkout whichever package runs.
Prints one JSON object; imports nothing of JAX."""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# this checkout's package, unless PYTHONPATH names another one first
sys.path.append(ROOT)

FRAME = (1920, 1080)
RAYS_TIMED = 1 << 18         # the fused paths' rays per chunk
CMP_SIDE = 256               # --check: 65,536 rays
ITERS = 20


def _from_root(name, rel):
    """A module of this checkout by its path (not the parent's, which
    PYTHONPATH may put first)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _from_root("chip_smoke", "chip_smoke.py")


def launch_costs(fn, iters, pattern=r"bounce_fused(_restart)?_kernel"):
    """(the device time per launch of the kernels matching `pattern` (K1's
    by default) from the profiler's kernel records, the host's time per
    call of `fn` without a synchronisation) over `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
    k = smoke._kernel_frame(prof, pattern)
    return k["ms"] / max(k["launches"], 1), host


def instantiations(kernels):
    """{launch name: ptxas figures and HMMA count} of K1's 32
    instantiations, the switches (texture, micromaps, priorities, split)
    of both libraries' tensor-core kernels (the CUDA-core kernels of the
    smallest tables are `..._kernel_exact`)."""
    out = {}
    for restart, lib in (("", kernels.BOUNCE_FUSED),
                         ("_restart", kernels.BOUNCE_FUSED_RESTART)):
        sass = lib.sass_opcodes(("HMMA", "HGMMA"))
        for t in (0, 1):
            for o in (0, 1):
                for p in (0, 1):
                    for s in (0, 1):
                        needle = (f"bounce_fused{restart}_kernelILb{t}ELb{o}"
                                  f"ELb{p}ELb{s}E")
                        name = ("bounce_fused" + ("_inj" if restart else "")
                                + "_omm" * o + "_tex" * t + "_prio" * p
                                + "_split" * s)
                        info = smoke._ptxas_entry(lib.ptxas_log, needle)
                        info["hmma"] = sum(
                            ops["HMMA"] + ops["HGMMA"]
                            for fn, ops in sass.items() if needle in fn)
                        out[name] = info
    return out


def quad_stack(n_quads, seed=3):
    """tests/test_torch_cuda.py's _quad_stack (that module does not load
    on a parent's package): n_quads quads 0.002 apart along -z, each of a
    random extent across single_triangle's view, lit by its point light."""
    import numpy as np

    from rtxpt_tpu_torch.scene import procedural as TP
    from rtxpt_tpu_torch.scene.scene import MeshInstance
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(n_quads):
        z = -0.002 * k
        x0, y0 = rng.uniform(-1.2, -0.1, 2)
        x1, y1 = rng.uniform(0.1, 1.2, 2)
        parts.append(TP._quad([x0, y0, z], [x1, y0, z], [x1, y1, z],
                              [x0, y1, z], 0))
    pos, nrm, uv, idx, mat = TP._merge(parts)
    host = TP.single_triangle("point")
    host.instances = [MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                   indices=idx, material=mat, name="stack")]
    return host


def cases(dev, stacks=()):
    """{name: (host, scene, resolved config, KernelConfig, NEE-AT state)},
    with the quad stacks of `stacks` triangles (power NEE)."""
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.scene import procedural as TP

    base = dict(max_bounces=4, ray_chunk=RAYS_TIMED)
    spec = dict(
        cornell=(TP.cornell_box(), dict(nee=NEEMode.POWER)),
        rooms=(TP.rooms_scene(16), dict(nee=NEEMode.NEEAT)),
        kitchen=(TP.kitchen_scene(), dict(nee=NEEMode.POWER,
                                          stochastic_texture_filtering=True)),
        curtain=(TP.curtain_cornell(True),
                 dict(nee=NEEMode.POWER, stochastic_texture_filtering=True)))
    spec.update({f"stack{n}": (quad_stack(n // 2),
                               dict(nee=NEEMode.POWER)) for n in stacks})
    out = {}
    for name, (host, kw) in spec.items():
        scene = prepare(host, device=dev)
        cfg = PathTracerConfig(**base, **kw)
        state = None
        if cfg.nee == NEEMode.NEEAT:
            from rtxpt_tpu_torch.lighting import neeat as na
            state = na.init_state(*FRAME, scene.lights.count, device=dev)
        rcfg = dispatch.resolve(scene, cfg, dev, state)
        out[name] = (host, scene, rcfg, bf.KernelConfig.from_cfg(rcfg), state)
    return out


def camera_state(host, cfg, cols, rows, dev, sample=1):
    """Camera rays of a cols x rows grid spread over the frame."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
    from rtxpt_tpu_torch.scene.procedural import default_camera
    w, h = FRAME
    cam = default_camera(host, w, h, device=dev)
    px, py = _pixel_grid(cols, rows, dev)
    px, py = px * w // cols, py * h // rows
    o, d, spread = camera_rays(cam, cfg, px, py, sample)
    return bf.initial_state(o, d, spread, px, py)


def check(case, dev):
    """K1 against bounce_reference at bounces 0 and 2 on 65,536 rays."""
    import torch
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    host, scene, cfg, kcfg, _ = case
    tbl = scene.bounce_tables
    stats = getattr(bf, "bounce_screen_stats", None)
    fs, is_ = camera_state(host, cfg, CMP_SIDE, CMP_SIDE, dev)
    out = {}
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, 1)
        if b in (0, 2):
            if stats:
                stats(dev, True)
            kern = bf.bounce(fs, is_, tbl, kcfg, 1)
            torch.cuda.synchronize()
            res = dict(lanes_differ=smoke._lanes_differ(kern, plain),
                       lanes=int(fs.shape[1]))
            if stats:
                res["screen"] = stats(dev, False)
            out[f"bounce{b}"] = res
        fs, is_ = plain[0], plain[1]
    return out


def profile(case, dev):
    """K1's device time and launches over one profiled 1-spp frame, and
    the frame's wall time (after a warm-up frame)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from rtxpt_tpu_torch.pt.integrator import render_sample
    from rtxpt_tpu_torch.scene.procedural import default_camera
    host, scene, cfg, _, state = case
    cam = default_camera(host, *FRAME, device=dev)
    kw = {} if state is None else dict(neeat_state=state)
    render_sample(scene, cam, cfg, *FRAME, 0, **kw)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_sample(scene, cam, cfg, *FRAME, 1, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    k1 = smoke._k1_frame(prof)
    return dict(k1_ms=k1["ms"], k1_launches=k1["launches"],
                frame_wall_ms=wall)


def measure(args):
    """One run on the package that `import rtxpt_tpu_torch` finds."""
    import torch
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build = kernels.build_all((kernels.BOUNCE_FUSED,
                               kernels.BOUNCE_FUSED_RESTART))
    res = dict(package=os.path.dirname(rtxpt_tpu_torch.__file__), card=smi,
               build_s=build, instantiations=instantiations(kernels),
               times={}, checks={}, frames={})
    all_cases = cases(dev, args.stacks)
    for name, case in all_cases.items():
        host, scene, cfg, kcfg, _ = case
        fs_t, is_t = camera_state(host, cfg, 512, 512, dev)
        tbl = scene.bounce_tables

        def launch():
            return bf.bounce(fs_t, is_t, tbl, kcfg, 1)
        ms = smoke._cuda_ms(launch, ITERS)
        device_ms, host_ms = launch_costs(launch, ITERS)
        res["times"][name] = dict(ms=ms, device_ms=device_ms,
                                  host_ms=host_ms, rays=int(fs_t.shape[1]),
                                  slot=kcfg.nee_mode,
                                  tex=bool(bf.use_tex(tbl, kcfg)),
                                  omm=bool(tbl.omm), tris=tbl.n_tris)
        print(f"k1 {name} ({tbl.n_tris} triangles) slot {kcfg.nee_mode}: "
              f"{ms:.4f} ms per {fs_t.shape[1]}-ray bounce-0 launch "
              f"(events), {device_ms:.4f} ms of kernel (profiler), "
              f"{host_ms:.4f} ms of host per call ({smi})", flush=True)
        if args.check:
            res["checks"][name] = c = check(case, dev)
            print(f"k1 {name} check: {json.dumps(c)}", flush=True)
    if args.profile:
        for name in ("cornell", "rooms", "kitchen"):
            res["frames"][name] = p = profile(all_cases[name], dev)
            print(f"k1 {name} frame: {json.dumps(p)} ({smi})", flush=True)
    return res


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _record_queries(scene, cfg, o, d, spread, px, py, keep):
    """Run the general wavefront once through the kernels and return the
    inputs (o, d, tmin, tmax) of its scene queries `keep` ((kind, index)
    pairs: ("closest", 0) is bounce 0's camera rays, ("any", 0) its shadow
    rays, ("closest", 1) bounce 1's)."""
    from rtxpt_tpu_torch.pt import integrator as I
    calls, inputs = dict(closest=0, any=0), {}
    saved = I.scene_closest, I.scene_any

    def recorder(kind, fn):
        def query(scene_, o_, d_, tmin_, tmax_):
            key = (kind, calls[kind])
            calls[kind] += 1
            if key in keep:
                inputs[key] = tuple(x.contiguous() for x in
                                    (o_, d_, tmin_, tmax_))
            return fn(scene_, o_, d_, tmin_, tmax_)
        return query
    I.scene_closest = recorder("closest", saved[0])
    I.scene_any = recorder("any", saved[1])
    try:
        I.trace_paths(scene, cfg, o, d, spread, px, py, 1)
    finally:
        I.scene_closest, I.scene_any = saved
    return inputs


def _walk_check(bvh, args, any_hit):
    """K9 against its plain wide walk on every 32nd ray of a launch
    (chip_smoke._walk_agreement; None on a package without the wide
    walk)."""
    import torch
    from rtxpt_tpu_torch.accel import traverse
    plain_walk = getattr(traverse, "_traverse_wide", None)
    if plain_walk is None:
        return None
    sub = [x[::32].contiguous() for x in args]
    kern = traverse.walk(bvh, *sub, any_hit=any_hit, stats=True)
    plain = plain_walk(bvh, *sub, any_hit, True)
    torch.cuda.synchronize()
    return dict(lanes=int(sub[0].shape[0]),
                **smoke._walk_agreement(kern, plain, any_hit))


def measure_k9(args):
    """K9 on the package that `import rtxpt_tpu_torch` finds: the city's
    1080p general-tier queries (bounce 0's closest hit and shadow rays,
    bounce 1's closest hit; captured from one wavefront through the
    kernels) and 512 x 512 camera rays of the foliage card's micromap BVH,
    each timed with CUDA events and the profiler, with its visits and
    tests per ray and (--check) its lanes against the plain wide walk;
    with --profile K9's device time and launches over one profiled
    general-tier city frame."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.accel import traverse
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import integrator as I
    from rtxpt_tpu_torch.scene.procedural import default_camera
    dev = torch.device("cuda:0")
    smi = _card()
    build = kernels.build_all((kernels.BVH_TRAVERSE,))
    inst = {f"{'any' if a else 'closest'}{'_omm' * m}": smoke._ptxas_entry(
        kernels.BVH_TRAVERSE.ptxas_log,
        f"bvh_traverse_kernelILb{a}ELb{m}E")
        for a in (0, 1) for m in (0, 1)}
    res = dict(package=os.path.dirname(rtxpt_tpu_torch.__file__), card=smi,
               build_s=build, instantiations=inst, times={}, checks={},
               frames={})
    w, h = FRAME
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           kernel_tier="xla", ray_chunk=1 << 30)
    host = smoke._city_host()
    city = prepare(host, device=dev)
    cam = default_camera(host, w, h, device=dev)
    px, py = I._pixel_grid(w, h, dev)
    o, d, spread = I.camera_rays(cam, cfg, px, py, 1)
    keep = (("closest", 0), ("any", 0), ("closest", 1))
    calls = _record_queries(city, dataclasses.replace(cfg, max_bounces=2),
                            o, d, spread, px, py, keep)
    fol_host = smoke._alpha_hosts()["foliage"]
    fol = prepare(fol_host, device=dev)
    side = 512
    fpx, fpy = I._pixel_grid(side, side, dev)
    fo, fd, _ = I.camera_rays(default_camera(fol_host, w, h, device=dev), cfg,
                              fpx * w // side, fpy * h // side, 1)
    nf = fo.shape[0]
    runs = {f"city_{k}{i}": (city.bvh, calls[(k, i)], k == "any")
            for k, i in keep}
    runs["foliage_omm"] = (fol.bvh, (
        fo.contiguous(), fd.contiguous(), torch.zeros(nf, device=dev),
        torch.full((nf,), 1e27, device=dev)), False)
    for name, (bvh, call, any_hit) in runs.items():
        def launch():
            return traverse.walk(bvh, *call, any_hit=any_hit)
        ms = smoke._cuda_ms(launch, 10)
        device_ms, host_ms = launch_costs(launch, 10, r"bvh_traverse_kernel")
        st = traverse.walk(bvh, *call, any_hit=any_hit, stats=True)
        n = int(call[0].shape[0])
        wide = getattr(bvh, "wide", None)
        res["times"][name] = t = dict(
            ms=ms, device_ms=device_ms, host_ms=host_ms, rays=n,
            any_hit=any_hit,
            visits_per_ray=float(st["visits"].double().mean()),
            tests_per_ray=float(st["tests"].double().mean()),
            hits=int((st["prim"] >= 0).sum()), nodes=bvh.num_nodes,
            wide_nodes=None if wide is None else int(wide.shape[0]),
            wide_depth=getattr(bvh, "wide_depth", None),
            wide_stack=getattr(bvh, "wide_stack", None))
        print(f"k9 {name}: {ms:.4f} ms per {n}-ray launch (events; "
              f"{device_ms:.4f} ms of kernel from the profiler, {host_ms:.4f} "
              f"ms of host per call), "
              f"{t['visits_per_ray']:.2f} visits and {t['tests_per_ray']:.3f} "
              f"tests per ray, {t['hits']} hits ({smi})", flush=True)
        if args.check:
            res["checks"][name] = c = _walk_check(bvh, call, any_hit)
            print(f"k9 {name} check: {json.dumps(c)}", flush=True)
    if args.profile:
        render_cfg = dataclasses.replace(cfg, ray_chunk=1 << 30)
        I.render_sample(city, cam, render_cfg, w, h, 0)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            I.render_sample(city, cam, render_cfg, w, h, 1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        k9 = smoke._kernel_frame(prof, r"bvh_traverse_kernel")
        res["frames"]["city_general"] = p = dict(
            k9_ms=k9["ms"], k9_launches=k9["launches"], frame_wall_ms=wall)
        print(f"k9 city general-tier frame: {json.dumps(p)} ({smi})",
              flush=True)
    return res


def _k2_cases(dev):
    """{name: (scene, K1's config, the requests' config, NEE-AT state)}:
    rooms_scene(16) with NEE-AT (552 triangles; K1 in slot 3), the kitchen
    with stochastic filtering (1,186 triangles, 513 lights: slot 5) and the
    curtain Cornell box with stochastic filtering on the external power
    route (14 triangles, micromaps: slot 5, K2's omm variant)."""
    import dataclasses
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    all_cases = cases(dev)
    out = {}
    for name in ("rooms", "kitchen", "curtain"):
        host, scene, cfg, kcfg, state = all_cases[name]
        if name == "curtain":
            cfg = dataclasses.replace(cfg, nee_external=True)
            kcfg = bf.KernelConfig.from_cfg(cfg)
        out[name] = (host, scene, cfg, kcfg, state)
    return out


def _k2_requests(case, fs, is_, dev):
    """K2's input at bounce 0: the shadow requests external_nee builds on
    the surfaces K1 exports from the state (fs, is_), K1's plain version's
    (bit-exact with K1; no K1 build)."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.nee_external import external_nee
    host, scene, cfg, kcfg, state = case
    out = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 1)
    res = external_nee(
        scene, cfg, state, out[3], fs[bf.FS_D:bf.FS_D + 3], out[2][5] > 0.5,
        fs[bf.FS_PREVPDF], is_[bf.IS_PREVDELTA] > 0, out[1][bf.IS_PX],
        out[1][bf.IS_PY], 1, 0, lb=is_[bf.IS_LBOUNCE])
    ua = None
    if scene.bounce_tables.omm:
        ua = bf.alpha_uniform(cfg, is_[bf.IS_PX], is_[bf.IS_PY],
                              is_[bf.IS_LBOUNCE], 1)
    return bf.shadow_requests(res["shadow_o"], res["shadow_d"], res["sdist"],
                              res["do_nee"], ua)


def measure_k2(args):
    """K2 on the package that `import rtxpt_tpu_torch` finds: the requests
    of 2^18 bounce-0 camera rays spread over the 1080p frame on the rooms,
    the kitchen and the curtain (`_k2_cases`), timed with CUDA events, with
    (--check) occ and tests against occlusion_reference on every lane and
    the screen's counters; with --profile K2's device time and launches
    over one profiled NEE-AT rooms frame."""
    import torch
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    dev = torch.device("cuda:0")
    smi = _card()
    build = kernels.build_all((kernels.SHADOW_OCCLUSION,) + (
        (kernels.BOUNCE_FUSED,) if args.profile else ()))
    log = kernels.SHADOW_OCCLUSION.ptxas_log
    inst = {name: smoke._ptxas_entry(log, f"shadow_occlusion_kernel{x}ILb{m}E")
            for m in (0, 1) for x, name in (
                ("", f"screen{'_omm' * m}"), ("_exact", f"exact{'_omm' * m}"))}
    res = dict(package=os.path.dirname(rtxpt_tpu_torch.__file__), card=smi,
               build_s=build, instantiations=inst, times={}, checks={},
               frames={})
    stats = getattr(bf, "occlusion_screen_stats", None)
    all_cases = _k2_cases(dev)
    for name, case in all_cases.items():
        host, scene, cfg, kcfg, _ = case
        tbl = scene.bounce_tables
        fs, is_ = camera_state(host, cfg, 512, 512, dev)
        sh = _k2_requests(case, fs, is_, dev)
        def launch():
            return bf.occlusion(tbl, sh)
        ms = smoke._cuda_ms(launch, ITERS)
        device_ms, host_ms = launch_costs(launch, ITERS,
                                          r"shadow_occlusion_kernel")
        occ, tests = bf.occlusion(tbl, sh, stats=True)
        req = sh[bf.SR_DO] > 0.5
        res["times"][name] = t = dict(
            ms=ms, device_ms=device_ms, host_ms=host_ms,
            lanes=int(sh.shape[1]), requests=int(req.sum()),
            pairs=int(tests.sum()), occluded=int((occ[req] > 0.5).sum()),
            tris=tbl.n_tris, omm=bool(tbl.omm))
        print(f"k2 {name} ({tbl.n_tris} triangles): {ms:.4f} ms per "
              f"{t['lanes']}-lane launch (events; {device_ms:.4f} ms of "
              f"kernel from the profiler, {host_ms:.4f} ms of host per "
              f"call), {t['requests']} requests, "
              f"{t['pairs']} pairs tested, {t['occluded']} occluded ({smi})",
              flush=True)
        if args.check:
            if stats:
                stats(dev, True)
            occ_k, tst_k = bf.occlusion(tbl, sh, stats=True)
            screen = stats(dev, False) if stats else None
            occ_p, tst_p = bf.occlusion_reference(tbl, sh, stats=True)
            torch.cuda.synchronize()
            res["checks"][name] = c = dict(
                occ_lanes_differ=int((occ_k != occ_p).sum()),
                tests_lanes_differ=int((tst_k != tst_p).sum()),
                lanes=int(sh.shape[1]), screen=screen)
            print(f"k2 {name} check: {json.dumps(c)}", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from rtxpt_tpu_torch.pt.integrator import render_sample
        from rtxpt_tpu_torch.scene.procedural import default_camera
        host, scene, cfg, _, state = all_cases["rooms"]
        cam = default_camera(host, *FRAME, device=dev)
        render_sample(scene, cam, cfg, *FRAME, 0, neeat_state=state)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render_sample(scene, cam, cfg, *FRAME, 1, neeat_state=state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        k2 = smoke._kernel_frame(prof, r"shadow_occlusion_kernel")
        k1 = smoke._k1_frame(prof)
        res["frames"]["rooms_neeat"] = p = dict(
            k2_ms=k2["ms"], k2_launches=k2["launches"], k1_ms=k1["ms"],
            frame_wall_ms=wall)
        print(f"k2 rooms NEE-AT frame: {json.dumps(p)} ({smi})", flush=True)
    return res


def _k8_calls(dev, brute):
    """{name: (BruteTris, (o, d, tmin, tmax))}: K8's launches of the main
    paths, each captured from a run through the wrapper: the Cornell box's
    general tier (2^18 camera rays over the 1080p frame, and bounce 1's
    2^19-ray fused query), the glass-over-mirror box's stable-planes BUILD
    pass at 1920x1080 (its first walk's depths 0 and 2, 2,073,600 rays) and
    the kitchen's general tier at 960x540 (518,400 rays, 1,186
    triangles)."""
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import integrator as I
    from rtxpt_tpu_torch.pt.stable_planes import decompose
    from rtxpt_tpu_torch.scene import procedural as TP
    cfg = PathTracerConfig(max_bounces=1, nee=NEEMode.POWER,
                           kernel_tier="xla", ray_chunk=1 << 30)
    out = {}

    def camera(host, cols, rows, frame):
        w, h = frame
        cam = TP.default_camera(host, w, h, device=dev)
        px, py = I._pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        return I.camera_rays(cam, cfg, px, py, 1) + (px, py)

    host = TP.cornell_box()
    scene = prepare(host, device=dev)
    o, d, spread, px, py = camera(host, 512, 512, FRAME)
    q = _record_queries(scene, cfg, o, d, spread, px, py,
                        (("closest", 0), ("closest", 1)))
    out["cornell_2^18"] = (scene.bvh.brute, q[("closest", 0)])
    out["cornell_2^19"] = (scene.bvh.brute, q[("closest", 1)])
    host = TP.glass_mirror_cornell()
    scene = prepare(host, device=dev)
    o, d, _, _, _ = camera(host, *FRAME, FRAME)
    calls, real = [], brute.closest

    def recorder(tris, o_, d_, tmin_, tmax_):
        calls.append((tris, tuple(x.contiguous() for x in
                                  (o_, d_, tmin_, tmax_))))
        return real(tris, o_, d_, tmin_, tmax_)
    brute.closest = recorder
    try:
        decompose(scene, o, d)
    finally:
        brute.closest = real
    out["build_depth0"], out["build_depth2"] = calls[0], calls[2]
    host = TP.kitchen_scene()
    scene = prepare(host, device=dev)
    o, d, spread, px, py = camera(host, 960, 540, (960, 540))
    q = _record_queries(scene, cfg, o, d, spread, px, py, (("closest", 0),))
    out["kitchen"] = (scene.bvh.brute, q[("closest", 0)])
    return out


def measure_k8(args):
    """K8 on the package that `import rtxpt_tpu_torch` finds: its launches
    of `_k8_calls`, each timed with CUDA events and the profiler beside
    its bound (chip_smoke._k8_bound), with (--check) t, prim, uv and front
    against `_closest_plain` on every lane and the screen's counters; with
    --sweep (this checkout) both routes at every shape, and on the
    kitchen's rays the routes' crossover (its first 48-1,024 triangles);
    with --profile K8's device time and launches over one profiled
    general-tier Cornell 1080p frame."""
    import torch
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.accel import brute
    dev = torch.device("cuda:0")
    smi = _card()
    build = kernels.build_all((kernels.BRUTE_CLOSEST,))
    entries = getattr(kernels, "BRUTE_CLOSEST_ENTRIES",
                      dict(brute_closest="brute_closest_kernel"))
    log = kernels.BRUTE_CLOSEST.ptxas_log
    inst = {name: smoke._ptxas_entry(log, needle)
            for name, needle in entries.items()}
    sass = kernels.BRUTE_CLOSEST.sass_opcodes(("HMMA",))
    for name, needle in entries.items():
        inst[name]["hmma"] = sum(ops["HMMA"] for fn, ops in sass.items()
                                 if needle in fn)
    res = dict(package=os.path.dirname(rtxpt_tpu_torch.__file__), card=smi,
               build_s=build, instantiations=inst, times={}, checks={},
               frames={}, sweep={})
    stats = getattr(brute, "screen_stats", None)
    for name, (tris, call) in _k8_calls(dev, brute).items():
        def launch():
            return brute.closest(tris, *call)
        ms = smoke._cuda_ms(launch, ITERS)
        device_ms, host_ms = launch_costs(launch, ITERS,
                                          r"brute_(closest|screen|mma)_kernel")
        n, nt = int(call[0].shape[0]), tris.num_triangles
        # the bound of this checkout's routes (the parent's package has
        # one route: the plain test's count)
        bound, by, _ = smoke._k8_bound(tris, n) if hasattr(brute, "route") \
            else smoke._bound(n * smoke.RAY_BYTES + 64 * nt,
                              f32=n * nt * smoke.K8_PAIR_F32)
        hit = launch()
        res["times"][name] = t = dict(
            ms=ms, device_ms=device_ms, host_ms=host_ms, rays=n, tris=nt,
            hits=int((hit["prim"] >= 0).sum()), bound_ms=bound, bound_by=by,
            route="mma" if getattr(brute, "MMA_TRIS", 1 << 30) < nt
            <= getattr(brute, "MMA_MAX_TRIS", 0) else "cuda-core")
        print(f"k8 {name} ({nt} triangles, {t['route']}): {ms:.4f} ms per "
              f"{n}-ray launch (events; {device_ms:.4f} ms of kernel from "
              f"the profiler, {host_ms:.4f} ms of host per call), bound "
              f"{bound:.4f} ms ({by}), {t['hits']} hits ({smi})", flush=True)
        if args.check:
            if stats:
                stats(dev, True)
            kern = brute.closest(tris, *call)
            screen = stats(dev, False) if stats else None
            plain = brute._closest_plain(tris, *call)
            torch.cuda.synchronize()
            res["checks"][name] = c = dict(
                lanes_differ=smoke._k8_lanes_differ(kern, plain), lanes=n,
                screen=screen)
            print(f"k8 {name} check: {json.dumps(c)}", flush=True)
        if args.sweep and hasattr(brute, "MMA_TRIS"):
            sw = res["sweep"][name] = {}
            saved = brute.MMA_TRIS
            # the tables the tensor-core route does not take carry no tile:
            # the forced route gets one built here
            tiled = tris if tris.tile is not None \
                or nt > brute.MMA_MAX_TRIS else brute.BruteTris(
                tris.table, *(x.to(dev) for x in
                              brute.brute_tile(tris.table.cpu())))
            for route, limit in (("cuda-core", 1 << 30), ("mma", 0)):
                if route == "mma" and nt > brute.MMA_MAX_TRIS:
                    continue
                brute.MMA_TRIS = limit
                try:
                    sw[route] = launch_costs(
                        lambda: brute.closest(tiled, *call), ITERS,
                        r"brute_\w+_kernel")[0]
                finally:
                    brute.MMA_TRIS = saved
            if name == "kitchen":
                # the routes' crossover: the kitchen's first T triangles
                for size in (48, 64, 80, 96, 128, 256, 512, 1024):
                    tbl = tris.table[:size].contiguous()
                    tile, scale = (x.to(dev) for x in
                                   brute.brute_tile(tbl.cpu()))
                    sub = brute.BruteTris(table=tbl, tile=tile, scale=scale)
                    for route, limit in (("cuda-core", 1 << 30), ("mma", 0)):
                        brute.MMA_TRIS = limit
                        try:
                            sw[f"{route}_{size}"] = launch_costs(
                                lambda: brute.closest(sub, *call), ITERS,
                                r"brute_\w+_kernel")[0]
                        finally:
                            brute.MMA_TRIS = saved
            print(f"k8 {name} sweep (kernel ms): {json.dumps(sw)}",
                  flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
        from rtxpt_tpu_torch.prepare import prepare
        from rtxpt_tpu_torch.pt.integrator import render_sample
        from rtxpt_tpu_torch.scene import procedural as TP
        host = TP.cornell_box()
        scene = prepare(host, device=dev)
        cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                               kernel_tier="xla", ray_chunk=RAYS_TIMED)
        cam = TP.default_camera(host, *FRAME, device=dev)
        render_sample(scene, cam, cfg, *FRAME, 0)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render_sample(scene, cam, cfg, *FRAME, 1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        k8 = smoke._kernel_frame(prof, r"brute_\w+_kernel")
        res["frames"]["cornell_general"] = p = dict(
            k8_ms=k8["ms"], k8_launches=k8["launches"], frame_wall_ms=wall)
        print(f"k8 Cornell general-tier frame: {json.dumps(p)} ({smi})",
              flush=True)
    return res


def _k4_calls(dev):
    """{name: (args, kwargs)} of K4 (bounce_clustered.shade) at the
    bounce-0 launch of a 1-spp 1920x1080 frame (2,073,600 lanes), each
    captured from the path's own call: the city (slot 2), its split
    channels, the sky city (has_env; its final_env launch; slots 3 and 5
    on the has_env launch's inputs, as chip_smoke.py phase 12 takes them),
    the textured city (has_tex with has_env), the 40 x 40 curtain grid and
    the foliage (omm_tex), the overlap boxes with their wall (prio) and
    Bistro (omm_tex_prio, slot 5)."""
    import dataclasses
    import torch
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import render_sample
    from rtxpt_tpu_torch.scene import procedural as TP
    base = PathTracerConfig(max_bounces=1, nee=NEEMode.POWER,
                            ray_chunk=1 << 30)
    stf = dataclasses.replace(base, stochastic_texture_filtering=True)
    city = lambda **kw: TP.city_overview(TP.city_scene(  # noqa: E731
        smoke.CITY_TRIS, seed=smoke.CITY_SEED, **kw))
    alpha = smoke._alpha_hosts()
    spec = dict(
        city=(smoke._city_host(), base),
        split=(None, dataclasses.replace(base, split_channels=True)),
        sky_city=(city(with_env=True), base),
        tex_city=(city(textured=True, normal_mapped=True, with_env=True),
                  stf),
        grid=(alpha["grid"], stf),
        foliage=(alpha["foliage"], stf),
        wall=(TP.overlap_boxes([1, 2, 0, 0], wall=True), base),
        bistro=(TP.bistro_scene(smoke.BISTRO_TRIS, seed=0),
                dataclasses.replace(stf, firefly_clamp=32.0)))
    out, scene = {}, None
    for name, (host, cfg) in spec.items():
        if host is not None:
            scene = prepare(host, device=dev)
            cam = TP.default_camera(host, *FRAME, device=dev)
        calls, real = [], BC.shade

        def recorder(*a, **kw):
            calls.append(([x.clone() if torch.is_tensor(x) else x
                           for x in a],
                          {k: x.clone() if torch.is_tensor(x) else x
                           for k, x in kw.items()}))
            return real(*a, **kw)
        BC.shade = recorder
        try:
            render_sample(scene, cam, cfg, *FRAME, 1)
        finally:
            BC.shade = real
        torch.cuda.synchronize()
        first = calls[0]
        out[name] = first
        if name == "sky_city":
            out["sky_final_env"] = next(c for c in calls
                                        if c[1].get("final_env"))
            for slot in (3, 5):
                a = list(first[0])
                a[4] = bf.KernelConfig(nee_mode=slot, maxb=4)
                out[f"sky_slot{slot}"] = (a, dict(first[1]))
        del calls
    return out


def measure_k4(args):
    """K4 on the package that `import rtxpt_tpu_torch` finds: its launches
    of `_k4_calls`, each timed with CUDA events and the profiler beside
    its bound (chip_smoke._k4_bytes), with (--check) every output row
    against shade_reference bit-wise on 65,536 lanes and on 65,532 (a last
    tile of 124 lanes), and the hash of K6's SASS (its library shares
    K4's shading body); with --profile K4's device time and launches over
    one profiled 1-spp city frame (4 bounces)."""
    import torch
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    dev = torch.device("cuda:0")
    smi = _card()
    build = kernels.build_all((kernels.CLUSTER_CLOSEST, kernels.CLUSTER_SHADE,
                               kernels.CLUSTER_SHADOW, kernels.CLUSTER_ROWS))
    log = kernels.CLUSTER_SHADE.ptxas_log
    inst = {("cluster_shade" + "_omm" * o + "_tex" * t + "_prio" * p
             + "_split" * sp): smoke._ptxas_entry(
                 log, f"cluster_shade_kernelILb{t}ELb{o}ELb{p}ELb{sp}E")
            for t in (0, 1) for o in (0, 1) for p in (0, 1) for sp in (0, 1)}
    # K6 shares K4's shading body (cluster_shade.cuh shade_hit): the SASS
    # of its library's instructions, hashed, to hold against the parent's
    sass = subprocess.run(
        [kernels.find_cuobjdump(), "-sass", str(kernels.CLUSTER_ROWS.path)],
        capture_output=True, text=True, check=True).stdout
    k6 = hashlib.sha256("\n".join(
        line for line in sass.splitlines() if "/*" in line).encode())
    res = dict(package=os.path.dirname(rtxpt_tpu_torch.__file__), card=smi,
               build_s=build, instantiations=inst, times={}, checks={},
               frames={}, k6_sass_sha256=k6.hexdigest())
    print(f"k4: K6's SASS sha256 {k6.hexdigest()}", flush=True)
    for name, (a, kw) in _k4_calls(dev).items():
        def launch():
            return BC.shade(*a, **kw)
        ms = smoke._cuda_ms(launch, 10)
        device_ms, host_ms = launch_costs(launch, 10, r"cluster_shade_kernel")
        ha, fs, is_, tbl, kcfg = a[:5]
        n = int(fs.shape[1])
        final = bool(kw.get("final_env", False))
        tex = bf.use_tex(tbl, kcfg) and not final
        ext = kcfg.external and tbl.n_lights > 0 and not final
        # the rows K4's function reads (this checkout's staging plan; the
        # parent's package has none, so its runs carry no bound)
        bound, by = (smoke._bound(smoke._k4_bytes(
            n, tbl, tex, ext, omm=bool(kw.get("omm")) and not final,
            split=kw.get("fs2") is not None, final=final))[:2]
            if hasattr(BC, "shade_ha_read") else (None, None))
        res["times"][name] = t = dict(ms=ms, device_ms=device_ms,
                                      host_ms=host_ms, lanes=n,
                                      bound_ms=bound, bound_by=by,
                                      nee_mode=kcfg.nee_mode)
        print(f"k4 {name} (slot {kcfg.nee_mode}): {ms:.4f} ms per {n}-lane "
              f"launch (events; {device_ms:.4f} ms of kernel from the "
              f"profiler, {host_ms:.4f} ms of host per call), bound "
              + (f"{bound:.4f} ms ({by})" if bound else "not computed")
              + f" ({smi})", flush=True)
        if args.check:
            c = res["checks"][name] = {}
            for m in (65536, 65532):
                sub = [x[:, :m].contiguous() if torch.is_tensor(x)
                       and x.dim() == 2 and x.shape[1] == n else x
                       for x in a]
                skw = {k: x[:, :m].contiguous() if torch.is_tensor(x)
                       else x for k, x in kw.items()}
                kern = BC.shade(*sub, **skw)
                plain = BC.shade_reference(*sub, **skw)
                torch.cuda.synchronize()
                c[m] = smoke._lanes_differ(list(kern), list(plain))
            print(f"k4 {name} check (lanes differ at 65,536 and 65,532 "
                  f"lanes): {json.dumps(c)}", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
        from rtxpt_tpu_torch.prepare import prepare
        from rtxpt_tpu_torch.pt.integrator import render_sample
        from rtxpt_tpu_torch.scene import procedural as TP
        host = smoke._city_host()
        scene = prepare(host, device=dev)
        cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                               ray_chunk=1 << 30)
        cam = TP.default_camera(host, *FRAME, device=dev)
        render_sample(scene, cam, cfg, *FRAME, 0)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render_sample(scene, cam, cfg, *FRAME, 1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        k4 = smoke._kernel_frame(prof, r"cluster_shade_kernel")
        res["frames"]["city"] = p = dict(
            k4_ms=k4["ms"], k4_launches=k4["launches"], frame_wall_ms=wall)
        print(f"k4 city frame: {json.dumps(p)} ({smi})", flush=True)
    return res


def turns(args):
    """The parent, this checkout, this checkout, the parent: each a child
    process of this script with PYTHONPATH on that checkout."""
    scratch = os.path.join(ROOT, "build", "k1_bench")
    os.makedirs(scratch, exist_ok=True)
    flags = (["--profile"] * args.profile + ["--check"] * args.check
             + ["--sweep"] * args.sweep + ["--kernel", args.kernel]
             + (["--stacks", ",".join(map(str, args.stacks))]
                if args.stacks else []))
    runs = []
    for i, (label, root) in enumerate((("parent", args.parent),
                                       ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        out = os.path.join(scratch, f"run{i}.json")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        subprocess.run([sys.executable, os.path.abspath(__file__), *flags,
                        "--out", out], env=env, check=True,
                       stdout=subprocess.DEVNULL)
        with open(out) as f:
            r = dict(label=label, **json.load(f))
        runs.append(r)
        if args.kernel != "k1":
            print(f"{args.kernel} {label} (run {i}): " + ", ".join(
                f"{c} {t['ms']:.4f} ms" for c, t in r["times"].items())
                + f"; frames {json.dumps(r['frames'])}; checks "
                f"{json.dumps(r['checks'])}"
                + (f"; K6 SASS sha256 {r['k6_sass_sha256']}"
                   if "k6_sass_sha256" in r else "")
                + f" ({r['card']})", flush=True)
            continue
        print(f"k1 {label} (run {i}, build {r['build_s']}): " + ", ".join(
            f"{c} {t['ms']:.4f} ms (kernel {t['device_ms']:.4f}, host "
            f"{t['host_ms']:.4f})" for c, t in r["times"].items())
            + "; frames " + ", ".join(
                f"{c} K1 {p['k1_ms']:.3f} ms / {p['k1_launches']} launches"
                for c, p in r["frames"].items()) + f" ({r['card']})",
            flush=True)
    for label in ("parent", "change"):
        inst = next(r for r in runs if r["label"] == label)["instantiations"]
        if args.kernel != "k1":
            print(f"{args.kernel} {label} registers/stack/spills: "
                  f"{json.dumps(inst)}", flush=True)
            continue
        print(f"k1 {label} registers/stack/spill stores/spill loads/HMMA: "
              + ", ".join(
                  f"{k[len('bounce_fused'):] or '_'} {v['registers']}/"
                  f"{v['stack_bytes']}/{v['spill_store_bytes']}/"
                  f"{v['spill_load_bytes']}/{v['hmma']}"
                  for k, v in sorted(inst.items())), flush=True)
    return dict(runs=runs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stacks", type=lambda s: [int(n) for n in s.split(",")],
                    default=[], help="triangles of the quad stacks to time")
    ap.add_argument("--parent", help="the parent checkout: run in turns")
    ap.add_argument("--kernel", choices=("k1", "k9", "k2", "k8", "k4"),
                    default="k1", help="the kernel to measure")
    ap.add_argument("--sweep", action="store_true",
                    help="k8: both routes at every shape (this checkout)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    one = dict(k1=measure, k9=measure_k9, k2=measure_k2, k8=measure_k8,
               k4=measure_k4)[args.kernel]
    res = turns(args) if args.parent else one(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K1, the fused bounce kernel, on one NVIDIA GPU: its bounce-0 launch
times, its device time per 1080p frame, its registers and build time, and
(--check) its lanes against the plain version; with --parent, a parent
checkout's K1 and this one's in turns.

    python3 tools/k1_bench.py [--check] [--profile] [--stacks 16,24,32] \\
        [--parent PARENT_DIR] [--out chiprun_out/k1.json]

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


def launch_costs(fn, iters):
    """(K1's device time per launch from the profiler's kernel records,
    the host's time per call of `fn` without a synchronisation) over
    `iters` calls."""
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
    k1 = smoke._k1_frame(prof)
    return k1["ms"] / max(k1["launches"], 1), host


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


def turns(args):
    """The parent, this checkout, this checkout, the parent: each a child
    process of this script with PYTHONPATH on that checkout."""
    scratch = os.path.join(ROOT, "build", "k1_bench")
    os.makedirs(scratch, exist_ok=True)
    flags = (["--profile"] * args.profile + ["--check"] * args.check
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
        print(f"k1 {label} (run {i}, build {r['build_s']}): " + ", ".join(
            f"{c} {t['ms']:.4f} ms (kernel {t['device_ms']:.4f}, host "
            f"{t['host_ms']:.4f})" for c, t in r["times"].items())
            + "; frames " + ", ".join(
                f"{c} K1 {p['k1_ms']:.3f} ms / {p['k1_launches']} launches"
                for c, p in r["frames"].items()) + f" ({r['card']})",
            flush=True)
    for label in ("parent", "change"):
        inst = next(r for r in runs if r["label"] == label)["instantiations"]
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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    res = turns(args) if args.parent else measure(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

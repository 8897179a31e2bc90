"""Headless render CLI of the port (counterpart of rtxpt_tpu/apps/cli.py):
reference mode, and real-time mode with --realtime.

Usage:
    python -m rtxpt_tpu_torch.apps.cli --scene cornell --device cuda \
        --width 512 --height 512 --spp 16 --bounces 6 --out cornell.png
    python -m rtxpt_tpu_torch.apps.cli --scene city --device cuda \
        --width 1920 --height 1080 --spp 4 --bounces 4 --out city.png
    python -m rtxpt_tpu_torch.apps.cli --scene rooms --nee neeat \
        --device cuda --width 1920 --height 1080 --spp 8 --out rooms.png
    python -m rtxpt_tpu_torch.apps.cli --scene kitchen --stf \
        --device cuda --width 1920 --height 1080 --spp 4 --out kitchen.png

The city (about --tri-budget triangles, 350,000 by default; seen from above
the roofs) renders on the clustered tier; the other scenes fit the fused
kernel's 2048 triangles. `--nee neeat` (the per-tile adaptive sampler,
learning from each sample before the next), `--candidates K` above 1
(WRS) and scenes of more than 128 lights take the external-NEE route of
either tier. `--sky` adds the procedural sky (lighting/sky.py make_sky,
256 x 128, baked at the kernels' 64 x 128); `--env-quads Q` bakes it as Q
region lights, which the general tier samples; with `--nee neeat` an
environment light also renders on the general tier, as in the JAX
package. `--envmap PATH` (an image file) is not ported yet.

The textured scenes: `cornell-textured` (checker walls, the sky),
`city-textured` (checker ground and facades, the sky) and `kitchen`
(checker floor, wood counters, 512 ceiling panels, the sky through a
window). `--stf` turns on stochastic texture filtering, which the fused
and clustered kernels' texture path is; without it a textured scene
renders on the general tier with bilinear filtering, as in the JAX
package.

Real-time mode (pt/realtime.py): `--realtime N` renders N one-sample
frames through the denoiser (`--denoiser relax|reblur|none`, `--split-
denoise` for the diffuse and specular channels apart), `--taa` and
`--bloom`, at `--render-scale` of the display size, and saves the last;
`--stable-planes` decomposes the frame into stable planes first (the
fused tier restarts each plane's fill from its V-buffer in K1):

    python -m rtxpt_tpu_torch.apps.cli --scene cornell --device cuda \
        --width 1920 --height 1080 --bounces 4 --realtime 8 --taa \
        --stable-planes --out rt.png

ReSTIR (`--restir`), ReGIR (`--regir`) and the pipelined frame driver
(`--pipelined`) are not ported: they are refused by name.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_scene(name: str, tri_budget: int = 350_000):
    from rtxpt_tpu_torch.scene import procedural

    if name == "city":
        # raised above the roofs: the scene's own camera is inside a tower
        return procedural.city_overview(
            procedural.city_scene(tri_budget=tri_budget))
    if name == "cornell":
        return procedural.cornell_box()
    if name == "furnace":
        return procedural.furnace_box()
    if name == "triangle":
        return procedural.single_triangle()
    if name == "rooms":
        return procedural.rooms_scene(16)
    if name == "cornell-textured":
        return procedural.textured_cornell(with_env=True)
    if name == "city-textured":
        return procedural.city_overview(procedural.city_scene(
            tri_budget=tri_budget, textured=True, with_env=True))
    if name == "kitchen":
        return procedural.kitchen_scene()
    raise SystemExit(f"unknown scene {name!r} ({', '.join(SCENES)})")


SCENES = ["cornell", "cornell-textured", "furnace", "triangle", "rooms",
          "city", "city-textured", "kitchen"]


def main(argv=None):
    p = argparse.ArgumentParser(prog="rtxpt_tpu_torch",
                                description="PyTorch/CUDA path tracer")
    p.add_argument("--scene", default="cornell", choices=SCENES)
    p.add_argument("--tri-budget", type=int, default=350_000,
                   help="city: about this many triangles")
    p.add_argument("--stf", action="store_true",
                   help="stochastic texture filtering (the fused and "
                        "clustered kernels' texture path)")
    p.add_argument("--sky", action="store_true",
                   help="add a procedural sky environment")
    p.add_argument("--env-quads", type=int, default=0, metavar="Q",
                   help="bake the environment as Q region lights "
                        "(kEnvironmentQuad)")
    p.add_argument("--envmap", default=None,
                   help="equirect environment image (not ported yet)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--nee", choices=["off", "uniform", "power", "neeat"],
                   default="power")
    p.add_argument("--candidates", type=int, default=1,
                   help="NEE light candidates per vertex (WRS above 1)")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--no-rr", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--tonemap", choices=["aces", "reinhard", "linear", "none"],
                   default="aces")
    p.add_argument("--out", default="out.png", help="PNG output path")
    p.add_argument("--hdr", default=None, help="also dump linear HDR .npy")
    p.add_argument("--aux", action="store_true",
                   help="dump the albedo/normal/depth/wpos/emission guide "
                        "buffers, averaged over the samples, as "
                        "<out>.<key>.npy")
    p.add_argument("--seed", type=int, default=0, help="first sample index")
    p.add_argument("--realtime", type=int, default=0, metavar="FRAMES",
                   help="real-time mode: run N 1-spp frames through the "
                        "denoiser/TAA pipeline, save the last")
    p.add_argument("--denoiser", choices=["none", "relax", "reblur"],
                   default="relax", help="denoiser for --realtime")
    p.add_argument("--restir", choices=["none", "di", "digi"],
                   default="none", help="ReSTIR in --realtime frames (not "
                   "ported)")
    p.add_argument("--regir", action="store_true",
                   help="ReGIR candidates for --restir (not ported)")
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="trace at this fraction of the display size and "
                        "upscale before TAA")
    p.add_argument("--split-denoise", action="store_true",
                   help="denoise the diffuse and specular channels apart")
    p.add_argument("--pipelined", action="store_true",
                   help="double-buffered frame driver (not ported)")
    p.add_argument("--stable-planes", action="store_true",
                   help="real-time path-space decomposition (delta chains)")
    p.add_argument("--taa", action="store_true")
    p.add_argument("--bloom", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    args = p.parse_args(argv)
    if args.spp < 1:
        p.error("--spp must be >= 1")
    if args.width < 1 or args.height < 1:
        p.error("--width/--height must be >= 1")
    if args.bounces < 0:
        p.error("--bounces must be >= 0")
    if args.candidates < 1:
        p.error("--candidates must be >= 1")
    if args.env_quads < 0:
        p.error("--env-quads must be >= 0")
    if args.aux and args.nee == "neeat":
        p.error("--aux: the NEE-AT render (render_adaptive) returns no "
                "guide buffers")
    if args.envmap:
        p.error("--envmap: loading environment images is not ported to "
                "rtxpt_tpu_torch yet (use --sky)")
    if args.realtime < 0:
        p.error("--realtime must be >= 0")
    for flag, on in (("--restir", args.restir != "none"),
                     ("--regir", args.regir),
                     ("--pipelined", args.pipelined)):
        if on:
            p.error(f"{flag}: ReSTIR, ReGIR and the pipelined frame driver "
                    f"are not ported to rtxpt_tpu_torch")

    import numpy as np

    import rtxpt_tpu_torch
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt.integrator import render, render_adaptive
    from rtxpt_tpu_torch.render.postprocess import tonemap
    from rtxpt_tpu_torch.scene.procedural import default_camera
    from rtxpt_tpu_torch.utils.image import save_png

    dev = rtxpt_tpu_torch.device(args.device)
    host = build_scene(args.scene, args.tri_budget)
    if args.sky:
        from rtxpt_tpu_torch.lighting.sky import make_sky
        host.envmap_image = make_sky()
    host.env_quad_lights = args.env_quads
    t0 = time.time()
    scene = prepare(host, device=dev)
    print(f"[prepare] {scene.tri_pack.shape[0]} tris, "
          f"{scene.lights.count} lights, {time.time() - t0:.2f}s",
          file=sys.stderr)
    cam = default_camera(host, args.width, args.height, device=dev)
    cfg = PathTracerConfig(
        max_bounces=args.bounces,
        nee={"off": NEEMode.OFF, "uniform": NEEMode.UNIFORM,
             "power": NEEMode.POWER, "neeat": NEEMode.NEEAT}[args.nee],
        nee_candidates=args.candidates,
        enable_mis=not args.no_mis,
        enable_russian_roulette=not args.no_rr,
        stochastic_texture_filtering=args.stf)

    t0 = time.time()
    if args.realtime:
        return _realtime(args, scene, cam, cfg, dev, t0)
    if args.nee == "neeat":
        hdr, _, rays = render_adaptive(scene, cam, cfg, args.width,
                                       args.height, spp=args.spp,
                                       first_sample=args.seed)
        aux = {}
    else:
        hdr, aux, rays = render(scene, cam, cfg, args.width, args.height,
                                spp=args.spp, first_sample=args.seed,
                                want_aux=args.aux)
    ldr = tonemap(hdr, args.exposure, args.tonemap).cpu().numpy()
    dt = time.time() - t0
    print(f"[render] {args.width}x{args.height}@{args.spp}spp on {dev} in "
          f"{dt:.2f}s ({rays} rays, {rays / dt / 1e6:.2f} Mrays/s incl. "
          f"kernel build)", file=sys.stderr)
    save_png(args.out, ldr)
    print(f"[out] {args.out}", file=sys.stderr)
    if args.hdr:
        np.save(args.hdr, hdr.cpu().numpy())
    base = args.out.rsplit(".", 1)[0]
    for k, v in aux.items():
        np.save(f"{base}.{k}.npy", v.cpu().numpy())
    return 0


def _realtime(args, scene, cam, cfg, dev, t0):
    """--realtime: the frames, the last one saved (and its HDR)."""
    import numpy as np

    from rtxpt_tpu_torch.config import DenoiserMode, RenderConfig
    from rtxpt_tpu_torch.pt import realtime
    from rtxpt_tpu_torch.utils.image import save_png

    rc = RenderConfig(
        width=args.width, height=args.height,
        denoiser=DenoiserMode[args.denoiser.upper()], enable_taa=args.taa,
        enable_bloom=args.bloom, exposure=args.exposure,
        tonemap=args.tonemap, render_scale=args.render_scale,
        split_denoise=args.split_denoise)
    state = realtime.init_state(args.height, args.width, scene=scene,
                                pt_cfg=cfg)
    frame_fn = (realtime.render_frame_stable_planes if args.stable_planes
                else realtime.render_frame)
    for _ in range(args.realtime):
        img, hdr, state = frame_fn(scene, cam, cfg, rc, state)
    img = img.cpu().numpy()
    dt = time.time() - t0
    print(f"[realtime] {args.realtime} frames of {args.width}x{args.height} "
          f"on {dev} in {dt:.2f}s ({dt / args.realtime * 1e3:.1f} ms/frame "
          f"avg incl. kernel build)", file=sys.stderr)
    save_png(args.out, img)
    print(f"[out] {args.out}", file=sys.stderr)
    if args.hdr:
        np.save(args.hdr, hdr.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtxpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repository root, one GPU
    python3 chip_smoke.py --record out.json # also write every phase's details

Phases, one or a few lines of output each:

  1. device  -- card name and power limit (nvidia-smi), torch and CUDA
                versions; TF32 off.
  2. build   -- compiles every CUDA kernel of the port from rtxpt_tpu_torch/
                csrc with nvcc, one process per source, all at once;
                seconds, registers, spills; the tensor-core instructions
                (HMMA, HGMMA) in the SASS of K3's and K5's three variants
                each, of K6's two instantiations and K7, and of K1's 32
                instantiations (its two libraries; cuobjdump -sass), which
                must be more than 0 in each; the registers, stack frame and
                spills of K1's 32 instantiations; of K8's two routes
                (the tensor-core one's HMMA count, more than 0) and of K4's
                sixteen instantiations with their static shared memory and
                their stage's dynamic shared memory.
  3. k1      -- one launch of the fused bounce kernel (K1) against its plain
                PyTorch version on the same 65,536 Cornell camera rays, at
                bounce 0 and at bounce 2 (Russian roulette on): integer rows
                and prim ids equal on >= 99.9% of lanes, every float row
                within rtol = atol = 2e-3 on >= 99.9% of lanes, image-mean
                radiance within 1e-3 relative. Times both at the Cornell
                path's 2^18 rays per launch. Here and after the K1
                comparisons of phases 9, 12-15, 17 and 18: the lanes whose
                outputs differ bit-wise from the plain version's (expected
                0) and K1's screen counters over the comparison launches
                (bounce_fused.bounce_screen_stats: the pass shares of the
                closest-hit and shadow pairs; counting also runs the exact
                test on every rejected pair, and one it accepts fails the
                run).
  4. golden  -- Cornell 32x32, 8 spp, 3 bounces through K1 against
                tests/goldens/cornell_32_8spp.npy: RMSE < 5e-3, PSNR > 40;
                the same render through the plain version on the card (the
                pixels that differ bit-wise) and K1's screen pass share.
  5. main    -- the Cornell path: Cornell 1920x1080, 4 bounces, power NEE,
                2^18 rays per chunk, 1 warm-up and 4 timed samples through
                render_sample; K1 must launch chunks x bounces x spp times,
                the image must be finite; one profiled frame gives K1's
                device time and launches per frame, beside its times
                before the redesign for the tensor cores (PERF.md).
  6. clustered -- the clustered kernels K3 (closest hit), K4 (shading) and
                K5 (shadow any-hit) against their plain versions on the
                card on the 340k-triangle city, every page: at bounce 0 on
                65,536 camera rays spread over the 1080p frame (64 groups),
                at bounce 2 on the 64 contiguous groups of the sorted 1080p
                wavefront (carried there by the kernels) with the most
                hits: K3 as bounce_clustered.closest_agreement (winner
                prim/instance/UNKNOWN equal on >= 99.9% of lanes, every HA
                row bit-equal on those that hit, the differing lanes'
                refit t within 2e-3 relative, visits equal on >= 99% of
                groups and their sum within 0.1%), K4 as K1 in phase
                3, K5 occlusion equal on >= 99.9% of lanes and test counts
                equal (the differing lanes and K5's screen pass share,
                bounce_clustered.occlusion_screen_stats, printed; also in
                phases 11-14, and the share over Bistro's pass-through
                frame in phase 15); at least 5% of each comparison's lanes
                must hit. Times each kernel at
                the city path's 1080p bounce-0 launch (2,025 groups) and its
                plain version at the comparison width.
  7. city parity -- the 3,512-triangle city of the CPU tests, 48x32, 2 spp,
                3 bounces, through the kernels against the plain versions,
                both on the card: >= 99% of pixels within 2e-3, image mean
                within 1e-3 relative.
  8. city    -- the city path: city_scene(350_000, seed=0), 1920x1080,
                4 bounces, power NEE, the frame as one chunk, 1 warm-up and
                2 timed samples (bench.py's stage_city), with the camera
                raised above the roofs (procedural.city_overview; the
                scene's own camera stands inside a tower and sees a black
                frame). K3 and K5 must launch pages x bounces x spp times,
                K4 bounces x spp times, and the image must be finite. Then
                one profiled frame splits the device time: sort, cull, K3,
                K4, K5, the rest, and the idle share.
  9. external NEE -- the fused tier's external-NEE route on rooms_scene(16)
                (552 triangles, 32 lights) at 1920x1080: K1 in nee slots 3
                (NEE-AT) and 5 (power, external) against its plain version
                with phase 3's criteria, the 24 SF_* surface rows included,
                and the shadow kernel K2 against its plain version on the
                requests external_nee builds from them (occlusion and tested
                pairs equal on every lane, its screen counters read: no
                accepted pair missed), on 65,536 camera
                rays spread over the frame at bounces 0 and 2; K1 timed in
                slots 2, 3 and 5 and K2 timed at 2^18 rays. Then the three
                full-size paths, each at 1920x1080, 4 bounces, 2^18 rays per
                chunk (8 chunks), after one warm-up sample: NEE-AT on the
                rooms through render_adaptive (4 timed samples; lit tiles
                must leave the uniform pmf), and through render power NEE
                over the 144 lights of rooms_scene(72, subdiv=1) (2 timed)
                and WRS with 4 candidates on the Cornell box (2 timed). K1
                and K2 must each launch chunks x bounces x spp times and the
                images must be finite. One profiled NEE-AT frame splits the
                device time: camera rays, K1, external NEE, K2, feedback,
                the rest, and the idle share; K1's and K2's device time and
                launches per frame, beside their times before the redesign.

  10. general tier -- the general BVH wavefront (kernel_tier="xla"):
                the brute-force closest hit K8 against its plain version on
                65,536 Cornell camera rays at bounces 0 and 2 (bounce 2's
                query is the 2N-wide one that carries bounce 1's shadow
                rays) and on rooms_scene(16), the state carried by the
                plain path: t, prim, uv and front bit-equal on every lane;
                K8 timed at 2^18 and 2^19 rays. The BVH walk K9 against
                its plain version
                (the 4-wide walk `_traverse_wide`) on 65,536 rays of the
                city (city_overview's camera) at bounces 0 and 2, closest
                hit (prim, front, t, u, v bit-equal on >= 99.9% of lanes,
                the differing lanes counted) and any-hit (occlusion equal
                on every lane), visit and test counts equal on every lane;
                K9 timed at the 1080p bounce-0 launch, its bound from its
                own counts. The Cornell
                golden through the general tier (phase 4's limits); the
                small city of phase 7 through the general tier against the
                clustered tier (RMSE < 2e-2, means within 5e-3,
                tests/test_cluster.py:138-140). Then the two full-size
                paths through render, each after one warm-up sample: the
                Cornell path (1080p, 4 bounces, power NEE, 2^18 rays per
                chunk, 2 timed samples) and the city (1080p as one chunk, 4
                bounces, power NEE, 1 timed sample), each with its K8 or K9
                launch count (chunks x the queries per chunk), the LBVH
                build seconds, one profiled frame (K8's or K9's share of
                the device time, the idle share), and for the city the RMSE
                and mean difference against phase 8's clustered image of
                the same sample (no limit).
  11. instancing -- the instanced city (procedural.instanced_city(8, 21):
                64 towers sharing one 5,292-triangle prototype on a floor,
                339,888 world triangles in a 6,492-triangle pool, one point
                light, a camera above a corner of the grid): its pool and
                candidate bytes against the flattened scene's blocks. K3's
                and K5's instanced variants against their plain versions
                as phase 6, at bounce 0 and on 1080p windows at bounces
                1 and 2 (K4 on the post-transformed hits): prim ids,
                HA_INST and front equal, t/u/v within rtol = atol = 2e-3,
                occlusion equal, each on >= 99.9% of lanes, visit and test
                counts equal; each timed at the 1080p bounce-0 launch with
                its registers and spills. The instanced path as phase 8
                (1080p, 4 bounces, power NEE, one chunk, kslots 64, 2
                pages, 1 warm-up and 2 timed samples): the instanced
                variants launch pages x bounces x spp times, K4 bounces x
                spp times, the image is finite and lit (mean > 1e-3), and
                one profiled frame splits the device time (sort, cull, K3,
                post-transform, K4, K5, the rest, idle). Against the same
                host flattened (instancing="off", the flat K3/K5): the
                bounce-0 t of the 1080p camera rays within 1e-4 relative
                on >= 99.9% of the lanes that both hit, the bounce-0 hit
                shares of both and of the exact TLAS walk, the flattened
                frame's time, and the two 1-spp images' RMSE and means
                (no limit). The TLAS route:
                procedural.instanced_boxes(3) (9 boxes, floor, emissive
                panel, point light; it resolves to "xla") at 96x96, 4 spp,
                3 bounces against the same host flattened, both on the
                general tier: RMSE < 2e-3 (tests/test_tlas.py:203-214),
                no kernel launched; then one timed and one profiled 1080p
                1-spp frame of it (4 bounces): its device launches per
                frame and idle share.
  12. environment -- (a) K1's environment variants on the Cornell box
                under make_sky() (the CLI's --sky, baked at 64 x 128):
                has_env at bounces 0 and 2 and the final_env launch
                against the plain version on 65,536 camera rays over the
                1080p frame, phase 3's criteria; both timed at 2^18 rays.
                (b) K4 on the sky city (city_overview(city_scene(350_000,
                seed=0, with_env=True))): K3, K4's has_env variant and K5
                as phase 6 (bounce 0 on 65,536 spread rays, bounce 2 on
                the sorted 1080p window); K4's final_env and its export
                slots 3 and 5 against the plain version at bounce 0 (the
                spread rays) and bounce 2 (the sorted 1080p window, as
                phase 6), the SF_* rows and hit row 5 included, phase 3's
                criteria; each timed at the 1080p bounce-0 launch.
                (c) The three full-size paths, each at 1920x1080, 4
                bounces, 1 warm-up and 2 timed samples: the sky Cornell
                box on the fused tier (power NEE, 8 chunks of 2^18; K1's
                has_env variant chunks x bounces x spp times, final_env
                chunks x spp); the sky city on the clustered tier (power
                NEE, one chunk, kslots 64, 2 pages; K3 pages x (bounces +
                1) x spp, K4 has_env bounces x spp, final_env spp, K5
                pages x bounces x spp), its cull_overflow and one
                profiled frame split into sort, cull, K3, K4, K5, the
                final round, the rest and the idle share; NEE-AT on the
                city of phase 6 through render_adaptive on the clustered
                tier (K4 in slot 3, external_nee, K5; lit tiles must
                leave the uniform pmf). Every image must be finite.
                (d) The small city with the sky through the kernels
                against the plain versions (phase 7's limits, the final
                round's launches counted); the sky city's 1-spp 1080p
                image on the general tier against the clustered tier's
                (RMSE and means printed, no limit).
  13. textures -- stochastic texture filtering on. (a) K1's texture
                variant (tex_maps (1, 1, 1, 1) on the textured Cornell box
                with the sky, the light's emission textured; nee slot 2)
                and on the kitchen (procedural.kitchen_scene: 1,186
                triangles, 512 panel lights, the sky; slot 5, the SF_*
                rows included) against the plain version on 65,536 camera
                rays over the 1080p frame at bounces 0 and 2, phase 3's
                criteria; both timed at 2^18 rays; K2 on the kitchen's
                external requests at the same bounces (occlusion and
                tested pairs equal on every lane, no accepted pair missed)
                and timed on the 2^18-ray launch's; the registers and
                spills of each K1 and K4 instantiation. (b) K3, K4's
                texture variant and K5 on the textured, normal-mapped sky
                city (city_overview(city_scene(350_000, seed=0,
                textured=True, normal_mapped=True, with_env=True))) as
                phase 6. (c) The full-size paths at 1920x1080, 4 bounces,
                power NEE, 1 warm-up and 2 timed samples: the textured
                Cornell box (fused, 8 chunks of 2^18; K1's texture variant
                chunks x bounces x spp times, final_env chunks x spp), the
                kitchen (fused, external NEE: K1's texture variant and K2
                chunks x bounces x spp times; one profiled frame: K1's
                device time and launches per frame), the textured city
                (clustered, K4's texture variant bounces x spp times, one
                profiled frame, cull_overflow); then the kitchen without
                stochastic filtering on the general tier (bilinear, K8)
                at 960x540, one timed sample, K8's bounce-0 launch of its
                warm-up (518,400 rays, 1,186 triangles: the tensor-core
                route) held bit-equal to its plain version on every lane
                and timed beside its bound. Every image must be finite.
  14. alpha  -- opacity micromaps and alpha-tested geometry, stochastic
                texture filtering on. Scenes (procedural.curtain_cornell):
                the curtain Cornell box (one alpha-tested quad, an 8 x 8
                checkerboard alpha), its 40 x 40 grid (64 x 64
                checkerboard, 3,212 triangles) and the foliage card (160 x
                160 grid, leaf_texture(64); the bake drops its TRANSPARENT
                triangles). (a) K1's micromap variant (nee slot 2) and K2's
                (on the requests of slot 5 and external_nee, each with its
                alpha uniform) on the curtain against their plain versions
                on 65,536 camera rays over the 1080p frame at bounces 0
                and 2, phase 3's criteria (K2: occlusion and pair counts
                equal on every lane), both timed at 2^18 rays; the registers of every K1
                and K4 instantiation. (b) K3, K4 and K5's micromap variants
                on the 40 x 40 curtain and the foliage as phase 6; K9 with
                micromaps on the 40 x 40 curtain's BVH against the plain
                wide walk (closest and any hit, >= 99.9% of lanes
                bit-equal, visit and test counts equal), timed on 2^18
                foliage camera rays. Every comparison on the curtains has at least
                5% of its lanes on MIXED triangles and 1% on UNKNOWN cells
                (the foliage's shares are printed). (c) The full-size paths
                at 1920x1080, 4 bounces plus the 2 pass-through
                iterations, 1 warm-up and 2 timed samples: the curtain on
                the fused tier under power NEE (8 chunks of 2^18) and NEE-AT
                (render_adaptive: K1 and K2), the 40 x 40 curtain and the
                foliage on the clustered tier; then the curtain without
                filtering (K8 and the retrace) and the foliage (K9's walk
                with micromaps) on the general tier at 960x540. Each path
                prints its launch counts, the share of the shaded lanes
                that passed through and one profiled frame.
  15. priorities -- nested dielectric priorities and Bistro. (a) K1's
                priority variant on procedural.overlap_boxes (water and
                glass overlapping, the glass outranking the water) and
                K4's on their subdivided form (a 40 x 40 side wall puts
                them on the clustered tier), on 65,536 rays of two
                cameras (inside the water, the rays starting in air:
                false exits; inside the glass beyond the water, starting
                in the glass: false entries) at bounces 0 and 2 against
                their plain versions, phase 3's criteria, the interior
                list (IS_MED0, IS_MED1) equal on every lane and at least
                5% of the active lanes false hits; K1 timed at 2^18 rays,
                K4 at 2,073,600 lanes; the registers and spills of all
                eight K1 and K4 instantiations. K4's omm_tex_prio variant
                on Bistro (bistro_scene(600_000, seed=0)) in nee slot 5:
                timed at the 1080p bounce-0 launch beside omm_tex, and
                held against its plain version (its SF_* rows included)
                in the warm-up sample at rounds 0 and 2 on the 64 groups
                of the sorted wavefront with the most glass hits (false
                hits reported). (b) The closed-form overlap radiance (the
                glass wins: E exp(-SW 0.4 - SG 0.8), rtol 5e-3) through
                the kernels on the fused, clustered and general tiers.
                (c) Bistro at 1920x1080 in scripts/run_ladder.py rung 5's
                path-tracer configuration (4 bounces, power NEE,
                stochastic texture filtering, firefly clamp 32; the
                scene's camera; one chunk) plus the 2 pass-through
                rounds, 1 warm-up and 2 timed samples on the clustered
                tier's external route: triangles, clusters, lights, table
                memory, prepare seconds; K3 / K5 micromap variants pages x
                rounds x spp and K4 omm_tex_prio rounds x spp launches;
                the pass-through share; one profiled frame (sort, cull,
                external NEE, K3, K4, K5, the rest, idle) with its
                cull_overflow and Mrays/s; a finite, lit image; the
                sample at the smallest page count without cull overflow
                (F7) and the default image's RMSE against it; the same
                sample on the general tier (K9) at 960x540 against the
                clustered tier's (RMSE and means, no limit), and K9's
                micromap walk on the first two launches of that sample
                held to the plain wide walk as phase 10's.
  16. per-row -- the per-row clustered route (bounce_clustered.FLAT
                False: K6, closest hit and shading in one kernel, and K7,
                per-row shadow any-hit). (a) K6's variants and K7 against
                their plain versions, phase 6's criteria with row visits
                and K7's pairs equal: at bounce 0 on 65,536 spread camera
                rays and at bounce 2 on the 64 groups of the sorted 1080p
                wavefront with the most hits, carried there by K6 and K7;
                the city runs K6's plain variant, the sky city `_env` and
                `_final`, the textured sky city (stochastic filtering)
                `_tex_env`. (b) Each timed at its city's 1080p bounce-0
                launch beside its bound (K6: K4's bytes without the HA
                rows, the winners' rows and the staged blocks; the
                operations of the pairs its rows test), with registers
                and spills; on the city K6 against K3 at one page plus K4
                on the same lists and launch, K7 against K5, and the
                lanes whose winner differs from K3's; the lanes that
                differ bit-wise from the plain versions in (a), each
                kernel's screen pass share (`rows_screen_stats`), its
                shared memory and its CUDA-core predecessor's times
                beside its own. (c) The three cities at 1920x1080, 4
                bounces, power NEE, kslots 64, one chunk, 1 warm-up and
                2 timed samples through render_sample: K6 bounces x spp (plus `_final` spp with the sky) and K7
                bounces x spp launches, cull_overflow, a finite lit image,
                sample 1's RMSE and share of equal pixels against the flat
                route at 1 page and at its default 2 pages (each timed),
                and one profiled city frame (sort, cull, K6, K7, the
                rest, idle; K6's and K7's shares and time per launch).
  17. split  -- the split channels and the aux guide buffers. (a) All
                sixteen instantiations of K1 (curtain Cornell box) and of
                K4 (its 40 x 40 grid, K3's hits) -- texture, micromap,
                priority and split switches -- on 4,096 camera rays (the
                priority ones on procedural.overlap_curtain from its
                inside cameras, at least 5% of the active lanes priority
                false hits), K1's eight without priorities again on the
                44-triangle curtain grid, whose table takes K1's
                tensor-core screen (tables of at most 16 triangles, as the
                one-quad curtain's 14, take its exact loops), and K1's
                split variant on 65,536 rays of the
                Cornell path (slot 2) and of the rooms (slot 3, the SF_*
                rows), K4's on the 64 groups of the city's sorted 1080p
                wavefront with the most hits (slot 2, and in the export
                slots 3 and 5 with the SF_* rows), each at bounces 0 and
                2 against its plain version: bit-exact (max abs err 0,
                the fs2 rows and SH_CDIFF included). (b) K1 split beside
                K1 at the Cornell and the rooms' 2^18-ray launches, K4
                split beside K4 at the city's 1080p bounce-0 launch, with
                their bounds (the fs2 rows' bytes added) and every
                instantiation's registers and spills. (c) The Cornell
                box (fused, 8 chunks of 2^18), NEE-AT on
                rooms_scene(16) through the tile state
                render_adaptive keeps (K1 split in slot 3, external_nee,
                K2) and the city (flat clustered, 2 pages) at 1920x1080, 4
                bounces, without and with split_channels + want_aux in
                turns (1 warm-up and 2 timed samples each): the split
                variants' launch counts, finite L_diff, L_spec and aux
                buffers, the partition residual |L - emission - L_diff -
                L_spec| < 2e-2, the city's cull_overflow.
  18. realtime -- real-time mode (pt/realtime.py). (a) K1's inject
                variant (csrc/bounce_fused_restart.cu: the V-buffer
                restart of a stable-planes fill) and
                first_direct=False against the plain version on the 1080p
                glass-over-mirror Cornell box (procedural.
                glass_mirror_cornell): 65,536 camera rays spread over the
                frame, the V-buffers of planes 0, 1 and 2 (stable_planes.
                decompose), bounce 0 injected with the planes' budgets and
                bounce 2, phase 3's criteria and >= 99.9% of the lanes
                bit-exact; all sixteen instantiations with inject on (phase
                17's rays, bit-exact), the eight without priorities again
                on phase 17's 44-triangle curtain grid (the screen); the
                inject launch timed at 2^18
                lanes beside the ordinary K1, with its bound, and the
                restart instantiations' registers and spills. (b) The
                frames at 1920x1080, 4 bounces, power NEE, the camera
                moving a little every frame, 1 warm-up and 4 timed:
                render_frame on the Cornell box with RELAX, TAA and bloom,
                the same with split_denoise and at render_scale 0.5,
                render_frame_stable_planes on the glass-over-mirror box
                with RELAX and TAA (K1 inject once per plane and frame,
                the BUILD pass's K8 launches of depths 0 and 2 at
                2,073,600 rays held bit-equal to K8's plain version on
                every lane and timed beside their bound,
                each plane's share of valid pixels, one profiled frame:
                BUILD, fills, K1, denoise, TAA with tonemap, the rest,
                idle), render_frame on the city (clustered, 2 pages, 2
                timed frames, cull_overflow), one stable-planes frame of
                the city at 960x540 (the general tier, K9; the first two
                K9 launches of its BUILD pass held to the plain wide walk
                as phase 10's). (c) The
                glass-over-mirror composite at 480x270 (64 frames, no
                denoiser, firefly clamp 0.5) against render at 64 spp:
                RMSE < 2e-2 (tests/test_stable_planes.py:116-149), plane 1
                valid on some pixels; the denoised 1080p Cornell frame
                after 4 frames: roughness < 0.35x and mean within 0.5-2x
                of the raw 1-spp frame's (tests/test_realtime.py:17-51),
                and a lower RMSE than the raw frame's against a 128-spp
                accumulation.
  19. probes -- the probe kernels K10-K12 (rtxpt_tpu_torch/probes, the
                JAX package's scripts/micro_*.py). (a) Each probe's entry
                point main() on the card (the script's lines and checks),
                the launch counts set to 0 before and read after: each
                exits 0 and launches its kernels. (b) K10 (csrc/
                probe_cluster.cu) against its plain version, all 8 rows of
                its state, at 64 clusters x 8 and x 64 groups (counts from 0
                to 16) and at the script's timed size (2,344 clusters,
                2,048 groups of 16 full slots): equal; timed there (the
                script's line, the bound with its TF32 term, registers) and
                torch.bmm of its gathered products with TF32 off and on
                (products only, not the function). (c) K11 (csrc/
                probe_flat.cu) against its plain version at 32 groups, on
                the script's rays and on rays aimed at the probe's
                triangles, and at 2,048 groups: t and prim equal; the
                script's brute-force check on its sampled lanes, and on
                every lane of groups 0-1 against the triangles the probe
                intersects (F15), the aimed rays with the kernel's margins;
                timed at 32 and 2,048 groups with its bound. (d) The seven
                K12 constructs (csrc/probe_constructs.cu) against their
                plain versions, equal, each timed (device time from the
                profiler, call time beside it), and the one PyTorch call
                that computes tile8, subl_concat or unflat. (e) ns per visit (1,024
                rays x 128 triangles) of K10, K11 and K3 at the city's
                1080p bounce-0 launch (phase 6's time over its summed
                visits).

The line before the last holds {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed phase, a missing GPU or a missing
package exits non-zero without those lines. Imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

RAYS_K1 = 1 << 16            # phase 3 comparison width
RAYS_TIMED = 1 << 18         # the Cornell path's rays per launch
TOL = 2e-3
LANE_FRACTION = 0.999
MIN_HIT_SHARE = 0.05         # the least share of a clustered comparison's
#                              lanes that must hit
MEAN_RTOL = 1e-3
# H100 SXM data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12      # outside the tensor cores
TF32_FLOPS_PER_S = 495e12    # tensor cores
BF16_FLOPS_PER_S = 989e12    # tensor cores
# Operations per ray-triangle pair. K1's exact test (tri_test): 38 f32, on
# every pair of a table of at most EXACT_TRIS triangles (the CUDA-core
# kernels) and in K2. Larger tables take K1's split-bf16 screen: det reads
# 3 components of r = [d, o x d], u and v all 6, so 15 coefficient rows,
# c_hi*r_hi and c_lo*r_hi at the bf16 rate (2 x 15 x 2), c_hi*r_lo at the
# TF32 rate (15 x 2), counted as K3's below; then the screen's f32 work:
# the error term 1, |det| 1, the two margins 5 (two fma, one add), the
# sign test 1 and the numerators' tests 5. The exact resolves of the pairs
# that pass are left out (a lower bound).
K1_SCREEN_F32 = 13
K1_PAIR_BF16 = 60
K1_PAIR_TF32 = 30
# K3 and K5's split-bf16 quantities are a matrix product over 19
# coefficient rows, each multiply counted with its add: c_hi*r_hi and
# c_lo*r_hi are bf16 x bf16 (2 x 19 x 2 operations at the bf16 tensor
# rate), c_hi*r_lo takes the f32 residual of the ray (19 x 2 at the TF32
# rate). After the product the per-pair selection is f32 work: K3's sign,
# margins, six validity and three strictness comparisons, reciprocal,
# tie bump and running minimum (27); K5's sign and strict test (14).
K1_PAIR_F32 = 38
PAIR_BF16 = 76
PAIR_TF32 = 38
K3_PAIR_F32 = 27
K5_PAIR_F32 = 14
STAGED_BLOCK_BYTES = 21 * 512 * 4    # rows 0..20 of a cluster block
XF_BYTES = 10 * 10 * 4               # an instance's M10
# The instanced variants' map of the ray operand, per lane and visit: the
# structural non-zeros of M10 @ [d, o x d, o, 1] (accel/cluster.py
# instance_operand_map). d_o reads d (3 multiplies, 2 adds per row), o_o x
# d_o reads d and o x d (6 and 5), o_o reads o and the translation (3
# multiplies, 3 adds); the last row is 1. The kernels sum the dense rows
# for parity with the plain version, but the function needs these.
XFORM_F32 = 3 * 5 + 3 * 11 + 3 * 6
CITY_TRIS = 350_000
CITY_SEED = 0
CITY_FRAME = (1920, 1080)    # the city path's frame
CITY_PAGES = 2               # the 1080p city's pages per bounce (4,378
#                              clusters, kslots 64)
SMALL_CITY_PAGES = 1         # 46 clusters: kslots clamps to 46, one page
CMP_SIDE = 256               # phase 6 comparison: 256 x 256 = 65,536 rays,
#                              spread evenly over the city path's frame
ROOMS = 16                   # phase 9: rooms_scene(16), the NEE-AT scene
MANY_LIGHTS = (72, 1)        # rooms_scene(72, subdiv=1): 144 lights
EXT_FRAME = (1920, 1080)
EXT_CHUNK = 1 << 18
SR_BYTES = 4 * 8 + 4         # K2: a request's 8 rows read, occ written
# K8 and K9: a ray's o, d, tmin, tmax read (32 B), t, prim, u, v and front
# written (17 B)
RAY_BYTES = 32 + 17
# Operations of K8's factored pair test (accel.cuh brute_pair): det 6,
# u_num 11, v_num 12, t_num 6, |det| test 2, reciprocal 1, u, v, t 3, the
# seven range and best-t tests 7.
K8_PAIR_F32 = 48
# K9 per visited wide node: 4 slab tests (each 6 subtractions, 6
# multiplies, 6 per-axis min / max, 3 + 3 reductions with tmin and the
# limit, 1 comparison: 25), the limit (|t|, a multiply and an add: 3) and
# the order of the pushed children (6 pairwise comparisons of entry t, < and
# ==: 12); per triangle test: two cross products 18, four dot products 20,
# |det| test 2, reciprocal 1, tvec 3, three scalings 3, seven tests 7.
K9_NODE_F32 = 4 * 25 + 3 + 12
K9_TEST_F32 = 54
GEN_CMP_SIDE = 256           # phase 10 comparisons: 65,536 rays
GEN_CHUNK = 1 << 18          # the Cornell path's rays per chunk
OMM_WORD_BYTES = 4           # a micromap word, or a coverage, per triangle
MIXED_SHARE = 0.05           # phase 14: the least share of a comparison's
UNKNOWN_SHARE = 0.01         # lanes on a MIXED triangle, an UNKNOWN cell


def _share(screen):
    """A screen's pass share (bounce_clustered.occlusion_screen_stats or
    rows_screen_stats) as text."""
    share = screen["share"]
    return "not measured (no pairs)" if share is None else f"{share:.5%}"


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


def _once_ms(fn):
    """(fn's result, its one call's ms from CUDA events): for a plain
    version too slow to run twice, already warm from a smaller input."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _bound(nbytes, f32=0, tf32=0, bf16=0):
    """(least ms the card could take, what sets it, its terms in ms) for
    `nbytes` moved and the operations counted at each type's data-sheet
    rate. The tensor cores' TF32 and bf16 terms add up (one unit); the
    f32 units run beside them, so the operations take the larger of the
    two."""
    terms = dict(bytes=float(nbytes) / HBM_BYTES_PER_S * 1e3,
                 f32=float(f32) / F32_FLOPS_PER_S * 1e3,
                 tf32=float(tf32) / TF32_FLOPS_PER_S * 1e3,
                 bf16=float(bf16) / BF16_FLOPS_PER_S * 1e3)
    t_ops = max(terms["f32"], terms["tf32"] + terms["bf16"])
    if terms["bytes"] >= t_ops:
        return terms["bytes"], "bytes", terms
    return t_ops, "operations", terms


def _numel(t):
    return 0 if t is None else t.numel()


def _k1_ops(n_tris, pairs):
    """_bound's operations of K1 on `pairs` ray-triangle pairs (closest
    hit and shadow rays) of a table of `n_tris` triangles: the exact test
    on the CUDA-core kernels of the smallest tables, the split-bf16
    products and the screen on the tensor-core kernels."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    if n_tris <= bf.EXACT_TRIS:
        return dict(f32=pairs * K1_PAIR_F32)
    return dict(f32=pairs * K1_SCREEN_F32, tf32=pairs * K1_PAIR_TF32,
                bf16=pairs * K1_PAIR_BF16)


def _k1_shadow_pairs(plain):
    """The pairs that K1's in-kernel NEE shadow rays (nee slots 0-2) need
    on this data: each requesting lane's triangles in table order up to
    and including its first occluder, all of them where none occludes (the
    per-thread walk's count, K2's `tested`). Read from one call `plain` of
    bounce_reference on the launch's inputs, whose shadow test is asked
    for that count; 0 for a launch without shadow rays (the external
    slots, final_env)."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    occluded, tested = bf._occluded, []

    def counted(*args, stats=False, **kw):
        occ, t = occluded(*args, stats=True, **kw)
        tested.append(t)
        return (occ, t) if stats else occ
    bf._occluded = counted
    try:
        hit = plain()[2]
    finally:
        bf._occluded = occluded
    return int(tested[0][hit[5] > 0].sum()) if tested else 0


def _ptxas_summary(log):
    regs = re.findall(r"Used (\d+) registers", log)
    spill_st = re.findall(r"(\d+) bytes spill stores", log)
    spill_ld = re.findall(r"(\d+) bytes spill loads", log)
    return dict(registers=max(map(int, regs)) if regs else None,
                spill_store_bytes=max(map(int, spill_st)) if spill_st else None,
                spill_load_bytes=max(map(int, spill_ld)) if spill_ld else None)


def _lanes_differ(kernel_rows, plain_rows):
    """The lanes [N] where any row of a kernel's outputs (a list of [R, N]
    tensors) differs bit-wise from its plain version's (NaN matches NaN)."""
    import torch
    bad = None
    for k, p in zip(kernel_rows, plain_rows):
        if k.dtype.is_floating_point:
            same = (k.view(torch.int32) == p.view(torch.int32)) | (
                torch.isnan(k) & torch.isnan(p))
        else:
            same = k == p
        lanes = ~same.all(0)
        bad = lanes if bad is None else bad | lanes
    return int(bad.sum())


def _compare(kernel_rows, plain_rows, int_eq):
    """Lane agreement of float rows: kernel_rows / plain_rows map a name to
    an [R, N] tensor. Returns (summary dict, max_abs_err over lanes whose
    integer rows agree)."""
    import torch
    rows = {}
    max_err = 0.0
    for name, k in kernel_rows.items():
        p = plain_rows[name]
        for r in range(k.shape[0]):
            ok = torch.isclose(k[r], p[r], rtol=TOL, atol=TOL, equal_nan=True)
            rows[f"{name}{r}"] = float(ok.float().mean())
            both = int_eq & torch.isfinite(k[r]) & torch.isfinite(p[r])
            if both.any():
                max_err = max(max_err, float((k[r] - p[r])[both].abs().max()))
    return dict(int_lanes_equal=float(int_eq.float().mean()),
                worst_float_row=min(rows.values()), float_rows=rows,
                max_abs_err=max_err), max_err


def _compare_state(kernel_out, plain_out):
    """Agreement of one bounce's (fs, is_, hit) with K1's criteria."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    (kf, ki, kh), (pf, pi, ph) = kernel_out, plain_out
    int_eq = (ki == pi).all(0) & (kh[1] == ph[1])
    summary, max_err = _compare(dict(fs=kf, hit=kh), dict(fs=pf, hit=ph),
                                int_eq)
    mean_k = float(kf[bf.FS_L:bf.FS_L + 3].mean())
    mean_p = float(pf[bf.FS_L:bf.FS_L + 3].mean())
    summary.update(L_mean_kernel=mean_k, L_mean_plain=mean_p,
                   L_mean_rel=abs(mean_k - mean_p) / max(abs(mean_p), 1e-30))
    return summary, max_err


def _state_ok(summary):
    return (summary["int_lanes_equal"] >= LANE_FRACTION
            and summary["worst_float_row"] >= LANE_FRACTION
            and summary["L_mean_rel"] <= MEAN_RTOL)


# K1's audit of each phase's comparison launches (_k1_audited,
# _k1_report): the lanes whose outputs differ bit-wise from the plain
# version's, and K1's screen counters over those launches
# (bounce_fused.bounce_screen_stats)
K1_AUDIT = {}


def _k1_audited(phase, run, plain):
    """K1's outputs of `run`, one launch compared with `plain` (the plain
    version's outputs on the same inputs), with the screen counters on;
    adds its differing lanes and its counts to `phase`'s audit."""
    import torch

    from rtxpt_tpu_torch.pt import bounce_fused as bf
    dev = torch.device("cuda:0")
    bf.bounce_screen_stats(dev, True)
    kern = run()
    counts = bf.bounce_screen_stats(dev, False)
    audit = K1_AUDIT.setdefault(phase, dict(
        comparisons=0, lanes=0, lanes_differ=0,
        **dict.fromkeys(bf.SCREEN_COUNTS, 0)))
    audit["comparisons"] += 1
    audit["lanes"] += int(kern[0].shape[1])
    audit["lanes_differ"] += _lanes_differ(kern, plain)
    for key in bf.SCREEN_COUNTS:
        audit[key] += counts[key]
    return kern


def _pct(share):
    return "none" if share is None else f"{share:.5%}"


def _k1_report(record, phase, dump):
    """Print and record `phase`'s K1 audit. A pair that the exact test
    accepts and the screen rejected fails the run."""
    a = K1_AUDIT.get(phase)
    if a is None:
        _fail(f"{phase}: no K1 comparison was audited")

    def share(passed, pairs):
        return a[passed] / a[pairs] if a[pairs] else None
    a = dict(a, share=share("passed", "pairs"),
             shadow_share=share("shadow_passed", "shadow_pairs"))
    record.setdefault("k1_audit", {})[phase] = a
    print(f"{phase} K1: {a['lanes_differ']} of {a['lanes']} lanes differ "
          f"bit-wise from the plain version over {a['comparisons']} "
          f"launches (expected 0); screen pass share {_pct(a['share'])} of "
          f"{a['pairs']} closest-hit pairs, {_pct(a['shadow_share'])} of "
          f"{a['shadow_pairs']} shadow pairs, {a['ended_early']} shadow "
          f"walks ended early, {a['missed']} accepted pairs missed",
          flush=True)
    if a["missed"]:
        dump()
        _fail(f"{phase}: K1's screen rejected {a['missed']} pairs that the "
              f"exact test accepts")


# K1's times before its redesign for the tensor cores (CUDA cores, one
# thread per ray: PERF.md's K1 row, "NVIDIA H100 80GB HBM3, 700.00 W"),
# printed beside this run's per-frame device time: the bounce-0 launch of
# 2^18 rays, and the NEE-AT rooms frame's K1 device time (PR 3's profile)
K1_BEFORE = {"cornell": "0.1466 ms per slot-2 launch",
             "rooms": "0.6912 ms per slot-3 launch, 24.3 ms per frame",
             "kitchen": "1.5067-1.5310 ms per slot-5 texture launch"}


# K9's and K2's times and bounds before their redesign (the threaded
# skip-link walk and one thread per lane over the whole table: PERF.md's K9
# and K2 rows, "NVIDIA H100 80GB HBM3, 700.00 W"), printed beside this run's
# figures
K9_BEFORE = {"city": "1.767-1.820 ms per 1080p bounce-0 launch, bound "
                     "0.1196 ms; 2.1 ms per closest-hit launch over a frame",
             "foliage": "0.1051-0.1112 ms per 2^18-ray omm launch, bound "
                        "0.0051 ms"}
K2_BEFORE = {"rooms": "0.2922 ms per 2^18-lane launch, bound 0.0119 ms "
                      "(38 f32 a pair); 9.0 ms per NEE-AT frame",
             "curtain": "0.0317-0.0358 ms per omm launch, bound 0.0031 ms"}


def _k1_frame(prof):
    """K1's device time (ms) and launches in a profile: every kernel of
    its two libraries."""
    return _kernel_frame(prof, r"bounce_fused(_restart)?_kernel")


def _kernel_frame(prof, pattern):
    """The device time (ms) and launches in a profile of the kernels whose
    name matches `pattern`."""
    from torch.autograd import DeviceType
    ms, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and re.search(pattern,
                                                            evt.key):
            ms += getattr(evt, "self_device_time_total", getattr(
                evt, "self_cuda_time_total", 0.0)) / 1e3
            launches += evt.count
    return dict(ms=ms, launches=launches)


def main(record_path=None, group_path=None):
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
    built = kernels.build_all()
    record["build"] = {}
    for lib in kernels.LIBRARIES:
        ptxas = _ptxas_summary(lib.ptxas_log)
        record["build"][lib.name] = dict(seconds=lib.build_seconds, **ptxas,
                                         ptxas_log=lib.ptxas_log)
        print(f"build ok: {lib.name} in {lib.build_seconds:.1f}s, "
              f"{ptxas['registers']} registers, spill stores "
              f"{ptxas['spill_store_bytes']} B, spill loads "
              f"{ptxas['spill_load_bytes']} B", flush=True)
    print(f"build: {len(kernels.LIBRARIES)} libraries in "
          f"{built['wall']:.1f}s wall", flush=True)
    # K3, K5, K6 and K7 take their products on the tensor cores: HMMA
    # (mma.sync) or HGMMA (wgmma) in the SASS of each variant
    for label, key, lib, entries in (
            ("K3", "k3", kernels.CLUSTER_CLOSEST,
             kernels.CLUSTER_CLOSEST_ENTRIES),
            ("K5", "k5", kernels.CLUSTER_SHADOW,
             kernels.CLUSTER_SHADOW_ENTRIES),
            ("K6 and K7", "k6_k7", kernels.CLUSTER_ROWS,
             kernels.CLUSTER_ROWS_ENTRIES),
            ("K1", "k1", kernels.BOUNCE_FUSED,
             {k: v for k, v in kernels.BOUNCE_FUSED_ENTRIES.items()
              if "_inj" not in k}),
            ("K1's restart", "k1_restart", kernels.BOUNCE_FUSED_RESTART,
             {k: v for k, v in kernels.BOUNCE_FUSED_ENTRIES.items()
              if "_inj" in k}),
            ("K2", "k2", kernels.SHADOW_OCCLUSION,
             kernels.SHADOW_OCCLUSION_ENTRIES)):
        sass = lib.sass_opcodes(kernels.TENSOR_OPCODES)
        tc = {}
        for name, needle in entries.items():
            counts = [c for fn, c in sass.items() if needle in fn]
            tc[name] = counts[0] if len(counts) == 1 else None
        record["build"][f"{key}_tensor_ops"] = tc
        print(f"build: {label} tensor-core instructions in SASS: "
              f"{json.dumps(tc)}", flush=True)
        if not all(c and sum(c.values()) > 0 for c in tc.values()):
            dump()
            _fail(f"build: a {label} variant has no tensor-core instruction")
    # the registers, stack frame and spills of K1's 32 instantiations
    k1_regs = {name: _ptxas_entry(
        (kernels.BOUNCE_FUSED_RESTART if "_inj" in name
         else kernels.BOUNCE_FUSED).ptxas_log, needle)
        for name, needle in kernels.BOUNCE_FUSED_ENTRIES.items()}
    record["build"]["k1_ptxas"] = k1_regs
    print("build: K1 registers / stack / spill stores / spill loads: "
          + ", ".join(f"{name[len('bounce_fused'):] or '_'} "
                      f"{r['registers']}/{r['stack_bytes']}/"
                      f"{r['spill_store_bytes']}/{r['spill_load_bytes']}"
                      for name, r in k1_regs.items()), flush=True)
    # K9's four instantiations and K2's screen and exact kernels
    k9_k2 = {name: _ptxas_entry(kernels.BVH_TRAVERSE.ptxas_log, needle)
             for name, needle in kernels.BVH_TRAVERSE_ENTRIES.items()}
    for name, needle in kernels.SHADOW_OCCLUSION_ENTRIES.items():
        for tail, form in (("", "screen"), ("_exact", "exact")):
            k9_k2[f"{name}_{form}"] = _ptxas_entry(
                kernels.SHADOW_OCCLUSION.ptxas_log,
                needle.replace("kernelILb", f"kernel{tail}ILb"))
    record["build"]["k9_k2_ptxas"] = k9_k2
    print("build: K9 and K2 registers / stack / spill stores / spill loads: "
          + ", ".join(f"{name} {r['registers']}/{r['stack_bytes']}/"
                      f"{r['spill_store_bytes']}/{r['spill_load_bytes']}"
                      for name, r in k9_k2.items()), flush=True)
    if any(r["registers"] is None or r["spill_store_bytes"]
           for r in k9_k2.values()):
        dump()
        _fail("build: a K9 or K2 instantiation is missing or spills")
    # K8's two routes (the tensor-core route's HMMA count) and K4's sixteen
    # instantiations, with the dynamic shared memory of K4's stage
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    sass8 = kernels.BRUTE_CLOSEST.sass_opcodes(kernels.TENSOR_OPCODES)
    k8_k4 = {}
    for name, needle in kernels.BRUTE_CLOSEST_ENTRIES.items():
        k8_k4[name] = dict(
            _ptxas_entry(kernels.BRUTE_CLOSEST.ptxas_log, needle),
            hmma=sum(sum(c.values()) for fn, c in sass8.items()
                     if needle in fn))
    for name, needle in kernels.CLUSTER_SHADE_ENTRIES.items():
        k8_k4[name] = dict(
            _ptxas_entry(kernels.CLUSTER_SHADE.ptxas_log, needle),
            stage_bytes=BC.shade_stage_rows(
                "_tex" in name, "_omm" in name, "_split" in name)[1])
    record["build"]["k8_k4_ptxas"] = k8_k4
    print("build: K8 and K4 registers / stack / spill stores / spill loads "
          "/ static shared memory (+ K4's stage, + K8's HMMA): "
          + ", ".join(f"{name} {r['registers']}/{r['stack_bytes']}/"
                      f"{r['spill_store_bytes']}/{r['spill_load_bytes']}/"
                      f"{r['static_smem_bytes']}"
                      + (f" + {r['stage_bytes']}" if "stage_bytes" in r
                         else f" HMMA {r['hmma']}")
                      for name, r in k8_k4.items()), flush=True)
    if any(r["registers"] is None for r in k8_k4.values()) \
            or not k8_k4["brute_closest_mma"]["hmma"]:
        dump()
        _fail("build: a K8 or K4 instantiation is missing, or K8's "
              "tensor-core route has no HMMA")

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
    k1_err = 0.0
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, tables, kcfg, sample)
        if b in (0, 2):
            kern = _k1_audited("k1", lambda: bf.bounce(
                fs, is_, tables, kcfg, sample), plain)
            summary, err = _compare_state(kern, plain)
            k1_err = max(k1_err, err)
            k1[f"bounce{b}"] = summary
            print(f"k1 bounce {b}: int lanes equal "
                  f"{summary['int_lanes_equal']:.6f}, worst float row "
                  f"{summary['worst_float_row']:.6f}, L mean "
                  f"{summary['L_mean_kernel']:.6f} vs "
                  f"{summary['L_mean_plain']:.6f}, max abs err {err:.3g}",
                  flush=True)
            if not _state_ok(summary):
                record["k1"] = k1
                dump()
                _fail(f"k1: kernel disagrees with its plain version at "
                      f"bounce {b}")
        fs, is_ = plain[0], plain[1]          # carry the state onward
    _k1_report(record, "k1", dump)
    # time both at the Cornell path's launch width (2^18 rays, bounce 0)
    side_t = 512                                   # RAYS_TIMED rays
    cam_t = default_camera(host, side_t, side_t, device=dev)
    px_t, py_t = _pixel_grid(side_t, side_t, dev)
    o, d, spread = camera_rays(cam_t, cfg_k1, px_t, py_t, sample)
    fs_t, is_t = bf.initial_state(o, d, spread, px_t, py_t)
    k1_ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tables, kcfg, sample), 20)
    plain_ms = _cuda_ms(
        lambda: bf.bounce_reference(fs_t, is_t, tables, kcfg, sample), 3)
    # bound: each state row read and written once, the tables read once;
    # operations: every active lane against every triangle for its closest
    # hit, each shadow ray up to its first occluder (_k1_ops)
    tests = int((is_t[bf.IS_ACTIVE] > 0).sum()) * tables.n_tris \
        + _k1_shadow_pairs(lambda: bf.bounce_reference(
            fs_t, is_t, tables, kcfg, sample))
    k1_bytes = RAYS_TIMED * 4 * (2 * (bf.NF + bf.NI) + bf.NH) + 4 * sum(
        t.numel() for t in (tables.tri_coef, tables.attr_rows,
                            tables.mat_rows, tables.light_rows))
    k1_bound, k1_by, _ = _bound(k1_bytes, **_k1_ops(tables.n_tris, tests))
    k1.update(ms=k1_ms, plain_ms=plain_ms, rays=RAYS_TIMED,
              bound_ms=k1_bound, bound_by=k1_by)
    record["k1"] = k1
    print(f"k1 ok: {RAYS_TIMED} rays/launch, kernel {k1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}) ({smi})",
          flush=True)

    # ---- 4. golden --------------------------------------------------------
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "goldens", "cornell_32_8spp.npy")
    import numpy as np
    golden = np.load(golden_path)
    before = kernels.launches["bounce_fused"]
    cam32 = default_camera(host, 32, 32, device=dev)
    bf.bounce_screen_stats(dev, True)
    hdr, _, _ = render(scene, cam32, PathTracerConfig(max_bounces=3),
                       32, 32, spp=8)
    screen = bf.bounce_screen_stats(dev, False)
    img = hdr.cpu().numpy()
    e, p = rmse(img, golden), psnr(img, golden)
    used = kernels.launches["bounce_fused"] - before
    # the same render through the plain version on the card: the pixels
    # whose radiance differs bit-wise
    kernel_bounce = bf.bounce
    bf.bounce = bf.bounce_reference
    try:
        hdr_p, _, _ = render(scene, cam32, PathTracerConfig(max_bounces=3),
                             32, 32, spp=8)
    finally:
        bf.bounce = kernel_bounce
    px_differ = int((hdr.view(torch.int32) != hdr_p.view(torch.int32))
                    .any(-1).sum())
    record["golden"] = dict(rmse=e, psnr=p, launches=used,
                            pixels_differ=px_differ, screen=screen)
    print(f"golden: RMSE {e:.6f} PSNR {p:.2f} dB over {used} K1 launches; "
          f"{px_differ} of 1024 pixels differ bit-wise from the plain "
          f"version's render (expected 0); K1 screen pass share "
          f"{_pct(screen['share'])} closest hit, "
          f"{_pct(screen['shadow_share'])} shadow rays, {screen['missed']} "
          f"accepted pairs missed",
          flush=True)
    if not (e < 5e-3 and p > 40 and used == 8 * 3) or screen["missed"]:
        dump()
        _fail("golden: the kernel-rendered Cornell box misses the golden")

    # ---- 5. the Cornell path -------------------------------------------------
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
    cornell_launches = dict(kernels.launches)
    rays = int(rays)
    hdr = acc / spp
    finite = bool(torch.isfinite(hdr).all())
    want = n_chunks * cfg.max_bounces * spp
    mrays = rays / dt / 1e6
    ms_frame = dt / spp * 1e3
    record["main"] = dict(res=f"{width}x{height}", spp_timed=spp,
                          bounces=cfg.max_bounces, chunks=n_chunks,
                          launches=cornell_launches, expected=want,
                          rays=rays, seconds=dt, mrays_per_s=mrays,
                          ms_per_frame_1spp=ms_frame,
                          L_mean=float(hdr.mean()), finite=finite,
                          tier=out["kernel_tier"], card=smi)
    print(f"main: Cornell {width}x{height} {cfg.max_bounces} bounces, "
          f"{spp} spp: {mrays:.3f} Mrays/s, {ms_frame:.3f} ms per 1-spp "
          f"frame, {rays} rays, K1 launches "
          f"{cornell_launches.get('bounce_fused', 0)} of {want}, mean L "
          f"{float(hdr.mean()):.5f} ({smi})", flush=True)
    if cornell_launches.get("bounce_fused", 0) != want or not finite \
            or out["kernel_tier"] != "fused":
        dump()
        _fail("main: the Cornell path did not run every bounce through K1 "
              "or gave non-finite values")
    # one profiled frame: K1's device time and launches per frame
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_sample(scene, cam_m, cfg, width, height, spp + 1)
        torch.cuda.synchronize()
    record["main"]["k1_frame"] = k1_frame = _k1_frame(prof)
    print(f"main: K1 {k1_frame['ms']:.3f} ms of device time per profiled "
          f"1-spp frame over {k1_frame['launches']} launches (before its "
          f"redesign: {K1_BEFORE['cornell']}) ({smi})", flush=True)
    dump()

    # ---- 6-8. the city ----------------------------------------------------
    clustered = _clustered_kernels(record, dev, smi, dump)
    _city_parity(record, dev, dump)
    city_launches, city_images = _city_path(record, dev, smi, dump,
                                            clustered["scene"])

    # ---- 9. external NEE ----------------------------------------------------
    ext = _external_nee(record, dev, smi, dump)

    # ---- 10. the general tier -----------------------------------------------
    general = _general_tier(record, dev, smi, dump, clustered["scene"],
                            city_images)

    # ---- 11. instancing -----------------------------------------------------
    instanced = _instancing(record, dev, smi, dump, clustered["scene"])

    # ---- 12. the environment and the clustered external NEE ----------------
    env = _environment(record, dev, smi, dump, clustered["scene"])

    # ---- 13. textures, normal maps, stochastic texture filtering -----------
    tex = _textures(record, dev, smi, dump)

    # ---- 14. opacity micromaps and alpha-tested geometry -------------------
    alpha = _alpha(record, dev, smi, dump)

    # ---- 15. nested dielectric priorities and Bistro -----------------------
    prio = _priorities(record, dev, smi, dump)

    # ---- 16. the per-row clustered route (K6, K7) ---------------------------
    per_row = _per_row(record, dev, smi, dump, clustered["scene"],
                       group_path)

    # ---- 17. the split channels and the aux guide buffers -------------------
    split = _split_aux(record, dev, smi, dump, clustered["scene"])

    # ---- 18. real-time mode: the V-buffer restart, the denoisers, TAA -------
    rt = _realtime(record, dev, smi, dump, clustered["scene"])

    # ---- 19. the probes K10-K12 beside K3 ------------------------------------
    probes = _probes(record, dev, smi, dump)

    k1_paths = dict(cornell=cornell_launches["bounce_fused"],
                    **{k: v.get("bounce_fused", 0)
                       for k, v in ext["launches"].items()})
    entries = [dict(
        name="bounce_fused", route="cuda",
        source="rtxpt_tpu_torch/csrc/bounce_fused.cu",
        replaces="rtxpt_tpu/pt/bounce_pallas.py:1389",
        launches=sum(k1_paths.values()), launches_by_path=k1_paths,
        max_abs_err=max(k1_err, ext["k1_err"]),
        ms=k1_ms, plain_ms=plain_ms, bound_ms=k1_bound, bound_by=k1_by,
        library_ms=None, modes=ext["k1_modes"])]
    k2_paths = dict(ext["launches"],
                    tex_kitchen=tex["launches"]["kitchen"])
    entries.append(dict(
        ext["k2"], launches=sum(v.get("shadow_occlusion", 0)
                                for v in k2_paths.values()),
        launches_by_path={k: v.get("shadow_occlusion", 0)
                          for k, v in k2_paths.items()}))
    for name, entry in clustered["kernels"].items():
        by_path = dict(city=city_launches.get(name, 0),
                       tex_city=tex["launches"]["city"].get(name, 0),
                       **{k: v.get(name, 0)
                          for k, v in env["launches"].items()
                          if k != "sky_cornell"})
        if name in ("cluster_closest", "cluster_shadow"):
            entry = dict(entry, max_abs_err=max(
                entry["max_abs_err"],
                tex["k3_err" if name == "cluster_closest" else "k5_err"]))
        entry = dict(entry, launches=city_launches.get(name, 0),
                     launches_by_path=by_path)
        if name == "cluster_shade":
            # K4's export slots, timed and checked in phase 12
            entry.update(modes=env["k4_modes"], max_abs_err=max(
                entry["max_abs_err"], env["k4_export_err"]))
        entries.append(entry)
    entries.extend(general)
    entries.extend(instanced)
    entries.extend(env["entries"].values())
    entries.extend(tex["entries"].values())
    entries.extend(alpha["entries"].values())
    entries.extend(prio["entries"].values())
    entries.extend(per_row["entries"].values())
    entries.extend(split["entries"].values())
    entries.extend(rt["entries"].values())
    entries.extend(probes["entries"].values())
    # Bistro's launches of the micromap variants that phase 14 checks
    for entry in entries:
        n_bistro = prio["launches"]["bistro"].get(entry["name"], 0)
        if n_bistro and entry["name"] != "cluster_shade_omm_tex_prio":
            entry.setdefault("launches_by_path", {})["bistro"] = n_bistro
            entry["launches"] += n_bistro
        n_gen = prio["launches"]["bistro_general"].get(entry["name"], 0)
        if n_gen:
            entry.setdefault("launches_by_path", {})["bistro_general"] = \
                n_gen
            entry["launches"] += n_gen
    # the split paths' launches of kernels that earlier phases time (K2 on
    # the rooms, K3 and K5 on the city)
    for entry in entries:
        for path, counts in split["launches"].items():
            n_split = counts.get(entry["name"], 0)
            if n_split and not entry["name"].endswith("_split"):
                entry.setdefault("launches_by_path", {})[
                    f"split_{path}"] = n_split
                entry["launches"] += n_split
    # the real-time paths' launches of kernels that earlier phases time
    for entry in entries:
        for path, counts in rt["launches"].items():
            n_rt = counts.get(entry["name"], 0)
            if n_rt and entry["name"] != "bounce_fused_inj":
                entry.setdefault("launches_by_path", {})[
                    f"realtime_{path}"] = n_rt
                entry["launches"] += n_rt
    # the texture paths' launches of kernels that earlier phases time
    tex_paths = dict(brute_closest=("kitchen_general",),
                     bounce_fused_final=("cornell", "kitchen"),
                     cluster_shade_final=("city",))
    for entry in entries:
        for path in tex_paths.get(entry["name"], ()):
            entry.setdefault("launches_by_path", {})[f"tex_{path}"] = \
                tex["launches"][path].get(entry["name"], 0)
    # K8 at the kitchen's general-tier launch (phase 13, the tensor-core
    # route) and the stable-planes BUILD launches (phase 18), beside 2^18
    for entry in entries:
        if entry["name"] == "brute_closest":
            entry["shapes"] = {
                f"{a['rays']}_rays_{a['triangles']}_tris_launch{a['launch']}":
                {k: a[k] for k in ("ms", "bound_ms", "bound_by",
                                   "plain_count_bound_ms", "route",
                                   "lanes_differ") if k in a}
                for a in tex["k8_kitchen"] + rt["k8_build"]}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _city_host(seed=CITY_SEED):
    from rtxpt_tpu_torch.scene.procedural import city_overview, city_scene
    return city_overview(city_scene(CITY_TRIS, seed=seed))


def _clustered_kernels(record, dev, smi, dump):
    """Phase 6: K3, K4 and K5 against their plain versions on the city,
    and their times. Returns dict(scene=(host, scene, prepare seconds),
    kernels={name: partial kernel-line entry})."""
    import torch

    from rtxpt_tpu_torch.prepare import prepare

    t0 = time.perf_counter()
    host = _city_host()
    scene = prepare(host, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    return _cluster_kernel_checks(record, dev, smi, dump, "clustered", host,
                                  scene, prep_s, CITY_PAGES)


def _ptxas_entry(log, needle):
    """(registers, stack frame bytes, spill store bytes, spill load bytes,
    static shared memory bytes) of the entry function whose mangled name
    contains `needle`, from a ptxas -v log."""
    regs = stack = spill_st = spill_ld = smem = None
    current = False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = needle in m.group(1)
            continue
        if not current:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spill_st, spill_ld = (int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            smem = int(m.group(1)) if m else 0
    return dict(registers=regs, stack_bytes=stack, spill_store_bytes=spill_st,
                spill_load_bytes=spill_ld, static_smem_bytes=smem)


def _cluster_kernel_checks(record, dev, smi, dump, label, host, scene,
                           prep_s, pages_want, deep_bounces=(2,), stf=False,
                           omm=False, floors=True):
    """K3, K4 and K5 (their instanced variants on instanced tables)
    against their plain versions, every page: at bounce 0 on 65,536 camera
    rays spread over the scene's 1080p frame, and at each of
    `deep_bounces` on the 64 contiguous groups of the sorted 1080p
    wavefront with the most hits, the wavefront carried there by the
    kernels; then each kernel timed at the 1080p bounce-0 launch beside
    its bound, and the plain versions at the comparison width. `stf`:
    stochastic texture filtering, so that K4 runs its texture variant on
    tables with textures. `omm` (tables with micromaps, with `stf`): the
    micromap variants of K3, K4 and K5, and at each compared bounce at
    least MIXED_SHARE of the lanes must hit a MIXED triangle and
    UNKNOWN_SHARE an UNKNOWN (or near-edge) micro-cell (`floors`; the
    shares are reported either way).
    Returns dict(scene=(host, scene, prepare seconds), kernels={name:
    partial kernel-line entry}, shares={bounce: (mixed, unknown)})."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
    from rtxpt_tpu_torch.scene.procedural import default_camera

    tbl = scene.cluster_tables
    inst = tbl.instanced
    xf = tbl.xf
    k3n, k5n = (("cluster_closest_inst", "cluster_shadow_inst") if inst
                else ("cluster_closest", "cluster_shadow"))
    cfg = dispatch.resolve(scene, PathTracerConfig(
        max_bounces=4, nee=NEEMode.POWER, ray_chunk=1 << 30,
        stochastic_texture_filtering=stf), dev)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    # K4's texture and environment variants on tables with them
    k4_tex = bf.use_tex(tbl, kcfg)
    if omm and not (tbl.omm and k4_tex):
        _fail(f"{label}: the scene's tables run no micromap variants")
    k4n = bf.variant_name("cluster_shade", tbl.env is not None, False, k4_tex,
                          omm)
    micro = dict(micro=tbl.omm_word) if omm else {}
    micro_cov = dict(micro=tbl.omm_word, cover=tbl.omm_cov) if omm else {}
    if omm:
        k3n, k5n = k3n + "_omm", k5n + "_omm"
    shares = {}
    kslots, pages = cfg.cluster_kslots, cfg.cluster_pages
    max_travel = float(cfg.max_ray_travel)
    bounds = BC.scene_bounds(tbl)
    sample = 1
    print(f"{label}: {tbl.n_tris} triangles, {tbl.blocks.shape[0]} blocks, "
          f"{tbl.n_clusters} cull candidates, {tbl.n_lights} lights, "
          f"prepare {prep_s:.2f}s, kslots {kslots}, pages {pages}",
          flush=True)
    if pages != pages_want:
        _fail(f"{label}: the scene resolves to {pages} pages, not "
              f"{pages_want}")

    def camera_state(cols, rows):
        """Camera rays of a cols x rows grid of the city frame's pixels."""
        w, h = CITY_FRAME
        cam = default_camera(host, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        fs, is_ = bf.initial_state(o, d, spread, px, py)
        return fs, is_, torch.arange(fs.shape[1], dtype=torch.int32,
                                     device=dev)

    def closest_inputs(fs, is_):
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, max_travel, tbl, kslots)
        return od, BC.map_cand_inst(cand, tbl, kslots)

    def shadow_inputs(sh):
        shp, _ = BC.sort_shadows(sh, bounds)
        dop = shp[BC.SH_DO] > 0.5
        cand, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3], shp[BC.SH_D:BC.SH_D + 3],
                          dop, torch.where(dop, shp[BC.SH_DIST], -3e38), tbl,
                          kslots)
        return shp, BC.map_cand_inst(cand, tbl, kslots)

    # comparison, every page: bounce 0 on 65,536 camera rays spread over
    # the frame; each of `deep_bounces` on a window of as many contiguous
    # groups of the sorted 1080p wavefront, which the kernels carry there
    # as on the city path (the spread rays' wide groups overflow their cull
    # lists past bounce 0 and keep almost no hits). The window is the one
    # whose lanes the kernels found most hits for at that bounce. The paged
    # loops call the module's closest_hit and occlusion: these run both
    # versions, keep the pair and return the plain result.
    rec = {}
    err = {k3n: 0.0, k4n: 0.0, k5n: 0.0}
    plain_in = {}
    pairs = dict(k3=[], k5=[])

    kernel_closest, kernel_occlusion = BC.closest_hit, BC.occlusion

    def closest_both(cand, od, blocks, kslots_, max_travel_, noprune,
                     xf=None, micro=None):
        ha_p, vis_p = BC.closest_hit_reference(cand, od, blocks, kslots_,
                                               max_travel_, noprune, True,
                                               xf=xf, micro=micro)
        plain_in.setdefault("cand", cand)
        plain_in.setdefault("od", od)
        pairs["k3"].append((kernel_closest(
            cand, od, blocks, kslots_, max_travel_, noprune, True,
            xf=xf, micro=micro), (ha_p, vis_p)))
        return ha_p

    def occluded_both(cand, shp_, blocks, kslots_, xf=None, micro=None,
                      cover=None):
        occ_p, tst_p = BC.occlusion_reference(cand, shp_, blocks, kslots_,
                                              True, xf=xf, micro=micro,
                                              cover=cover)
        plain_in.setdefault("cand_s", cand)
        plain_in.setdefault("shp", shp_)
        pairs["k5"].append((kernel_occlusion(
            cand, shp_, blocks, kslots_, True, xf=xf, micro=micro,
            cover=cover), (occ_p, tst_p)))
        return occ_p

    def compare_at(b, fs, is_, rows):
        """K3, K4 and K5 against their plain versions through bounce `b`
        of the sorted rows fs, is_; fails on a disagreement or when fewer
        than MIN_HIT_SHARE of the lanes hit."""
        pairs["k3"].clear()
        pairs["k5"].clear()
        BC.closest_hit, BC.occlusion = closest_both, occluded_both
        try:
            ha_p, _ = BC.closest_paged(fs, is_, tbl, kslots, pages,
                                       max_travel, omm=omm)
            ha_w = BC.post_attr_inst(ha_p, tbl)
            sh_out = BC.shade_reference(ha_w, fs, is_, tbl, kcfg, sample,
                                        omm=omm)
            plain_in.setdefault("ha", ha_w)
            plain_in.setdefault("fs", fs)
            plain_in.setdefault("is_", is_)
            shp, _ = BC.sort_shadows(sh_out[2], bounds)
            BC.occlusion_screen_stats(dev, True)
            BC.occluded_paged(shp, tbl, kslots, pages, omm)
            screen = BC.occlusion_screen_stats(dev, False)
        finally:
            BC.closest_hit, BC.occlusion = kernel_closest, kernel_occlusion
        k4 = BC.shade(ha_w, fs, is_, tbl, kcfg, sample, omm=omm)
        torch.cuda.synchronize()
        # K3 against its plain version, the pages' lanes and groups
        # together: BC.closest_agreement's tolerance (the products' order)
        k3s = BC.closest_agreement(
            torch.cat([k[0] for k, _ in pairs["k3"]], 1),
            torch.cat([k[1] for k, _ in pairs["k3"]]),
            torch.cat([p[0] for _, p in pairs["k3"]], 1),
            torch.cat([p[1] for _, p in pairs["k3"]]))
        k3s["pages"] = len(pairs["k3"])
        for (ha_k, _), (ha_q, _) in pairs["k3"]:
            same = ha_k[BC.HA_PRIM] == ha_q[BC.HA_PRIM]
            _, e3 = _compare(dict(ha=ha_k[BC.HA_T:BC.HA_FRONT + 1]),
                             dict(ha=ha_q[BC.HA_T:BC.HA_FRONT + 1]), same)
            err[k3n] = max(err[k3n], e3)
        hit = ha_p[BC.HA_PRIM] >= 0
        k3s["hit_share"] = float(hit.float().mean())
        if omm:
            # micromap exercise: winners on MIXED triangles, and on
            # UNKNOWN or near-edge micro-cells (HA_UNK)
            cls = scene.tri_opacity[torch.clamp(ha_p[BC.HA_PRIM],
                                                min=0).long()]
            act = is_[bf.IS_ACTIVE] > 0
            mixed = float((hit & (cls == 1))[act].float().mean())
            unk = float((ha_p[BC.HA_UNK] > 0.5)[act].float().mean())
            k3s.update(mixed_share=mixed, unknown_share=unk)
            shares[b] = (mixed, unk)
        if inst:
            k3s["instances_hit"] = int(torch.unique(
                ha_p[BC.HA_INST][hit]).numel())
        k4s, e4 = _compare_state((k4[0], k4[1], k4[3]),
                                 (sh_out[0], sh_out[1], sh_out[3]))
        shs, e4s = _compare(dict(sh=k4[2]), dict(sh=sh_out[2]),
                            (k4[1] == sh_out[1]).all(0))
        k4s.update(worst_sh_row=shs["worst_float_row"])
        err[k4n] = max(err[k4n], e4, e4s)
        requested = shp[BC.SH_DO] > 0.5
        k5s = dict(occ_lanes_equal=1.0, tests_equal=True, differ=0,
                   requests=int(requested.sum()), pages=len(pairs["k5"]),
                   screen=screen)
        for (occ_k, tst_k), (occ_q, tst_q) in pairs["k5"]:
            k5s["occ_lanes_equal"] = min(k5s["occ_lanes_equal"], float(
                (occ_k == occ_q).float().mean()))
            k5s["differ"] += int((occ_k != occ_q).sum())
            k5s["tests_equal"] &= bool(torch.equal(tst_k, tst_q))
            err[k5n] = max(err[k5n], float((occ_k - occ_q).abs().max()))
        rec[f"bounce{b}"] = dict(rows=rows, k3=k3s, k4=k4s, k5=k5s)
        print(f"{label} bounce {b} ({rows}): K3 prim/inst/unk equal "
              f"{k3s['key_equal']:.6f} ({k3s['differ']} lanes differ, refit "
              f"t within {k3s['t_rel_max']:.3g} rel), HA rows of the same "
              f"hits not bit-equal on {k3s['hit_rows_differ']} lanes, "
              f"misses with other rejected rows {k3s['miss_other_rows_differ']}"
              f", visits equal on {k3s['groups_visits_equal']} of "
              f"{k3s['groups']} groups ({k3s['visits_kernel']} vs "
              f"{k3s['visits_plain']}) over {k3s['pages']} pages, hit share "
              f"{k3s['hit_share']:.4f}; K4 int lanes "
              f"{k4s['int_lanes_equal']:.6f}, worst float row "
              f"{min(k4s['worst_float_row'], shs['worst_float_row']):.6f}, "
              f"L mean rel {k4s['L_mean_rel']:.3g}; K5 occlusion equal "
              f"{k5s['occ_lanes_equal']:.6f} over {k5s['requests']} "
              f"requests ({k5s['differ']} lanes differ), tests equal "
              f"{k5s['tests_equal']}, screen pass share "
              f"{_share(screen)} ({screen['passed']} of {screen['pairs']} "
              f"pairs, {screen['overflowed']} lists overflowed)", flush=True)
        ok = (k3s["ok"] and k5s["tests_equal"]
              and _state_ok(k4s)
              and shs["worst_float_row"] >= LANE_FRACTION
              and k5s["occ_lanes_equal"] >= LANE_FRACTION)
        if omm:
            print(f"{label} bounce {b}: MIXED share {k3s['mixed_share']:.4f}"
                  f", UNKNOWN share {k3s['unknown_share']:.4f} of the active "
                  f"lanes", flush=True)
        low = omm and floors and (k3s["mixed_share"] < MIXED_SHARE
                                  or k3s["unknown_share"] < UNKNOWN_SHARE)
        if not ok or k3s["hit_share"] < MIN_HIT_SHARE or low:
            record[label] = rec
            dump()
            _fail(f"{label}: a kernel disagrees with its plain version at "
                  f"bounce {b}" if not ok else
                  f"{label}: bounce {b}'s comparison rows hit too little "
                  f"({k3s['hit_share']:.4f} < {MIN_HIT_SHARE})" if not low
                  else f"{label}: bounce {b}'s rows exercise the micromaps "
                  f"too little")

    fs, is_, src = camera_state(CMP_SIDE, CMP_SIDE)
    cmp_groups = fs.shape[1] // BC.FL
    fs, is_, src = BC.sort_wavefront(fs, is_, src, True, bounds)
    compare_at(0, fs, is_, f"{CMP_SIDE}x{CMP_SIDE} camera rays spread over "
               "the frame")

    # the 1080p wavefront, carried by the kernels with the city path's
    # NEE add, and the window of each deeper bounce
    fs, is_, src = camera_state(*CITY_FRAME)
    for b in range(max(deep_bounces) + 1):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds)
        ha, _ = BC.closest_paged(fs, is_, tbl, kslots, pages, max_travel,
                                 omm=omm)
        if b in deep_bounces:
            run = torch.cumsum((ha[BC.HA_PRIM] >= 0).view(-1, BC.FL).sum(1),
                               0)
            run = torch.cat([run.new_zeros(1), run])
            g0 = int(torch.argmax(run[cmp_groups:] - run[:-cmp_groups]))
            lanes = slice(g0 * BC.FL, (g0 + cmp_groups) * BC.FL)
            compare_at(b, fs[:, lanes].contiguous(),
                       is_[:, lanes].contiguous(),
                       f"groups {g0}-{g0 + cmp_groups - 1} of the sorted "
                       f"{CITY_FRAME[0]}x{CITY_FRAME[1]} wavefront")
        if b == max(deep_bounces):
            break
        fs, is_, sh, _ = BC.shade(BC.post_attr_inst(ha, tbl), fs, is_, tbl,
                                  kcfg, sample, omm=omm)
        shp, perm = BC.sort_shadows(sh, bounds)
        occ, _ = BC.occluded_paged(shp, tbl, kslots, pages, omm)
        ok_nee = (sh[BC.SH_DO] > 0.5) \
            & (BC.unsort_rows(perm, occ[None])[0] < 0.5)
        fs = fs.clone()
        fs[bf.FS_L:bf.FS_L + 3] += torch.where(
            ok_nee, sh[BC.SH_CONTRIB:BC.SH_CONTRIB + 3], 0.0)

    # plain versions timed at the comparison width (65,536 rays, bounce 0)
    pin = plain_in
    plain_ms = {
        k3n: _cuda_ms(lambda: BC.closest_hit_reference(
            pin["cand"], pin["od"], tbl.blocks, kslots, max_travel, xf=xf,
            **micro), 1),
        k4n: _cuda_ms(lambda: BC.shade_reference(
            pin["ha"], pin["fs"], pin["is_"], tbl, kcfg, sample, omm=omm),
            3),
        k5n: _cuda_ms(lambda: BC.occlusion_reference(
            pin["cand_s"], pin["shp"], tbl.blocks, kslots, xf=xf,
            **micro_cov), 1)}

    # kernels timed at the 1080p bounce-0 launch
    fs, is_, src = camera_state(*CITY_FRAME)
    fs, is_, src = BC.sort_wavefront(fs, is_, src, True, bounds)
    od, cand = closest_inputs(fs, is_)
    g = cand.shape[0]
    n = g * BC.FL
    ms = {}
    ms[k3n] = _cuda_ms(lambda: BC.closest_hit(
        cand, od, tbl.blocks, kslots, max_travel, xf=xf, **micro), 3)
    ha, visits = BC.closest_hit(cand, od, tbl.blocks, kslots, max_travel,
                                stats=True, xf=xf, **micro)
    ha = BC.post_attr_inst(ha, tbl)
    ms[k4n] = _cuda_ms(lambda: BC.shade(ha, fs, is_, tbl, kcfg, sample,
                                        omm=omm), 10)
    sh = BC.shade(ha, fs, is_, tbl, kcfg, sample, omm=omm)[2]
    shp, cand_s = shadow_inputs(sh)
    ms[k5n] = _cuda_ms(lambda: BC.occlusion(
        cand_s, shp, tbl.blocks, kslots, xf=xf, **micro_cov), 3)
    BC.occlusion_screen_stats(dev, True)
    _, tests = BC.occlusion(cand_s, shp, tbl.blocks, kslots, stats=True,
                            xf=xf, **micro_cov)
    k5_screen = BC.occlusion_screen_stats(dev, False)

    # bounds at that launch: each input read once (the blocks' staged rows
    # once per distinct block, an instance's M10 once per distinct
    # instance), each output written once; operations: every active lane
    # against every triangle of each slot its group visited (K3), the
    # pairs K5's lanes tested up to their first occluder, and on instanced
    # tables K3's map of the ray operand per lane and visit (XFORM_F32;
    # K5's map is left out, as its stats count pairs and not visits: a
    # lower bound). With micromaps, K3 also reads each distinct block's
    # 128 words and K5 its words and coverages (OMM_WORD_BYTES per
    # triangle each); the micro-cell decode of the candidates that pass
    # the geometric test is left out (a lower bound)
    active_g = (is_[bf.IS_ACTIVE] > 0).view(g, BC.FL).sum(1)
    slots = torch.arange(kslots, device=dev)[None]
    base = BC.inst_base(kslots)

    def distinct(cand_, visited):
        ids = cand_[:, 0, 1:1 + kslots][visited]
        n_inst = (int(torch.unique(cand_[:, 0, base:base + kslots][visited])
                      .numel()) if inst else 0)
        return int(torch.unique(ids).numel()), n_inst

    k3_visited = slots < visits[:, None]
    k3_blocks, k3_insts = distinct(cand, k3_visited)
    hits = int((ha[BC.HA_PRIM] >= 0).sum())
    k3_bytes = 4 * (cand.numel() + od.numel() + ha.numel() + 42 * hits) \
        + STAGED_BLOCK_BYTES * k3_blocks + XF_BYTES * k3_insts \
        + (OMM_WORD_BYTES * 128 * k3_blocks if omm else 0)
    k3_visits = int((active_g * visits).sum())
    k3_pairs = k3_visits * 128
    k4_bytes = _k4_bytes(n, tbl, k4_tex, False, omm=omm)
    k5_blocks, k5_insts = distinct(cand_s, slots < cand_s[:, 0, :1])
    k5_bytes = 4 * (cand_s.numel() + (10 if omm else 9) * n) \
        + STAGED_BLOCK_BYTES * k5_blocks + XF_BYTES * k5_insts \
        + (2 * OMM_WORD_BYTES * 128 * k5_blocks if omm else 0)
    k5_pairs = int(tests.sum())
    map_ops = XFORM_F32 if inst else 0
    bounds_ms = {
        k3n: _bound(k3_bytes, f32=k3_pairs * K3_PAIR_F32
                    + k3_visits * map_ops, tf32=k3_pairs * PAIR_TF32,
                    bf16=k3_pairs * PAIR_BF16),
        k4n: _bound(k4_bytes),
        k5n: _bound(k5_bytes, f32=k5_pairs * K5_PAIR_F32,
                    tf32=k5_pairs * PAIR_TF32, bf16=k5_pairs * PAIR_BF16)}
    launch = dict(groups=g, active=int(active_g.sum()),
                  visits=int(visits.sum()), k3_blocks=k3_blocks,
                  k3_instances=k3_insts, k3_pairs=k3_pairs,
                  shadow_requests=int((shp[BC.SH_DO] > 0.5).sum()),
                  k5_pairs=k5_pairs, k5_blocks=k5_blocks,
                  k5_instances=k5_insts, k5_screen=k5_screen)
    libs = {k3n: kernels.CLUSTER_CLOSEST, k4n: kernels.CLUSTER_SHADE,
            k5n: kernels.CLUSTER_SHADOW}
    ptxas = {name: _ptxas_entry(lib.ptxas_log,
                                f"ILb{int(k4_tex)}ELb{int(omm)}ELb0ELb0E"
                                if name == k4n else
                                f"ILb{int(inst)}ELb{int(omm)}E")
             for name, lib in libs.items()}
    rec.update(ms=ms, plain_ms=plain_ms, bounds=bounds_ms, launch=launch,
               ptxas=ptxas, prepare_s=prep_s, card=smi)
    record[label] = rec
    for name in ms:
        terms = ", ".join(f"{k} {v:.4f}"
                          for k, v in bounds_ms[name][2].items())
        print(f"{label} {name}: kernel {ms[name]:.4f} ms at {g} groups, "
              f"plain {plain_ms[name]:.4f} ms at {cmp_groups} groups, bound "
              f"{bounds_ms[name][0]:.4f} ms ({bounds_ms[name][1]}; ms by "
              f"term: {terms}), {ptxas[name]['registers']} registers, "
              f"spills {ptxas[name]['spill_store_bytes']}/"
              f"{ptxas[name]['spill_load_bytes']} B ({smi})", flush=True)
    print(f"{label} launch: {json.dumps(launch)}", flush=True)
    print(f"{label} {k5n} screen pass share at that launch "
          f"{_share(k5_screen)} ({k5_screen['passed']} of "
          f"{k5_screen['pairs']} pairs, {k5_screen['overflowed']} lists "
          f"overflowed)", flush=True)
    dump()

    src_k3 = "rtxpt_tpu_torch/csrc/cluster_closest.cu"
    src_k5 = "rtxpt_tpu_torch/csrc/cluster_shadow.cu"
    meta = {k3n: (src_k3, "rtxpt_tpu/pt/bounce_clustered.py:224"),
            k4n: ("rtxpt_tpu_torch/csrc/cluster_shade.cu",
                  "rtxpt_tpu/pt/bounce_clustered.py:462"),
            k5n: (src_k5, "rtxpt_tpu/pt/bounce_clustered.py:405" if inst
                  else "rtxpt_tpu/pt/bounce_clustered.py:394")}
    entries = {name: dict(name=name, route="cuda", source=src_, replaces=rep,
                          max_abs_err=err[name], ms=ms[name],
                          plain_ms=plain_ms[name],
                          bound_ms=bounds_ms[name][0],
                          bound_by=bounds_ms[name][1], library_ms=None)
               for name, (src_, rep) in meta.items()}
    return dict(scene=(host, scene, prep_s), kernels=entries, shares=shares)


def _city_parity(record, dev, dump, with_env=False, label="city_parity"):
    """Phase 7 (and 12 with the sky): the small city through the kernels
    against the plain versions, both on the card."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt.integrator import render
    from rtxpt_tpu_torch.scene.procedural import city_scene, default_camera

    host = city_scene(tri_budget=4000, seed=1, blocks=2, with_env=with_env)
    scene = prepare(host, device=dev)
    cam = default_camera(host, 48, 32, device=dev)
    cfg = PathTracerConfig(max_bounces=3)
    kernels.launches.clear()
    img_k, _, rays_k = render(scene, cam, cfg, 48, 32, spp=2)
    used = dict(kernels.launches)
    swapped = (BC.closest_hit, BC.shade, BC.occlusion)
    BC.closest_hit, BC.shade, BC.occlusion = (
        BC.closest_hit_reference, BC.shade_reference, BC.occlusion_reference)
    try:
        img_p, _, rays_p = render(scene, cam, cfg, 48, 32, spp=2)
    finally:
        BC.closest_hit, BC.shade, BC.occlusion = swapped
    close = torch.isclose(img_k, img_p, rtol=TOL, atol=TOL).all(-1)
    share = float(close.float().mean())
    mean_k, mean_p = float(img_k.mean()), float(img_p.mean())
    rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-30)
    finite = bool(torch.isfinite(img_k).all())
    pages = SMALL_CITY_PAGES
    want = dict(cluster_closest=pages * 3 * 2, cluster_shade=3 * 2,
                cluster_shadow=pages * 3 * 2)
    if with_env:
        # the environment variant per bounce, and the final round's K3
        # pages and K4
        want = dict(cluster_closest=pages * (3 + 1) * 2,
                    cluster_shade_env=3 * 2, cluster_shade_final=2,
                    cluster_shadow=pages * 3 * 2)
    record[label] = dict(pixels_close=share, mean_kernel=mean_k,
                         mean_plain=mean_p, mean_rel=rel,
                         rays=(rays_k, rays_p), launches=used,
                         finite=finite)
    print(f"{label.replace('_', ' ')}: 48x32 2 spp 3 bounces, pixels within {TOL} "
          f"{share:.6f}, mean L {mean_k:.6f} vs {mean_p:.6f} (rel "
          f"{rel:.3g}), rays {rays_k} vs {rays_p}, launches {used}",
          flush=True)
    if share < 0.99 or rel > MEAN_RTOL or not finite or used != want:
        dump()
        _fail(f"{label}: the kernels' city image misses the plain "
              f"versions' or a kernel ran another number of times")


def _city_path(record, dev, smi, dump, prepared, label="city",
               pages=CITY_PAGES, stf=False):
    """Phase 8 (and 11, 12, 13): a clustered path at 1080p, then one
    profiled frame; `stf` turns stochastic texture filtering on (K4's
    texture variant on tables with textures). Returns the launch counts of
    the timed frames and their images by sample."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.pt.integrator import render_sample
    from rtxpt_tpu_torch.scene.procedural import default_camera

    from rtxpt_tpu_torch.pt import bounce_fused as bf

    host, scene, prep_s = prepared
    k3n, k5n = (("cluster_closest_inst", "cluster_shadow_inst")
                if scene.cluster_tables.instanced
                else ("cluster_closest", "cluster_shadow"))
    env = scene.cluster_tables.env is not None
    tex = stf and scene.cluster_tables.tex is not None
    (width, height), spp = CITY_FRAME, 2
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=1 << 30,
                           stochastic_texture_filtering=stf)
    cam = default_camera(host, width, height, device=dev)
    out = render_sample(scene, cam, cfg, width, height, 0)       # warm-up
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    acc, rays, overflow, images = None, 0, 0, {}
    for s in range(1, 1 + spp):
        out = render_sample(scene, cam, cfg, width, height, s)
        images[s] = out["L"]
        acc = out["L"] if acc is None else acc + out["L"]
        rays = rays + out["ray_count"]
        overflow = overflow + out["cull_overflow"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = dict(kernels.launches)
    rays, overflow = int(rays), int(overflow)
    hdr = acc / spp
    finite = bool(torch.isfinite(hdr).all())
    want = {k3n: pages * cfg.max_bounces * spp,
            bf.variant_name("cluster_shade", env, False, tex):
                cfg.max_bounces * spp,
            k5n: pages * cfg.max_bounces * spp}
    if env:
        # the final round: K3's pages and K4's final_env launch per sample
        want[k3n] += pages * spp
        want["cluster_shade_final"] = spp
    mrays = rays / dt / 1e6
    ms_frame = dt / spp * 1e3
    rec = dict(res=f"{width}x{height}", spp_timed=spp,
               bounces=cfg.max_bounces, launches=launched, expected=want,
               rays=rays, seconds=dt, mrays_per_s=mrays,
               ms_per_frame_1spp=ms_frame, cull_overflow=overflow,
               occupancy=out["occupancy"].tolist(), prepare_s=prep_s,
               L_mean=float(hdr.mean()), finite=finite,
               tier=out["kernel_tier"], card=smi)
    record[label] = rec
    print(f"{label}: {scene.cluster_tables.n_tris} triangles "
          f"{width}x{height} "
          f"{cfg.max_bounces} bounces, {spp} spp: {mrays:.3f} Mrays/s, "
          f"{ms_frame:.3f} ms per 1-spp frame, {rays} rays, cull_overflow "
          f"{overflow}, occupancy {rec['occupancy']}, prepare "
          f"{prep_s:.2f}s, launches {launched} of {want}, mean L "
          f"{rec['L_mean']:.5f} ({smi})", flush=True)
    if any(launched.get(k, 0) != v for k, v in want.items()) or not finite \
            or out["kernel_tier"] != "clustered" or set(launched) != set(want):
        dump()
        _fail(f"{label}: the path did not run every bounce through K3, "
              f"K4 and K5 or gave non-finite values")

    # one profiled frame: device time by part, and the idle share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_sample(scene, cam, cfg, width, height, spp + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rec["split"], rec["profile_table"] = _split(
        prof, wall, nested=("final",) if env else ())
    print(f"{label} split (one profiled frame, ms): "
          f"{json.dumps(rec['split'])} ({smi})", flush=True)
    dump()
    return launched, images


CITY_RANGES = ("sort", "cull", "post")
CITY_KERNELS = (("k3", "cluster_closest_kernel"),
                ("k4", "cluster_shade_kernel"),
                ("k5", "cluster_shadow_kernel"))


def _split(prof, wall_ms, ranges=CITY_RANGES, kernel_parts=CITY_KERNELS,
           nested=()):
    """Device time of one frame by part (ms): the named ranges
    ("rtxpt.<name>": the device time of the kernels they launched), the
    kernels, the rest, all kernels, and the idle share of the frame's
    wall time; plus the profiler's table. `nested` ranges launch kernels
    that the kernel parts count too (the final environment round's K3 and
    K4): they are reported and left out of the rest's subtraction."""
    from torch.autograd import DeviceType

    def total(evt, *names):
        for name in names:
            if hasattr(evt, name):
                return getattr(evt, name) / 1e3
        return 0.0

    ranges = tuple(ranges) + tuple(nested)
    parts = dict.fromkeys(list(ranges) + [p for p, _ in kernel_parts], 0.0)
    range_keys = tuple(f"rtxpt.{r}" for r in ranges)
    spans = {}
    busy = 0.0
    events = prof.key_averages()
    for evt in events:
        key = evt.key
        cuda = evt.device_type == DeviceType.CUDA
        if key in range_keys:
            spans[f"{key}:{'cuda' if cuda else 'cpu'}"] = total(
                evt, "device_time_total", "cuda_time_total")
            continue
        if not cuda:
            continue
        t = total(evt, "self_device_time_total", "self_cuda_time_total")
        busy += t
        for part, kernel in kernel_parts:
            if kernel in key:
                parts[part] += t
    for part in ranges:
        # the CPU range's device total counts its kernels; the profiler's
        # device-side annotation of the same name spans them, gaps included
        cpu = spans.get(f"rtxpt.{part}:cpu", 0.0)
        parts[part] = cpu if cpu > 0 else spans.get(f"rtxpt.{part}:cuda",
                                                    0.0)
    parts["other"] = busy - sum(v for k, v in parts.items()
                                if k not in nested)
    if "k5" in parts:
        parts["k5_share"] = parts["k5"] / busy if busy > 0 else None
    parts.update(device_busy=busy, wall=wall_ms,
                 idle_share=max(0.0, 1.0 - busy / wall_ms), spans=spans)
    try:
        table = events.table(sort_by="self_device_time_total", row_limit=30)
    except (AttributeError, KeyError, ValueError):
        table = events.table(sort_by="self_cuda_time_total", row_limit=30)
    return parts, table


def _external_nee(record, dev, smi, dump):
    """Phase 9: K1's external modes and K2 against their plain versions,
    their times, the three full-size external-NEE paths and one profiled
    NEE-AT frame. Returns dict(k1_err, k1_modes, k2 (partial kernel-line
    entry), launches {path: counts})."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.lighting import neeat as na
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render, render_adaptive, render_sample)
    from rtxpt_tpu_torch.pt.nee_external import external_nee
    from rtxpt_tpu_torch.scene.procedural import (
        cornell_box, default_camera, rooms_scene)

    rec = {}
    w, h = EXT_FRAME
    host = rooms_scene(ROOMS)
    scene = prepare(host, device=dev)
    tbl = scene.bounce_tables
    cam = default_camera(host, w, h, device=dev)
    cfgs = dict(
        slot3=PathTracerConfig(max_bounces=4, nee=NEEMode.NEEAT,
                               ray_chunk=EXT_CHUNK),
        slot5=PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                               nee_external=True, ray_chunk=EXT_CHUNK))
    state0 = na.init_state(w, h, scene.lights.count, device=dev)
    sample = 1
    print(f"external: rooms_scene({ROOMS}) {tbl.n_tris} triangles, "
          f"{tbl.n_lights} lights, {w}x{h}", flush=True)

    def camera_state(cols, rows, cfg):
        """Camera rays of a cols x rows grid of the frame's pixels."""
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        return bf.initial_state(o, d, spread, px, py)

    def requests(cfg, out, fs, is_, b):
        """K2's input: the shadow requests external_nee builds from K1's
        export `out` of the state (fs, is_) at bounce b."""
        res = external_nee(
            scene, cfg, state0 if cfg.nee == NEEMode.NEEAT else None,
            out[3], fs[bf.FS_D:bf.FS_D + 3], out[2][5] > 0.5,
            fs[bf.FS_PREVPDF], is_[bf.IS_PREVDELTA] > 0,
            out[1][bf.IS_PX], out[1][bf.IS_PY], sample, b)
        return bf.shadow_requests(res["shadow_o"], res["shadow_d"],
                                  res["sdist"], res["do_nee"])

    # K1 in slots 3 and 5 and K2 against their plain versions: 65,536
    # camera rays over the frame, bounces 0 and 2, the state carried by
    # the plain version
    k1_err = k2_err = 0.0
    cmp = {}
    for slot, cfg in cfgs.items():
        kcfg = bf.KernelConfig.from_cfg(cfg)
        fs, is_ = camera_state(CMP_SIDE, CMP_SIDE, cfg)
        for b in range(3):
            plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample)
            if b in (0, 2):
                kern = _k1_audited("external", lambda: bf.bounce(
                    fs, is_, tbl, kcfg, sample), plain)
                summary, err = _compare_state(kern[:3], plain[:3])
                int_eq = (kern[1] == plain[1]).all(0) \
                    & (kern[2][1] == plain[2][1])
                surf, serr = _compare(dict(surf=kern[3]),
                                      dict(surf=plain[3]), int_eq)
                summary.update(worst_surf_row=surf["worst_float_row"],
                               surf_rows=surf["float_rows"])
                k1_err = max(k1_err, err, serr)
                sh = requests(cfg, plain, fs, is_, b)
                occ_p, tst_p = bf.occlusion_reference(tbl, sh, stats=True)
                bf.occlusion_screen_stats(dev, True)
                occ_k, tst_k = bf.occlusion(tbl, sh, stats=True)
                screen = bf.occlusion_screen_stats(dev, False)
                # every lane: a lane without a request writes 1 and 0
                req = sh[bf.SR_DO] > 0.5
                k2s = dict(occ_lanes_equal=float(
                    (occ_k == occ_p).float().mean()),
                    occ_lanes_differ=int((occ_k != occ_p).sum()),
                    tests_equal=bool(torch.equal(tst_k, tst_p)),
                    requests=int(req.sum()),
                    occluded=int((req & (occ_p > 0.5)).sum()),
                    screen=screen)
                k2_err = max(k2_err, float((occ_k - occ_p).abs().max()))
                cmp[f"{slot}_bounce{b}"] = dict(k1=summary, k2=k2s)
                print(f"external {slot} bounce {b}: K1 int lanes equal "
                      f"{summary['int_lanes_equal']:.6f}, worst float row "
                      f"{summary['worst_float_row']:.6f}, worst SF row "
                      f"{surf['worst_float_row']:.6f}, L mean rel "
                      f"{summary['L_mean_rel']:.3g}, max abs err "
                      f"{max(err, serr):.3g}; K2 occlusion differs on "
                      f"{k2s['occ_lanes_differ']} lanes ({k2s['requests']} "
                      f"requests, {k2s['occluded']} occluded), tests "
                      f"equal {k2s['tests_equal']}, screen pass share "
                      f"{screen['shadow_share']}, missed {screen['missed']}",
                      flush=True)
                if not (_state_ok(summary)
                        and surf["worst_float_row"] >= LANE_FRACTION
                        and k2s["requests"] > 0
                        and k2s["occ_lanes_differ"] == 0
                        and k2s["tests_equal"]
                        and screen["missed"] == 0
                        and screen["shadow_pairs"] > 0):
                    rec["compare"] = cmp
                    record["external"] = rec
                    dump()
                    _fail(f"external: a kernel disagrees with its plain "
                          f"version in {slot} at bounce {b}")
            fs, is_ = plain[0], plain[1]
    rec["compare"] = cmp
    _k1_report(record, "external", dump)

    # K1 in slots 2, 3 and 5 and K2 timed at the path's launch width
    # (2^18 camera rays over the frame, bounce 0)
    fs_t, is_t = camera_state(512, 512, cfgs["slot3"])
    n = fs_t.shape[1]
    active = int((is_t[bf.IS_ACTIVE] > 0).sum())
    tables_bytes = 4 * sum(t.numel() for t in (
        tbl.tri_coef, tbl.attr_rows, tbl.mat_rows, tbl.light_rows))
    # bounds: every active lane against every triangle for its closest
    # hit, slot 2's in-kernel shadow rays up to their first occluder (as
    # in phase 3); the external slots' shadow rays are K2's
    modes = {}
    for slot, mode in (("slot2", 2), ("slot3", 3), ("slot5", 5)):
        kcfg = bf.KernelConfig(nee_mode=mode, maxb=4)
        ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample), 10)
        rows = 2 * (bf.NF + bf.NI) + bf.NH + (bf.SF_ROWS if mode > 2 else 0)
        pairs = active * tbl.n_tris + _k1_shadow_pairs(
            lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample))
        bound, by, _ = _bound(4 * n * rows + tables_bytes,
                              **_k1_ops(tbl.n_tris, pairs))
        modes[slot] = dict(ms=ms, bound_ms=bound, bound_by=by, rays=n)
    modes["slot3"]["plain_ms"] = _cuda_ms(lambda: bf.bounce_reference(
        fs_t, is_t, tbl, bf.KernelConfig(nee_mode=3, maxb=4), sample), 1)
    out3 = bf.bounce(fs_t, is_t, tbl, bf.KernelConfig(nee_mode=3, maxb=4),
                     sample)
    sh_t = requests(cfgs["slot3"], out3, fs_t, is_t, 0)
    k2_ms = _cuda_ms(lambda: bf.occlusion(tbl, sh_t), 20)
    k2_plain_ms = _cuda_ms(lambda: bf.occlusion_reference(tbl, sh_t), 1)
    _, tests = bf.occlusion(tbl, sh_t, stats=True)
    pairs = int(tests.sum())
    # the pairs up to each request's first occluder, on the tensor cores
    # and the screen (K1's count) above EXACT_TRIS triangles
    k2_bound, k2_by, k2_terms = _bound(
        n * SR_BYTES + 4 * tbl.tri_coef.numel(), **_k1_ops(tbl.n_tris, pairs))
    launch = dict(rays=n, requests=int((sh_t[bf.SR_DO] > 0.5).sum()),
                  pairs=pairs)
    rec.update(k1_modes=modes, k2=dict(ms=k2_ms, plain_ms=k2_plain_ms,
                                       bound_ms=k2_bound, bound_by=k2_by,
                                       terms=k2_terms, launch=launch),
               card=smi)
    for slot, m in modes.items():
        print(f"external K1 {slot}: {m['ms']:.4f} ms per {n}-ray launch, "
              f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})"
              + (f", plain {m['plain_ms']:.2f} ms" if "plain_ms" in m
                 else "") + f" ({smi})", flush=True)
    print(f"external K2: {k2_ms:.4f} ms per {n}-ray launch "
          f"({launch['requests']} requests, {pairs} pairs tested), plain "
          f"{k2_plain_ms:.2f} ms, bound {k2_bound:.4f} ms ({k2_by}) (before "
          f"its redesign: {K2_BEFORE['rooms']}) ({smi})", flush=True)
    dump()

    # the three full-size paths, each through the entry point a user
    # calls: render_adaptive for NEE-AT (every call starts from a uniform
    # tile state and updates it after each sample), render for the others
    def run_path(label, scene_, host_, cfg, spp, adaptive):
        cam_ = default_camera(host_, w, h, device=dev)
        entry = render_adaptive if adaptive else render
        entry(scene_, cam_, cfg, w, h, 1)                      # warm-up
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        hdr, state, rays = entry(scene_, cam_, cfg, w, h, spp, first_sample=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = dict(kernels.launches)
        state = state if adaptive else None
        tier = dispatch.resolve(scene_, cfg, dev, state).kernel_tier
        chunks = -(-(w * h) // cfg.ray_chunk)
        want = chunks * cfg.max_bounces * spp
        finite = bool(torch.isfinite(hdr).all())
        p = dict(res=f"{w}x{h}", spp_timed=spp, bounces=cfg.max_bounces,
                 chunks=chunks, launches=launched, expected=want, rays=rays,
                 seconds=dt, mrays_per_s=rays / dt / 1e6,
                 ms_per_frame_1spp=dt / spp * 1e3,
                 L_mean=float(hdr.mean()), finite=finite,
                 tier=tier, card=smi)
        print(f"external path {label}: {p['mrays_per_s']:.3f} Mrays/s, "
              f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, {rays} "
              f"rays, launches {launched} (want {want} each), mean L "
              f"{p['L_mean']:.5f} ({smi})", flush=True)
        if launched != dict(bounce_fused=want, shadow_occlusion=want) \
                or not finite or tier != "fused":
            rec[label] = p
            record["external"] = rec
            dump()
            _fail(f"external: the {label} path did not run every bounce "
                  f"through K1 and K2 or gave non-finite values")
        return p, state, cam_

    paths = {}
    paths["neeat"], state, cam_at = run_path(
        "neeat", scene, host, cfgs["slot3"], 4, True)
    lit = state.conf > 0
    moved = (state.tile_pdf - 1.0 / state.n_lights).abs().amax(1) > 1e-3
    learned = dict(lit_tiles=int(lit.sum()), tiles=int(lit.numel()),
                   lit_not_uniform=float(moved[lit].float().mean()),
                   lit_max_pdf_mean=float(state.tile_pdf[lit].amax(1)
                                          .mean()))
    paths["neeat"]["learned"] = learned
    print(f"external NEE-AT state: {learned['lit_tiles']} of "
          f"{learned['tiles']} tiles lit, {learned['lit_not_uniform']:.4f} "
          f"of them off the uniform pmf, mean largest light pmf "
          f"{learned['lit_max_pdf_mean']:.4f} (uniform "
          f"{1.0 / state.n_lights:.4f})", flush=True)
    if learned["lit_tiles"] == 0 or learned["lit_not_uniform"] < 0.9:
        rec["paths"] = paths
        record["external"] = rec
        dump()
        _fail("external: the NEE-AT state learned nothing")
    many_host = rooms_scene(*MANY_LIGHTS)
    many = prepare(many_host, device=dev)
    if many.lights.count <= bf.MAX_LIGHTS:
        _fail("external: the many-light scene has too few lights")
    paths["many_lights"], _, _ = run_path(
        "many_lights", many, many_host, PathTracerConfig(
            max_bounces=4, nee=NEEMode.POWER, ray_chunk=EXT_CHUNK), 2, False)
    cornell = cornell_box()
    paths["wrs"], _, _ = run_path(
        "wrs", prepare(cornell, device=dev), cornell, PathTracerConfig(
            max_bounces=4, nee=NEEMode.POWER, nee_candidates=4,
            ray_chunk=EXT_CHUNK), 2, False)
    rec["paths"] = paths

    # one profiled NEE-AT frame: device time by part, and the idle share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = render_sample(scene, cam_at, cfgs["slot3"], w, h, 6,
                            neeat_state=state)
        na.update(state, out["neeat_hist"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rec["split"], rec["profile_table"] = _split(
        prof, wall, ("camera", "nee", "feedback"),
        (("k1", "bounce_fused_kernel"), ("k2", "shadow_occlusion_kernel")))
    rec["k1_frame"] = k1_frame = _k1_frame(prof)
    print(f"external NEE-AT split (one profiled frame, ms): "
          f"{json.dumps(rec['split'])} ({smi})", flush=True)
    print(f"external NEE-AT: K1 {k1_frame['ms']:.3f} ms of device time per "
          f"profiled 1-spp frame over {k1_frame['launches']} launches "
          f"(before its redesign: {K1_BEFORE['rooms']}) ({smi})", flush=True)
    rec["k2_frame"] = k2_frame = _kernel_frame(prof, r"shadow_occlusion_kernel")
    print(f"external NEE-AT: K2 {k2_frame['ms']:.3f} ms of device time per "
          f"profiled 1-spp frame over {k2_frame['launches']} launches "
          f"(before its redesign: {K2_BEFORE['rooms']}) ({smi})", flush=True)
    record["external"] = rec
    dump()
    k2 = dict(name="shadow_occlusion", route="cuda",
              source="rtxpt_tpu_torch/csrc/shadow_occlusion.cu",
              replaces="rtxpt_tpu/pt/bounce_pallas.py:1573",
              max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
              bound_ms=k2_bound, bound_by=k2_by, library_ms=None)
    return dict(k1_err=k1_err, k1_modes=modes, k2=k2,
                launches={k: v["launches"] for k, v in paths.items()})


class _PlainQueries:
    """Stand-ins for the general wavefront's scene queries
    (integrator.scene_closest / scene_any): each query runs the plain
    version (K8's, or K9's `_traverse_wide`), which carries the path; at
    the (kind, index) calls in `compare` the kernel runs too on the same
    inputs and the pair is summarized; the inputs of the calls in `keep`
    are kept."""

    def __init__(self, compare=(), keep=()):
        self.compare, self.keep = set(compare), set(keep)
        self.calls = dict(closest=0, any=0)
        self.summaries, self.inputs, self.err = {}, {}, 0.0

    def closest(self, scene, o, d, tmin, tmax):
        return self._query("closest", scene, o, d, tmin, tmax)

    def any(self, scene, o, d, tmin, tmax):
        return self._query("any", scene, o, d, tmin, tmax)

    def _query(self, kind, scene, o, d, tmin, tmax):
        import torch

        from rtxpt_tpu_torch.accel import brute, traverse

        key = (kind, self.calls[kind])
        self.calls[kind] += 1
        if key in self.keep:
            self.inputs[key] = (o, d, tmin, tmax)
        bvh = scene.bvh
        if bvh.brute is not None:
            plain = brute._closest_plain(bvh.brute, o, d, tmin, tmax)
            if key in self.compare:
                kern = brute.closest(bvh.brute, o, d, tmin, tmax)
                self._summarize(key, kern, plain, kind)
            prim = plain["prim"]
        else:
            any_hit = kind == "any"
            plain = traverse._traverse_wide(bvh, o, d, tmin, tmax, any_hit,
                                            stats=True)
            if key in self.compare:
                kern = traverse.walk(bvh, o, d, tmin, tmax, any_hit=any_hit,
                                     stats=True)
                self._summarize(key, kern, plain, kind)
            prim = torch.where(plain["prim"] >= 0, bvh.prim_tri[
                plain["prim"].clamp(min=0).long()], -1)
        if kind == "any":
            return prim >= 0
        return traverse.Hit(t=plain["t"], prim=prim, bary=plain["uv"],
                            front=plain["front"])

    def _summarize(self, key, kern, plain, kind):
        """Agreement of one query: prim ids and front (closest) or
        occlusion (any-hit) equal, t, u, v within TOL on the lanes whose
        prims agree, and the walk's visit and test counts. K9 against
        `_traverse_wide`: its lanes bit-equal (prim, front, t, u, v) on
        >= LANE_FRACTION of the closest hits, occlusion and the counts
        equal on every lane. K8 against `_closest_plain`: t, prim, uv and
        front bit-equal on every lane."""
        import torch
        torch.cuda.synchronize()
        if kind == "any":
            occ_k, occ_p = kern["prim"] >= 0, plain["prim"] >= 0
            out = dict(occ_lanes_equal=float((occ_k == occ_p).float().mean()),
                       occluded=int(occ_p.sum()), rays=int(occ_p.numel()))
            ok = out["occ_lanes_equal"] >= LANE_FRACTION
        else:
            same = kern["prim"] == plain["prim"]
            out, err = _compare(dict(t=kern["t"][None], uv=kern["uv"].T),
                                dict(t=plain["t"][None], uv=plain["uv"].T),
                                same)
            out.pop("float_rows")
            out.update(front_equal=float(
                (kern["front"] == plain["front"]).float().mean()),
                hits=int((plain["prim"] >= 0).sum()),
                rays=int(plain["prim"].numel()))
            self.err = max(self.err, err)
            ok = (out["int_lanes_equal"] >= LANE_FRACTION
                  and out["front_equal"] >= LANE_FRACTION
                  and out["worst_float_row"] >= LANE_FRACTION)
            if "visits" not in plain:
                # K8: bit-equal to its plain version on every lane
                out["lanes_differ"] = _k8_lanes_differ(kern, plain)
                ok = ok and out["lanes_differ"] == 0
        if "visits" in plain:
            agree = _walk_agreement(kern, plain, kind == "any")
            ok = ok and agree.pop("ok")
            out.update(agree, visits=int(plain["visits"].sum()),
                       tests=int(plain["tests"].sum()))
        out["ok"] = ok
        self.summaries[f"{kind}{key[1]}"] = out


def _walk_agreement(kern, plain, any_hit):
    """K9's outputs against its plain version `_traverse_wide`'s (both
    with stats): the lanes whose prim, front, t, u or v differ bit-wise,
    those whose occlusion differs, whether the visit and test counts are
    equal on every lane, and `ok`: counts equal, any-hit occlusion equal
    on every lane, closest hits bit-equal on >= LANE_FRACTION of lanes."""
    import torch
    rows = ("t", "uv", "prim", "front")
    n = int(kern["prim"].numel())
    out = dict(lanes_differ=_lanes_differ(
        [kern[k].reshape(n, -1).T for k in rows],
        [plain[k].reshape(n, -1).T for k in rows]),
        occ_lanes_differ=int(((kern["prim"] >= 0)
                              != (plain["prim"] >= 0)).sum()),
        counts_equal=bool(torch.equal(kern["visits"], plain["visits"])
                          and torch.equal(kern["tests"], plain["tests"])))
    out["ok"] = out["counts_equal"] and (
        out["occ_lanes_differ"] == 0 if any_hit
        else out["lanes_differ"] <= (1 - LANE_FRACTION) * n)
    return out


def _k9_audit(label, run, keep=2):
    """Call `run()` with K9's wrapper (traverse.walk) recording its first
    `keep` launches, then hold K9 to its plain version `_traverse_wide` on
    each launch's rays (every k-th, at most 65,536): closest hits bit-equal
    (prim, front, t, u, v) on >= LANE_FRACTION of the lanes, any-hit
    occlusion and the visit and test counts equal on every lane. Returns
    (run's result, the summaries, whether all agree)."""
    import torch

    from rtxpt_tpu_torch.accel import traverse
    calls = []
    real = traverse.walk

    def recorder(bvh, o, d, tmin, tmax, any_hit=False, stats=False):
        if len(calls) < keep:
            calls.append((bvh, o, d, tmin, tmax, any_hit))
        return real(bvh, o, d, tmin, tmax, any_hit, stats)
    traverse.walk = recorder
    try:
        out = run()
    finally:
        traverse.walk = real
    summaries, ok = [], bool(calls)
    for bvh, o, d, tmin, tmax, any_hit in calls:
        step = max(1, o.shape[0] // 65536)
        sub = [x[::step].contiguous() for x in (o, d, tmin, tmax)]
        kern = real(bvh, *sub, any_hit, True)
        plain = traverse._traverse_wide(bvh, *sub, any_hit, True)
        torch.cuda.synchronize()
        s = dict(any_hit=any_hit, rays=int(sub[0].shape[0]),
                 omm=bvh.tri_micro is not None,
                 visits_per_ray=float(plain["visits"].double().mean()),
                 tests_per_ray=float(plain["tests"].double().mean()),
                 **_walk_agreement(kern, plain, any_hit))
        ok = ok and s["ok"]
        summaries.append(s)
        print(f"{label} K9 audit: {json.dumps(s)}", flush=True)
    return out, summaries, ok


def _k8_lanes_differ(kern, plain):
    """The lanes where K8's t, prim, uv or front differ bit-wise from its
    plain version's."""
    n = int(plain["prim"].numel())
    rows = ("t", "uv", "prim", "front")
    return _lanes_differ([kern[k].reshape(n, -1).T for k in rows],
                         [plain[k].reshape(n, -1).T for k in rows])


def _k8_bound(tris, n, plain_count=False):
    """_bound of K8 over n rays: each ray read and its hit written once,
    the table (and the tensor-core route's tile) read once; on the CUDA
    cores the plain test's 48 f32 a pair (K8_PAIR_F32), on the tensor-core
    route K1's count of its screen over the tile's pairs (_k1_ops: the
    products and 13 f32 a pair), or with `plain_count` the plain test's
    there too."""
    from rtxpt_tpu_torch.accel import brute
    nt = tris.num_triangles
    mma = brute.route(tris) == "mma"
    tile = tris.tile.numel() * 2 + tris.scale.numel() * 4 if mma else 0
    nbytes = n * RAY_BYTES + 64 * nt + tile
    if mma and not plain_count:
        return _bound(nbytes, **_k1_ops(nt, n * tris.tile.shape[1]))
    return _bound(nbytes, f32=n * nt * K8_PAIR_F32)


def _k8_audit(label, run, keep=(0,)):
    """Call `run()` with K8's wrapper (brute.closest) recording its
    launches whose index is in `keep`, then hold K8 to its plain version
    `_closest_plain` on every lane of each (t, prim, uv and front bit-equal,
    no accepted pair missed by the screen) and time it there beside its
    bound. Returns (run's result, the summaries, whether all agree)."""
    import torch

    from rtxpt_tpu_torch.accel import brute
    calls, real, count = [], brute.closest, [0]

    def recorder(tris, o, d, tmin, tmax):
        if count[0] in keep:
            calls.append((count[0], tris, tuple(x.contiguous() for x in
                                                (o, d, tmin, tmax))))
        count[0] += 1
        return real(tris, o, d, tmin, tmax)
    brute.closest = recorder
    try:
        out = run()
    finally:
        brute.closest = real
    summaries, ok = [], len(calls) == len(keep)
    for idx, tris, args in calls:
        dev = tris.table.device
        brute.screen_stats(dev, True)
        kern = real(tris, *args)
        screen = brute.screen_stats(dev, False)
        plain = brute._closest_plain(tris, *args)
        torch.cuda.synchronize()
        n = int(args[0].shape[0])
        ms = _cuda_ms(lambda: real(tris, *args), 10)
        bound, by, _ = _k8_bound(tris, n)
        s = dict(launch=idx, rays=n, triangles=tris.num_triangles,
                 route=brute.route(tris),
                 lanes_differ=_k8_lanes_differ(kern, plain),
                 hits=int((plain["prim"] >= 0).sum()), screen=screen, ms=ms,
                 bound_ms=bound, bound_by=by)
        if s["route"] == "mma":
            s["plain_count_bound_ms"] = _k8_bound(tris, n, True)[0]
        ok = ok and s["lanes_differ"] == 0 and screen["missed"] == 0
        summaries.append(s)
        print(f"{label} K8 audit: {json.dumps(s)}", flush=True)
    return out, summaries, ok


def _general_tier(record, dev, smi, dump, city, city_images):
    """Phase 10: K8 and K9 against their plain versions and their times,
    the golden and the small-city cross-tier check through the general
    tier, the 1080p Cornell and city paths and one profiled frame of
    each. Returns the kernel-line entries of K8 and K9."""
    import numpy as np
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.accel import brute, traverse
    from rtxpt_tpu_torch.accel.cluster import morton_permutation
    from rtxpt_tpu_torch.accel.lbvh import build_bvh
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import integrator as I
    from rtxpt_tpu_torch.scene.procedural import (
        city_scene, cornell_box, default_camera, rooms_scene)
    from rtxpt_tpu_torch.utils.image import psnr, rmse

    rec = {}
    sample = 1

    def plain_run(scene, host, cfg, cols, rows, frame, queries):
        """The general wavefront once, over a cols x rows grid of the
        frame's pixels, through the plain queries `queries`."""
        w, h = frame
        cam = default_camera(host, w, h, device=dev)
        px, py = I._pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = I.camera_rays(cam, cfg, px, py, sample)
        saved = I.scene_closest, I.scene_any
        I.scene_closest, I.scene_any = queries.closest, queries.any
        try:
            out = I.trace_paths(scene, cfg, o, d, spread, px, py, sample)
        finally:
            I.scene_closest, I.scene_any = saved
        torch.cuda.synchronize()
        return out

    def failed(msg):
        record["general"] = rec
        dump()
        _fail(msg)

    def check(label, queries):
        rec[label] = queries.summaries
        for key, summary in queries.summaries.items():
            print(f"general {label} {key}: {json.dumps(summary)}",
                  flush=True)
            if not summary["ok"]:
                failed(f"general: the kernel disagrees with its plain "
                       f"version ({label}, {key})")

    # K8 against its plain version: 65,536 camera rays over a 1080p frame,
    # bounces 0 and 2 (closest-hit calls 0 and 2; call 2 is 2N wide)
    cfg4 = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            kernel_tier="xla", ray_chunk=1 << 30)
    scenes = {}
    k8_err = 0.0
    for label, host in (("cornell", cornell_box()),
                        ("rooms", rooms_scene(ROOMS))):
        scene = prepare(host, device=dev)
        scenes[label] = (host, scene)
        q = _PlainQueries(compare=[("closest", 0), ("closest", 2)])
        plain_run(scene, host, cfg4, GEN_CMP_SIDE, GEN_CMP_SIDE, EXT_FRAME, q)
        check(f"k8_{label}", q)
        k8_err = max(k8_err, q.err)

    # K8 timed at the Cornell path's launch widths: 2^18 camera rays
    # (bounce 0) and the 2^19-ray fused query of bounce 1
    host_c, scene_c = scenes["cornell"]
    q = _PlainQueries(keep=[("closest", 0), ("closest", 1)])
    plain_run(scene_c, host_c, dataclasses.replace(cfg4, max_bounces=1),
              512, 512, EXT_FRAME, q)
    tris = scene_c.bvh.brute
    k8 = {}
    for key in (("closest", 0), ("closest", 1)):
        args = q.inputs[key]
        n = args[0].shape[0]
        ms = _cuda_ms(lambda: brute.closest(tris, *args), 20)
        bound, by, terms = _k8_bound(tris, n)
        k8[n] = dict(ms=ms, bound_ms=bound, bound_by=by, terms=terms)
    n18 = q.inputs[("closest", 0)][0].shape[0]
    k8[n18]["plain_ms"] = _cuda_ms(
        lambda: brute._closest_plain(tris, *q.inputs[("closest", 0)]), 3)
    rec["k8_times"] = k8
    for n, m in k8.items():
        print(f"general K8: {m['ms']:.4f} ms per {n}-ray launch x "
              f"{tris.num_triangles} triangles, bound {m['bound_ms']:.4f} "
              f"ms ({m['bound_by']})" + (f", plain {m['plain_ms']:.3f} ms"
                                         if "plain_ms" in m else "")
              + f" ({smi})", flush=True)

    # K9 against its plain version on the city (no brute tables): 65,536
    # rays of the 1080p frame, closest and any-hit at bounces 0 and 2
    host_city, scene_city, _ = city
    if scene_city.bvh.brute is not None:
        failed("general: the city has brute tables")
    q = _PlainQueries(compare=[("closest", 0), ("closest", 2), ("any", 0),
                               ("any", 2)], keep=[("closest", 0)])
    plain_run(scene_city, host_city,
              dataclasses.replace(cfg4, max_bounces=3), GEN_CMP_SIDE,
              GEN_CMP_SIDE, CITY_FRAME, q)
    check("k9_city", q)
    k9_err = q.err
    bvh = scene_city.bvh
    k9_plain_ms = _cuda_ms(lambda: traverse._traverse_wide(
        bvh, *q.inputs[("closest", 0)], False), 1)

    # K9 timed at the city path's 1080p bounce-0 launch
    w, h = CITY_FRAME
    cam = default_camera(host_city, w, h, device=dev)
    px, py = I._pixel_grid(w, h, dev)
    o, d, _ = I.camera_rays(cam, cfg4, px, py, sample)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    tmin = torch.zeros((n,), device=dev)
    tmax = torch.full((n,), float(cfg4.max_ray_travel), device=dev)
    k9_ms = _cuda_ms(lambda: traverse.walk(bvh, o, d, tmin, tmax), 3)
    st = traverse.walk(bvh, o, d, tmin, tmax, stats=True)
    visits, tests = int(st["visits"].sum()), int(st["tests"].sum())
    k9_bound, k9_by, k9_terms = _bound(
        n * RAY_BYTES + 4 * (bvh.wide.numel() + bvh.wide_tris.numel()),
        f32=visits * K9_NODE_F32 + tests * K9_TEST_F32)
    rec["k9_time"] = dict(ms=k9_ms, plain_ms=k9_plain_ms,
                          plain_rays=GEN_CMP_SIDE ** 2, rays=n,
                          nodes=bvh.num_nodes, wide_nodes=bvh.num_wide,
                          wide_depth=bvh.wide_depth,
                          wide_stack=bvh.wide_stack, visits=visits,
                          tests=tests, hits=int((st["prim"] >= 0).sum()),
                          bound_ms=k9_bound, bound_by=k9_by, terms=k9_terms)
    print(f"general K9: {k9_ms:.4f} ms per {n}-ray launch over "
          f"{bvh.num_wide} wide nodes of {bvh.num_nodes} binary ones, "
          f"{bvh.wide_depth} levels ({visits / n:.2f} wide visits, "
          f"{tests / n:.3f} tests per ray), plain {k9_plain_ms:.2f} ms at "
          f"{GEN_CMP_SIDE ** 2} rays, bound {k9_bound:.4f} ms ({k9_by}) "
          f"(before its redesign: {K9_BEFORE['city']}) ({smi})", flush=True)
    dump()

    # the golden through the general tier
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "goldens", "cornell_32_8spp.npy"))
    kernels.launches.clear()
    hdr, _, _ = I.render(scene_c, default_camera(host_c, 32, 32, device=dev),
                         PathTracerConfig(max_bounces=3, kernel_tier="xla"),
                         32, 32, spp=8)
    img = hdr.cpu().numpy()
    e, p = rmse(img, golden), psnr(img, golden)
    used = dict(kernels.launches)
    rec["golden"] = dict(rmse=e, psnr=p, launches=used)
    print(f"general golden: RMSE {e:.6f} PSNR {p:.2f} dB, launches {used}",
          flush=True)
    if not (e < 5e-3 and p > 40 and used == dict(brute_closest=8 * 4)):
        failed("general: the general tier misses the Cornell golden")

    # the small city through the general tier against the clustered tier
    host_s = city_scene(tri_budget=4000, seed=1, blocks=2)
    scene_s = prepare(host_s, device=dev)
    cam_s = default_camera(host_s, 48, 32, device=dev)
    img_c, _, _ = I.render(scene_s, cam_s, PathTracerConfig(max_bounces=3),
                           48, 32, spp=2)
    img_x, _, _ = I.render(scene_s, cam_s, PathTracerConfig(
        max_bounces=3, kernel_tier="xla"), 48, 32, spp=2)
    e = rmse(img_x.cpu().numpy(), img_c.cpu().numpy())
    dm = abs(float(img_x.mean()) - float(img_c.mean()))
    rec["cross_tier"] = dict(rmse=e, mean_xla=float(img_x.mean()),
                             mean_clustered=float(img_c.mean()))
    print(f"general cross-tier: small city 48x32 2 spp, xla vs clustered "
          f"RMSE {e:.6f}, means {float(img_x.mean()):.6f} vs "
          f"{float(img_c.mean()):.6f}", flush=True)
    if not (e < 2e-2 and dm < 5e-3 and bool(torch.isfinite(img_x).all())):
        failed("general: the general tier disagrees with the clustered "
               "tier on the small city")
    dump()

    # LBVH build seconds of the two full-size scenes (as prepare builds them)
    def lbvh_seconds(host, ordered):
        g = host.flatten().geometry
        pos, idx = g.positions.numpy(), g.indices.numpy()
        if ordered:
            idx = idx[morton_permutation(pos, idx)]
        t0 = time.perf_counter()
        build_bvh(pos, idx, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the two full-size paths, each through render after a warm-up
    from torch.profiler import ProfilerActivity, profile

    def run_path(label, scene, host, cfg, spp, kernel, want, ordered):
        cam_p = default_camera(host, w, h, device=dev)
        I.render(scene, cam_p, cfg, w, h, 1)                    # warm-up
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        hdr, _, rays = I.render(scene, cam_p, cfg, w, h, spp,
                                first_sample=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = dict(kernels.launches)
        finite = bool(torch.isfinite(hdr).all())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            I.render_sample(scene, cam_p, cfg, w, h, spp + 1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        split, table = _split(prof, wall, ("camera",),
                              ((label, f"{kernel}_kernel"),))
        chunks = -(-(w * h) // cfg.ray_chunk)
        p = dict(res=f"{w}x{h}", spp_timed=spp, bounces=cfg.max_bounces,
                 chunks=chunks, launches=launched, expected={kernel: want},
                 rays=rays, seconds=dt, mrays_per_s=rays / dt / 1e6,
                 ms_per_frame_1spp=dt / spp * 1e3,
                 kernel_share=split[label] / max(split["device_busy"], 1e-9),
                 lbvh_seconds=lbvh_seconds(host, ordered),
                 L_mean=float(hdr.mean()), finite=finite, split=split,
                 profile_table=table, card=smi)
        if kernel == "bvh_traverse":
            p["k9_frame"] = _kernel_frame(prof, r"bvh_traverse_kernel")
        print(f"general path {label}: {p['mrays_per_s']:.3f} Mrays/s, "
              f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, {rays} "
              f"rays, launches {launched} (want {want}), {kernel} "
              f"{100 * p['kernel_share']:.1f}% of the device time, device "
              f"idle {100 * split['idle_share']:.1f}%, LBVH build "
              f"{p['lbvh_seconds']:.3f} s, mean L {p['L_mean']:.5f} ({smi})",
              flush=True)
        rec[label] = p
        if launched != {kernel: want} or not finite:
            failed(f"general: the {label} path did not run every query "
                   f"through {kernel} or gave non-finite values")
        return p, hdr

    cfg_c = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                             ray_chunk=GEN_CHUNK, kernel_tier="xla")
    chunks = -(-(w * h) // GEN_CHUNK)
    cornell_path, _ = run_path(
        "cornell", scene_c, host_c, cfg_c, 2, "brute_closest",
        chunks * (cfg_c.max_bounces + 1) * 2, False)
    b = cfg4.max_bounces
    city_path, hdr = run_path(
        "city", scene_city, host_city, cfg4, 1, "bvh_traverse",
        (b + 1) + b, True)
    k9f = city_path["k9_frame"]
    print(f"general city: K9 {k9f['ms']:.3f} ms of device time per profiled "
          f"1-spp frame over {k9f['launches']} launches (before its "
          f"redesign: {K9_BEFORE['city']}) ({smi})", flush=True)
    ref = city_images[1]
    city_path.update(rmse_vs_clustered=rmse(hdr.cpu().numpy(),
                                            ref.cpu().numpy()),
                     mean_clustered=float(ref.mean()))
    print(f"general city vs phase 8's clustered image of sample 1: RMSE "
          f"{city_path['rmse_vs_clustered']:.6f}, means "
          f"{city_path['L_mean']:.6f} vs {city_path['mean_clustered']:.6f}",
          flush=True)
    record["general"] = rec
    dump()
    n19 = max(k8)
    return [
        dict(name="brute_closest", route="cuda",
             source="rtxpt_tpu_torch/csrc/brute_closest.cu",
             replaces="rtxpt_tpu/accel/brute_pallas.py:34",
             launches=cornell_path["launches"].get("brute_closest", 0),
             max_abs_err=k8_err, ms=k8[n18]["ms"],
             plain_ms=k8[n18]["plain_ms"], bound_ms=k8[n18]["bound_ms"],
             bound_by=k8[n18]["bound_by"], library_ms=None,
             rays=n18, ms_2n=k8[n19]["ms"], rays_2n=n19),
        dict(name="bvh_traverse", route="cuda",
             source="rtxpt_tpu_torch/csrc/bvh_traverse.cu",
             replaces="rtxpt_tpu/accel/traverse_pallas.py:54",
             launches=city_path["launches"].get("bvh_traverse", 0),
             max_abs_err=k9_err, ms=k9_ms, plain_ms=k9_plain_ms,
             bound_ms=k9_bound, bound_by=k9_by, library_ms=None, rays=n)]


INST_GRID, INST_SUBDIV = 8, 21   # 64 towers x 5,292 triangles
INST_PAGES = 2                   # 4,112 world candidates, kslots 64
TLAS_GRID = 3                    # the boxes of tests/test_tlas.py
TLAS_SIDE, TLAS_SPP = 96, 4


def _instanced_city_host():
    """The instanced city at the flat city's scale, seen from a corner
    above the grid (procedural.instanced_city gives no camera)."""
    from rtxpt_tpu_torch.scene.procedural import instanced_city
    host = instanced_city(INST_GRID, INST_SUBDIV)
    host.camera = dict(position=[4.0, 4.0, 5.0], target=[-0.8, 0.5, -0.8],
                       up=[0.0, 1.0, 0.0], fov_y_deg=60.0)
    return host


def _instancing(record, dev, smi, dump, flat_city):
    """Phase 11: K3's and K5's instanced variants against their plain
    versions on the instanced city and their times; the 1080p instanced
    path and one profiled frame; the same host flattened (bounce-0 t and
    the 1-spp images); the TLAS route on the boxes against their flattened
    scene, and one timed and one profiled 1080p frame of it. Returns the
    kernel-line entries of the instanced variants."""
    import numpy as np
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt import integrator as I
    from rtxpt_tpu_torch.scene.camera import look_at
    from rtxpt_tpu_torch.scene.procedural import (
        default_camera, instanced_boxes)
    from rtxpt_tpu_torch.utils.image import rmse

    rec = {}

    def failed(msg):
        record["instancing"] = rec
        dump()
        _fail(msg)

    # the scene, and what instancing saves
    t0 = time.perf_counter()
    host = _instanced_city_host()
    scene = prepare(host, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    tbl = scene.cluster_tables
    if scene.tlas is None or tbl is None or not tbl.instanced:
        failed("instancing: the instanced city did not get instanced "
               "cluster tables")
    t0 = time.perf_counter()
    flat = prepare(host, device=dev, instancing="off")
    torch.cuda.synchronize()
    flat_prep_s = time.perf_counter() - t0
    mib = 1.0 / (1 << 20)
    world_tris = sum(len(i.indices) for i in host.instances)
    city_blocks = flat_city[1].cluster_tables.blocks
    mem = dict(instances=scene.tlas.n_instances,
               prototypes=scene.tlas.n_meshes, world_triangles=world_tris,
               pool_triangles=tbl.n_tris, pool_blocks=tbl.blocks.shape[0],
               pool_block_mib=tbl.blocks.numel() * 4 * mib,
               world_candidates=tbl.n_clusters,
               candidate_table_mib=(tbl.aabb_lo.numel() * 2 * 4
                                    + tbl.wc_block.numel() * 8) * mib,
               flattened_blocks=flat.cluster_tables.blocks.shape[0],
               flattened_block_mib=flat.cluster_tables.blocks.numel() * 4
               * mib, city_blocks=city_blocks.shape[0],
               city_block_mib=city_blocks.numel() * 4 * mib,
               prepare_s=prep_s, flattened_prepare_s=flat_prep_s)
    rec["memory"] = mem
    print(f"instancing: {mem['instances']} instances of {mem['prototypes']} "
          f"prototypes, {world_tris} world triangles in {tbl.n_tris} pool "
          f"triangles: {mem['pool_blocks']} blocks, "
          f"{mem['pool_block_mib']:.2f} MiB, {tbl.n_clusters} world "
          f"candidates ({mem['candidate_table_mib']:.3f} MiB); flattened "
          f"{mem['flattened_blocks']} blocks, "
          f"{mem['flattened_block_mib']:.2f} MiB (the flat city "
          f"{mem['city_blocks']} blocks, {mem['city_block_mib']:.2f} MiB); "
          f"prepare {prep_s:.2f}s, flattened {flat_prep_s:.2f}s", flush=True)

    # 1. K3 and K5 instanced against their plain versions at bounces 0, 1
    # and 2, and their times
    checked = _cluster_kernel_checks(record, dev, smi, dump, "instanced",
                                     host, scene, prep_s, INST_PAGES,
                                     deep_bounces=(1, 2))
    # 2. the instanced path at 1080p and one profiled frame
    launched, images = _city_path(record, dev, smi, dump,
                                  (host, scene, prep_s), label="instanced "
                                  "path", pages=INST_PAGES)
    lit = float(images[1].mean())
    if not lit > 1e-3:
        failed(f"instancing: the instanced city is dark (mean {lit})")

    # 3. against the flattened scene: bounce-0 t of the 1080p camera rays,
    # the two 1-spp images of sample 1 and the flattened frame's time; and
    # the bounce-0 hit share of the exact TLAS walk, which no cull list
    # limits
    w, h = CITY_FRAME
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=1 << 30)
    cam = default_camera(host, w, h, device=dev)
    px, py = I._pixel_grid(w, h, dev)
    o, d, spread = I.camera_rays(cam, cfg, px, py, 1)
    ts = {}
    for name, sc in (("instanced", scene), ("flattened", flat)):
        r = dispatch.resolve(sc, cfg, dev)
        fs, is_ = bf.initial_state(o, d, spread, px, py)
        src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
        fs, is_, src = BC.sort_wavefront(fs, is_, src, True,
                                         BC.scene_bounds(sc.cluster_tables))
        ha, _ = BC.closest_paged(fs, is_, sc.cluster_tables,
                                 r.cluster_kslots, r.cluster_pages,
                                 float(r.max_ray_travel))
        ts[name] = (ha[BC.HA_T], ha[BC.HA_PRIM] >= 0, src)
    (t_i, h_i, src_i), (t_f, h_f, src_f) = ts["instanced"], ts["flattened"]
    if not torch.equal(src_i, src_f):
        failed("instancing: the bounce-0 sorts of the two scenes differ")
    both = h_i & h_f
    t_ok = (torch.abs(t_i - t_f) <= 1e-4 * torch.abs(t_f)) | ~both
    share = float(t_ok[both].float().mean()) if both.any() else 0.0
    from rtxpt_tpu_torch.accel.tlas import intersect_closest_tlas
    exact = intersect_closest_tlas(
        scene.tlas, o.contiguous(), d.contiguous(),
        torch.zeros_like(spread), torch.full_like(spread, cfg.max_ray_travel))
    I.render_sample(flat, cam, cfg, w, h, 0)                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_f = I.render_sample(flat, cam, cfg, w, h, 1)["L"]
    torch.cuda.synchronize()
    flat_ms = (time.perf_counter() - t0) * 1e3
    cmp = dict(lanes_both_hit=int(both.sum()),
               hit_equal=float((h_i == h_f).float().mean()),
               t_within_1e4=share,
               hit_share_instanced=float(h_i.float().mean()),
               hit_share_flattened=float(h_f.float().mean()),
               hit_share_tlas_walk=float((exact.prim >= 0).float().mean()),
               flattened_ms_per_frame=flat_ms,
               rmse_1spp=rmse(images[1].cpu().numpy(), img_f.cpu().numpy()),
               mean_instanced=lit, mean_flattened=float(img_f.mean()))
    rec["vs_flattened"] = cmp
    print(f"instancing vs flattened: bounce-0 t within 1e-4 relative on "
          f"{share:.6f} of {cmp['lanes_both_hit']} lanes that both hit, "
          f"hit flags equal {cmp['hit_equal']:.6f}; bounce-0 hit share "
          f"{cmp['hit_share_instanced']:.4f} instanced, "
          f"{cmp['hit_share_flattened']:.4f} flattened, "
          f"{cmp['hit_share_tlas_walk']:.4f} by the TLAS walk; flattened "
          f"frame {flat_ms:.3f} ms; 1-spp images RMSE "
          f"{cmp['rmse_1spp']:.6f}, means {lit:.6f} vs "
          f"{cmp['mean_flattened']:.6f} ({smi})", flush=True)
    if share < LANE_FRACTION or not bool(torch.isfinite(img_f).all()):
        failed("instancing: the instanced scene's hits miss the flattened "
               "scene's")
    dump()

    # 4. the TLAS route: the boxes through the TLAS walk against the same
    # host flattened, both on the general tier (tests/test_tlas.py:203-214)
    boxes = instanced_boxes(TLAS_GRID)
    sc_t = prepare(boxes, device=dev)
    sc_f = prepare(boxes, device=dev, instancing="off")
    cfg_t = PathTracerConfig(max_bounces=3, nee=NEEMode.POWER)
    if dispatch.resolve(sc_t, cfg_t, dev).kernel_tier != "xla" \
            or sc_t.tlas is None:
        failed("instancing: the boxes do not resolve to the TLAS walk")
    s = TLAS_SIDE
    cam_b = look_at([4.5, 3.5, 4.5], [0, 0.5, 0], [0, 1, 0], 45.0, s, s,
                    device=dev)
    kernels.launches.clear()
    img_t, _, _ = I.render(sc_t, cam_b, cfg_t, s, s, spp=TLAS_SPP)
    tlas_launches = dict(kernels.launches)
    img_fl, _, _ = I.render(sc_f, cam_b, dataclasses.replace(
        cfg_t, kernel_tier="xla"), s, s, spp=TLAS_SPP)
    e = rmse(img_t.cpu().numpy(), img_fl.cpu().numpy())
    route = dict(rmse=e, mean_tlas=float(img_t.mean()),
                 mean_flattened=float(img_fl.mean()),
                 kernel_launches=tlas_launches)
    print(f"instancing TLAS route: boxes {s}x{s} {TLAS_SPP} spp, TLAS walk "
          f"vs flattened RMSE {e:.6f} (limit 2e-3), means "
          f"{route['mean_tlas']:.6f} vs {route['mean_flattened']:.6f}, "
          f"kernel launches {tlas_launches}", flush=True)
    if not (e < 2e-3 and bool(torch.isfinite(img_t).all())
            and route["mean_tlas"] > 1e-3 and not tlas_launches):
        rec["tlas_route"] = route
        failed("instancing: the TLAS route misses the flattened scene")

    # one timed and one profiled 1080p 1-spp frame of the TLAS route
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    cfg_1080 = dataclasses.replace(cfg_t, max_bounces=4, ray_chunk=1 << 30)
    cam_1080 = look_at([4.5, 3.5, 4.5], [0, 0.5, 0], [0, 1, 0], 45.0, w, h,
                       device=dev)
    I.render_sample(sc_t, cam_1080, cfg_1080, w, h, 0)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = I.render_sample(sc_t, cam_1080, cfg_1080, w, h, 1)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        I.render_sample(sc_t, cam_1080, cfg_1080, w, h, 2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    split, _ = _split(prof, wall, ("camera",), ())
    device_launches = sum(evt.count for evt in prof.key_averages()
                          if evt.device_type == DeviceType.CUDA)
    route.update(frame_ms_1080p=frame_ms, rays=int(out["ray_count"]),
                 mrays_per_s=int(out["ray_count"]) / frame_ms / 1e3,
                 device_launches_per_frame=device_launches,
                 idle_share=split["idle_share"],
                 device_busy_ms=split["device_busy"], wall_ms=wall,
                 L_mean=float(out["L"].mean()), card=smi)
    rec["tlas_route"] = route
    print(f"instancing TLAS route 1080p: {frame_ms:.3f} ms per 1-spp frame, "
          f"{route['rays']} rays ({route['mrays_per_s']:.3f} Mrays/s), "
          f"{device_launches} device launches per frame, device idle "
          f"{100 * split['idle_share']:.1f}% ({smi})", flush=True)
    if not bool(torch.isfinite(out["L"]).all()):
        failed("instancing: the 1080p TLAS route gave non-finite values")
    record["instancing"] = rec
    dump()
    return [dict(checked["kernels"][name], launches=launched.get(name, 0))
            for name in ("cluster_closest_inst", "cluster_shadow_inst")]


ENV_CHUNK = 1 << 18           # phase 12: the sky Cornell path's rays per chunk
ENV_SPP = 2                   # phase 12: timed samples of each full-size path


def _environment(record, dev, smi, dump, city_prepared):
    """Phase 12: the environment and the clustered tier's external NEE.
    (a) K1's has_env and final_env variants against their plain version
    on the sky Cornell box; (b) K4's has_env, final_env and export slots 3
    and 5 on the sky city (K3 and K5 as phase 6); (c) the three full-size
    paths (sky Cornell fused, sky city clustered with one profiled frame,
    NEE-AT on the city through render_adaptive); (d) the small sky city
    through kernels and plain versions, and the sky city's 1-spp image on
    the general tier against the clustered tier's. Returns dict(entries
    {name: kernel-line entry}, k4_modes, launches {path: counts})."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.lighting.sky import make_sky
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render_adaptive, render_sample)
    from rtxpt_tpu_torch.scene.procedural import (
        city_overview, city_scene, cornell_box, default_camera)
    from rtxpt_tpu_torch.utils.image import rmse

    rec = {}
    record["environment"] = rec
    w, h = CITY_FRAME
    sample = 1

    def camera_state(host, cfg, cols, rows):
        """Camera rays of a cols x rows grid of the 1080p frame's
        pixels."""
        cam = default_camera(host, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        return bf.initial_state(o, d, spread, px, py)

    def check(label, kern_rows, plain_rows, surf=None):
        summary, err = _compare_state(kern_rows, plain_rows)
        ok = _state_ok(summary)
        if surf is not None:
            int_eq = (kern_rows[1] == plain_rows[1]).all(0) \
                & (kern_rows[2][1] == plain_rows[2][1])
            sf, serr = _compare(dict(surf=surf[0]), dict(surf=surf[1]),
                                int_eq)
            summary.update(worst_surf_row=sf["worst_float_row"])
            ok = ok and sf["worst_float_row"] >= LANE_FRACTION
            err = max(err, serr)
        rec[label] = summary
        print(f"environment {label}: int lanes equal "
              f"{summary['int_lanes_equal']:.6f}, worst float row "
              f"{summary['worst_float_row']:.6f}"
              + (f", worst SF row {summary['worst_surf_row']:.6f}"
                 if surf is not None else "")
              + f", L mean {summary['L_mean_kernel']:.6f} vs "
              f"{summary['L_mean_plain']:.6f}, max abs err {err:.3g}",
              flush=True)
        if not ok:
            dump()
            _fail(f"environment: a kernel disagrees with its plain version "
                  f"({label})")
        return err

    # ---- (a) K1's environment switches on the sky Cornell box ----
    sky_host = cornell_box()
    sky_host.envmap_image = make_sky()
    sky = prepare(sky_host, device=dev)
    tbl = sky.bounce_tables
    if tbl.env is None or sky.lights.env_light < 0:
        _fail("environment: the sky Cornell box has no environment table")
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=ENV_CHUNK)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    err = dict(bounce_fused_env=0.0, bounce_fused_final=0.0,
               cluster_shade_env=0.0, cluster_shade_final=0.0,
               cluster_shade=0.0)
    fs, is_ = camera_state(sky_host, cfg, CMP_SIDE, CMP_SIDE)
    for b in range(cfg.max_bounces + 1):
        final = b == cfg.max_bounces
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample,
                                    final_env=final)
        if b in (0, 2) or final:
            kern = _k1_audited("environment", lambda: bf.bounce(
                fs, is_, tbl, kcfg, sample, final_env=final), plain)
            name = "bounce_fused_final" if final else "bounce_fused_env"
            err[name] = max(err[name], check(
                f"k1 {'final_env' if final else f'bounce {b}'}", kern,
                plain))
        fs, is_ = plain[0], plain[1]
    _k1_report(record, "environment", dump)
    # timed at the path's launch width: 2^18 camera rays, bounce 0, and
    # the final round's launch on the same rays
    fs_t, is_t = camera_state(sky_host, cfg, 512, 512)
    n = fs_t.shape[1]
    active = int((is_t[bf.IS_ACTIVE] > 0).sum())
    k1 = {}
    for name, final in (("bounce_fused_env", False),
                        ("bounce_fused_final", True)):
        ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample,
                                        final_env=final), 20)
        plain_ms = _cuda_ms(lambda: bf.bounce_reference(
            fs_t, is_t, tbl, kcfg, sample, final_env=final), 3)
        # as phase 3: the state read and written once, the hit rows
        # written, the tables it reads (the environment's 164 KB among
        # them; the final round reads no attribute, material or light
        # table) read once, every active lane against every triangle, the
        # shadow rays up to their first occluder
        tables_bytes = 4 * sum(t.numel() for t in (
            (tbl.tri_coef, tbl.env) if final else
            (tbl.tri_coef, tbl.attr_rows, tbl.mat_rows, tbl.light_rows,
             tbl.env)))
        pairs = active * tbl.n_tris + _k1_shadow_pairs(
            lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample,
                                        final_env=final))
        bound, by, _ = _bound(
            4 * n * (2 * (bf.NF + bf.NI) + bf.NH) + tables_bytes,
            **_k1_ops(tbl.n_tris, pairs))
        k1[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, rays=n)
        print(f"environment {name}: kernel {ms:.4f} ms per {n}-ray launch, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) ({smi})",
              flush=True)
    rec["k1"] = k1
    dump()

    # ---- (b) K4's environment switches and export on the sky city ----
    t0 = time.perf_counter()
    city_host = city_overview(city_scene(CITY_TRIS, seed=CITY_SEED,
                                         with_env=True))
    city = prepare(city_host, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    ctbl = city.cluster_tables
    if ctbl.env is None:
        _fail("environment: the sky city has no environment table")
    checks = _cluster_kernel_checks(record, dev, smi, dump, "sky_city",
                                    city_host, city, prep_s, CITY_PAGES)
    k4_env = checks["kernels"]["cluster_shade_env"]
    ccfg = dispatch.resolve(city, PathTracerConfig(
        max_bounces=4, nee=NEEMode.POWER, ray_chunk=1 << 30), dev)
    kslots, pages = ccfg.cluster_kslots, ccfg.cluster_pages
    bounds_ = BC.scene_bounds(ctbl)
    modes = dict(final=(bf.KernelConfig.from_cfg(ccfg), True),
                 slot3=(bf.KernelConfig(nee_mode=3, maxb=4), False),
                 slot5=(bf.KernelConfig(nee_mode=5, maxb=4), False))

    def hits(fs_, is_):
        ha, _ = BC.closest_paged(fs_, is_, ctbl, kslots, pages, 1e27)
        return BC.post_attr_inst(ha, ctbl)

    def compare_modes(label, ha, fs, is_):
        """K4's final_env and slots 3 and 5 against the plain version on
        one state; the SH rows too."""
        for mode, (kc, final) in modes.items():
            plain = BC.shade_reference(ha, fs, is_, ctbl, kc, sample, final)
            kern = BC.shade(ha, fs, is_, ctbl, kc, sample, final_env=final)
            torch.cuda.synchronize()
            name = "cluster_shade_final" if final else "cluster_shade"
            e = check(f"k4 {mode} {label}", (kern[0], kern[1], kern[3]),
                      (plain[0], plain[1], plain[3]),
                      surf=None if final else (kern[4], plain[4]))
            sh, e_sh = _compare(dict(sh=kern[2]), dict(sh=plain[2]),
                                (kern[1] == plain[1]).all(0))
            if sh["worst_float_row"] < LANE_FRACTION:
                dump()
                _fail(f"environment: K4 {mode}'s SH rows disagree")
            err[name] = max(err[name], e, e_sh)

    # bounce 0 on the camera rays spread over the frame (those that see
    # the sky gather it in the final round); bounce 2 on the 64 groups of
    # the sorted 1080p wavefront with the most hits, carried there by the
    # kernels as on the path (phase 6's window)
    fs, is_ = camera_state(city_host, ccfg, CMP_SIDE, CMP_SIDE)
    compare_modes("bounce 0", hits(fs, is_), fs, is_)
    cmp_groups = fs.shape[1] // BC.FL
    fs, is_ = camera_state(city_host, ccfg, w, h)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    for b in range(3):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds_)
        ha = hits(fs, is_)
        if b < 2:
            fs, is_ = BC.shade(ha, fs, is_, ctbl, modes["final"][0],
                               sample)[:2]
    run = torch.cumsum((ha[BC.HA_PRIM] >= 0).view(-1, BC.FL).sum(1), 0)
    run = torch.cat([run.new_zeros(1), run])
    g0 = int(torch.argmax(run[cmp_groups:] - run[:-cmp_groups]))
    lanes = slice(g0 * BC.FL, (g0 + cmp_groups) * BC.FL)
    compare_modes(f"bounce 2 (groups {g0}-{g0 + cmp_groups - 1} of the "
                  f"sorted 1080p wavefront)", ha[:, lanes].contiguous(),
                  fs[:, lanes].contiguous(), is_[:, lanes].contiguous())
    # timed at the city path's 1080p bounce-0 launch
    fs, is_ = camera_state(city_host, ccfg, w, h)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    fs, is_, src = BC.sort_wavefront(fs, is_, src, True, bounds_)
    ha = hits(fs, is_)
    n = fs.shape[1]
    k4_modes = {}
    for mode, (kc, final) in modes.items():
        ms = _cuda_ms(lambda: BC.shade(ha, fs, is_, ctbl, kc, sample,
                                       final_env=final), 10)
        plain_ms = _cuda_ms(lambda: BC.shade_reference(
            ha, fs, is_, ctbl, kc, sample, final), 1)
        # each row it reads once, each it writes once: the final round
        # reads the hit rows t, u, v, front and prim (no attribute, no
        # material or light table), the export writes the SF_* rows
        ext = kc.external and ctbl.n_lights > 0 and not final
        bound, by, _ = _bound(_k4_bytes(n, ctbl, False, ext, final=final))
        k4_modes[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, lanes=n)
        print(f"environment K4 {mode}: kernel {ms:.4f} ms per {n}-lane "
              f"launch, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}) ({smi})", flush=True)
    rec["k4"] = k4_modes
    dump()

    # ---- (c) the three full-size paths ----
    launches = {}
    cam = default_camera(sky_host, w, h, device=dev)
    render_sample(sky, cam, cfg, w, h, 0)                       # warm-up
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    acc, rays = None, 0
    for s_ in range(1, 1 + ENV_SPP):
        out = render_sample(sky, cam, cfg, w, h, s_)
        acc = out["L"] if acc is None else acc + out["L"]
        rays = rays + out["ray_count"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["sky_cornell"] = dict(kernels.launches)
    chunks = -(-(w * h) // cfg.ray_chunk)
    want = dict(bounce_fused_env=chunks * cfg.max_bounces * ENV_SPP,
                bounce_fused_final=chunks * ENV_SPP)
    hdr = acc / ENV_SPP
    rays = int(rays)
    p = dict(res=f"{w}x{h}", spp_timed=ENV_SPP, chunks=chunks,
             launches=launches["sky_cornell"], expected=want, rays=rays,
             seconds=dt, mrays_per_s=rays / dt / 1e6,
             ms_per_frame_1spp=dt / ENV_SPP * 1e3, L_mean=float(hdr.mean()),
             finite=bool(torch.isfinite(hdr).all()), tier=out["kernel_tier"],
             card=smi)
    rec["sky_cornell_path"] = p
    print(f"environment path sky_cornell: {p['mrays_per_s']:.3f} Mrays/s, "
          f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, {rays} rays, "
          f"launches {p['launches']} of {want}, mean L {p['L_mean']:.5f} "
          f"({smi})", flush=True)
    if p["launches"] != want or not p["finite"] or p["tier"] != "fused":
        dump()
        _fail("environment: the sky Cornell path did not run every bounce "
              "and the final round through K1's environment variants")

    launches["sky_city"], images = _city_path(
        record, dev, smi, dump, (city_host, city, prep_s),
        label="sky_city_path")

    host_c, flat_city, _ = city_prepared
    ncfg = PathTracerConfig(max_bounces=4, nee=NEEMode.NEEAT,
                            ray_chunk=1 << 30)
    ncam = default_camera(host_c, w, h, device=dev)
    render_adaptive(flat_city, ncam, ncfg, w, h, 1)             # warm-up
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    hdr, state, rays = render_adaptive(flat_city, ncam, ncfg, w, h, ENV_SPP,
                                       first_sample=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["neeat_city"] = dict(kernels.launches)
    resolved = dispatch.resolve(flat_city, ncfg, dev, state)
    cp = resolved.cluster_pages
    want = dict(cluster_closest=cp * 4 * ENV_SPP,
                cluster_shade=4 * ENV_SPP,
                cluster_shadow=cp * 4 * ENV_SPP)
    lit = state.conf > 0
    moved = (state.tile_pdf - 1.0 / state.n_lights).abs().amax(1) > 1e-3
    p = dict(res=f"{w}x{h}", spp_timed=ENV_SPP,
             launches=launches["neeat_city"], expected=want, rays=rays,
             seconds=dt, mrays_per_s=rays / dt / 1e6,
             ms_per_frame_1spp=dt / ENV_SPP * 1e3, L_mean=float(hdr.mean()),
             finite=bool(torch.isfinite(hdr).all()),
             tier=resolved.kernel_tier, nee_external=resolved.nee_external,
             lit_tiles=int(lit.sum()), tiles=int(lit.numel()),
             lit_not_uniform=float(moved[lit].float().mean())
             if lit.any() else 0.0, card=smi)
    rec["neeat_city_path"] = p
    print(f"environment path neeat_city: {p['mrays_per_s']:.3f} Mrays/s, "
          f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, {rays} rays, "
          f"launches {p['launches']} of {want}, mean L {p['L_mean']:.5f}, "
          f"{p['lit_tiles']} of {p['tiles']} tiles lit, "
          f"{p['lit_not_uniform']:.4f} of them off the uniform pmf ({smi})",
          flush=True)
    if p["launches"] != want or not p["finite"] or \
            p["tier"] != "clustered" or not p["nee_external"] or \
            p["lit_tiles"] == 0 or p["lit_not_uniform"] < 0.9:
        dump()
        _fail("environment: the NEE-AT city did not run the clustered "
              "external route, gave non-finite values or learned nothing")
    dump()

    # ---- (d) images ----
    _city_parity(record, dev, dump, with_env=True, label="sky_city_parity")
    xcfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            ray_chunk=1 << 30, kernel_tier="xla")
    ccam = default_camera(city_host, w, h, device=dev)
    gen = render_sample(city, ccam, xcfg, w, h, 1)["L"]
    clu = images[1]
    e = rmse(gen.cpu().numpy(), clu.cpu().numpy())
    rec["sky_city_general_vs_clustered"] = dict(
        rmse=e, mean_general=float(gen.mean()), mean_clustered=float(
            clu.mean()), finite=bool(torch.isfinite(gen).all()))
    print(f"environment sky city, general vs clustered tier (sample 1): "
          f"RMSE {e:.5f}, means {float(gen.mean()):.5f} vs "
          f"{float(clu.mean()):.5f}", flush=True)
    if not torch.isfinite(gen).all():
        dump()
        _fail("environment: the general tier's sky city is not finite")
    dump()

    src = "rtxpt_tpu_torch/csrc/"
    entries = {
        name: dict(name=name, route="cuda", source=src + "bounce_fused.cu",
                   replaces="rtxpt_tpu/pt/bounce_pallas.py:1389",
                   launches=launches["sky_cornell"].get(name, 0),
                   launches_by_path=dict(
                       sky_cornell=launches["sky_cornell"].get(name, 0)),
                   max_abs_err=err[name], library_ms=None,
                   **{k: k1[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")})
        for name in ("bounce_fused_env", "bounce_fused_final")}
    entries["cluster_shade_env"] = dict(
        k4_env, launches=launches["sky_city"].get("cluster_shade_env", 0),
        max_abs_err=max(k4_env["max_abs_err"], err["cluster_shade_env"]))
    entries["cluster_shade_final"] = dict(
        name="cluster_shade_final", route="cuda",
        source=src + "cluster_shade.cu",
        replaces="rtxpt_tpu/pt/bounce_clustered.py:462",
        launches=launches["sky_city"].get("cluster_shade_final", 0),
        launches_by_path=dict(sky_city=launches["sky_city"].get(
            "cluster_shade_final", 0)),
        max_abs_err=err["cluster_shade_final"], library_ms=None,
        **{k: k4_modes["final"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")})
    return dict(entries=entries, launches=launches,
                k4_modes={k: v for k, v in k4_modes.items() if k != "final"},
                k4_export_err=err["cluster_shade"])


TEX_CHUNK = 1 << 18           # phase 13: the fused paths' rays per chunk
TEX_SPP = 2                   # phase 13: timed samples of each full-size path
KITCHEN_GENERAL_FRAME = (960, 540)   # the reference harness's frame


def _textured_cornell():
    """The textured Cornell box with every map: checker base colour,
    metal-rough on the tall box, the ripple normal map, the sky, and the
    light's emission textured (no procedural scene sets emissive_tex)."""
    import torch

    from rtxpt_tpu_torch.scene.procedural import textured_cornell
    host = textured_cornell(with_env=True, with_mr=True, with_normal=True)
    host.materials = host.materials.replace(
        emissive_tex=torch.tensor([-1, -1, -1, 1, -1], dtype=torch.int32))
    return host


def _textures(record, dev, smi, dump):
    """Phase 13: textures, normal maps and stochastic texture filtering.
    (a) K1's texture variant against its plain version on the textured
    Cornell box (slot 2) and the kitchen (slot 5, SF_* rows); both timed
    at 2^18 rays with their registers and spills. (b) K3, K4's texture
    variant and K5 on the textured, normal-mapped sky city as phase 6.
    (c) The three full-size paths with stochastic filtering: the textured
    Cornell box (fused), the kitchen (fused, external NEE), the textured
    city (clustered, profiled); and the kitchen without it on the general
    tier at 960x540. Returns dict(entries {name: kernel-line entry},
    launches {path: counts}, k3_err, k5_err)."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render_sample)
    from rtxpt_tpu_torch.pt.nee_external import external_nee
    from rtxpt_tpu_torch.scene.procedural import (
        city_overview, city_scene, default_camera, kitchen_scene)

    rec = {}
    record["textures"] = rec
    w, h = CITY_FRAME
    sample = 1
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=TEX_CHUNK,
                           stochastic_texture_filtering=True)

    def camera_state(host, cfg_, cols, rows):
        """Camera rays of a cols x rows grid of the 1080p frame's pixels."""
        cam = default_camera(host, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg_, px, py, sample)
        return bf.initial_state(o, d, spread, px, py)

    def kitchen_k2(scene, rcfg, out, fs, is_, b):
        """K2 against its plain version on the shadow requests external_nee
        builds from K1's export `out` of the state (fs, is_) at bounce b:
        occ and tests on every lane, and the screen's counters."""
        res = external_nee(scene, rcfg, None, out[3],
                           fs[bf.FS_D:bf.FS_D + 3], out[2][5] > 0.5,
                           fs[bf.FS_PREVPDF], is_[bf.IS_PREVDELTA] > 0,
                           out[1][bf.IS_PX], out[1][bf.IS_PY], sample, b)
        sh = bf.shadow_requests(res["shadow_o"], res["shadow_d"],
                                res["sdist"], res["do_nee"])
        occ_p, tst_p = bf.occlusion_reference(scene.bounce_tables, sh,
                                              stats=True)
        bf.occlusion_screen_stats(dev, True)
        occ_k, tst_k = bf.occlusion(scene.bounce_tables, sh, stats=True)
        screen = bf.occlusion_screen_stats(dev, False)
        req = sh[bf.SR_DO] > 0.5
        return dict(occ_lanes_differ=int((occ_k != occ_p).sum()),
                    tests_equal=bool(torch.equal(tst_k, tst_p)),
                    requests=int(req.sum()),
                    occluded=int((req & (occ_p > 0.5)).sum()),
                    screen=screen)

    # ---- (a) K1's texture switch ----
    hosts = dict(cornell=_textured_cornell(), kitchen=kitchen_scene())
    scenes = {k: prepare(v, device=dev) for k, v in hosts.items()}
    k1_err = 0.0
    k1 = {}
    ext = None
    for name, scene in scenes.items():
        tbl = scene.bounce_tables
        rcfg = dispatch.resolve(scene, cfg, dev)
        kcfg = bf.KernelConfig.from_cfg(rcfg)
        if tbl.tex is None or not bf.use_tex(tbl, kcfg) or \
                kcfg.nee_mode != (5 if name == "kitchen" else 2):
            _fail(f"textures: the {name} does not run K1's texture switch "
                  f"in its slot")
        print(f"textures: {name} {tbl.n_tris} triangles, {tbl.n_lights} "
              f"lights, {tbl.tex.shape[0]} texels, tex_maps {tbl.tex_maps}, "
              f"nee slot {kcfg.nee_mode}", flush=True)
        fs, is_ = camera_state(hosts[name], rcfg, CMP_SIDE, CMP_SIDE)
        for b in range(3):
            plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample)
            if b in (0, 2):
                kern = _k1_audited("textures", lambda: bf.bounce(
                    fs, is_, tbl, kcfg, sample), plain)
                summary, err = _compare_state(kern[:3], plain[:3])
                ok = _state_ok(summary)
                if kcfg.external:
                    int_eq = (kern[1] == plain[1]).all(0) \
                        & (kern[2][1] == plain[2][1])
                    sf, serr = _compare(dict(surf=kern[3]),
                                        dict(surf=plain[3]), int_eq)
                    summary.update(worst_surf_row=sf["worst_float_row"])
                    ok = ok and sf["worst_float_row"] >= LANE_FRACTION
                    err = max(err, serr)
                k1_err = max(k1_err, err)
                rec[f"k1_{name}_bounce{b}"] = summary
                print(f"textures k1 {name} bounce {b}: int lanes equal "
                      f"{summary['int_lanes_equal']:.6f}, worst float row "
                      f"{summary['worst_float_row']:.6f}"
                      + (f", worst SF row {summary['worst_surf_row']:.6f}"
                         if kcfg.external else "")
                      + f", L mean {summary['L_mean_kernel']:.6f} vs "
                      f"{summary['L_mean_plain']:.6f}, max abs err "
                      f"{err:.3g}", flush=True)
                if not ok:
                    dump()
                    _fail(f"textures: K1's texture variant disagrees with "
                          f"its plain version on the {name} at bounce {b}")
                if kcfg.external:
                    k2s = kitchen_k2(scene, rcfg, plain, fs, is_, b)
                    rec[f"k2_{name}_bounce{b}"] = k2s
                    print(f"textures k2 {name} bounce {b}: "
                          f"{json.dumps(k2s)}", flush=True)
                    if k2s["occ_lanes_differ"] or not k2s["tests_equal"] \
                            or k2s["screen"]["missed"] or not \
                            k2s["screen"]["shadow_pairs"]:
                        dump()
                        _fail(f"textures: K2 disagrees with its plain "
                              f"version on the {name} at bounce {b}")
            fs, is_ = plain[0], plain[1]
        # timed at the path's launch width: 2^18 camera rays, bounce 0
        side_t = int(round(RAYS_TIMED ** 0.5))
        fs_t, is_t = camera_state(hosts[name], rcfg, side_t, side_t)
        n = fs_t.shape[1]
        active = int((is_t[bf.IS_ACTIVE] > 0).sum())
        ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample), 10)
        plain_ms = _cuda_ms(lambda: bf.bounce_reference(
            fs_t, is_t, tbl, kcfg, sample), 2)
        # as phase 3: the state read and written once, the hit (and SF_*)
        # rows written, the tables read once (the atlas and its meta rows
        # among them), every active lane against every triangle, the
        # in-kernel shadow rays up to their first occluder
        rows = 2 * (bf.NF + bf.NI) + bf.NH \
            + (bf.SF_ROWS if kcfg.external else 0)
        tables_bytes = 4 * sum(t.numel() for t in (
            tbl.tri_coef, tbl.attr_rows, tbl.mat_rows, tbl.light_rows,
            tbl.env, tbl.tex, tbl.tex_meta))
        pairs = active * tbl.n_tris + _k1_shadow_pairs(
            lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample))
        bound, by, _ = _bound(4 * n * rows + tables_bytes,
                              **_k1_ops(tbl.n_tris, pairs))
        k1[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, rays=n, slot=kcfg.nee_mode)
        print(f"textures k1 {name} slot {kcfg.nee_mode}: kernel {ms:.4f} ms "
              f"per {n}-ray launch, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}) ({smi})", flush=True)
        if name == "kitchen":
            ext = (scene, rcfg)
            # K2 on the same launch's external requests, timed
            out_t = bf.bounce(fs_t, is_t, tbl, kcfg, sample)
            res = external_nee(scene, rcfg, None, out_t[3],
                               fs_t[bf.FS_D:bf.FS_D + 3], out_t[2][5] > 0.5,
                               fs_t[bf.FS_PREVPDF],
                               is_t[bf.IS_PREVDELTA] > 0,
                               out_t[1][bf.IS_PX], out_t[1][bf.IS_PY],
                               sample, 0)
            sh_t = bf.shadow_requests(res["shadow_o"], res["shadow_d"],
                                      res["sdist"], res["do_nee"])
            k2_ms = _cuda_ms(lambda: bf.occlusion(tbl, sh_t), 20)
            k2_plain = _cuda_ms(lambda: bf.occlusion_reference(tbl, sh_t), 1)
            _, tests = bf.occlusion(tbl, sh_t, stats=True)
            k2_pairs = int(tests.sum())
            k2_bound, k2_by, _ = _bound(
                n * SR_BYTES + 4 * tbl.tri_coef.numel(),
                **_k1_ops(tbl.n_tris, k2_pairs))
            rec["k2_kitchen"] = dict(
                ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                bound_by=k2_by, lanes=n, pairs=k2_pairs,
                requests=int((sh_t[bf.SR_DO] > 0.5).sum()))
            print(f"textures k2 kitchen: kernel {k2_ms:.4f} ms per {n}-lane "
                  f"launch ({rec['k2_kitchen']['requests']} requests, "
                  f"{k2_pairs} pairs), plain {k2_plain:.4f} ms, bound "
                  f"{k2_bound:.4f} ms ({k2_by}) ({smi})", flush=True)
    _k1_report(record, "textures", dump)
    # registers and spills of each K1 and K4 instantiation
    regs = {f"{lib}_{'tex' if t else 'plain'}": _ptxas_entry(
        getattr(kernels, attr).ptxas_log,
        f"{lib}_kernelILb{int(t)}ELb0ELb0ELb0E")
        for lib, attr in (("bounce_fused", "BOUNCE_FUSED"),
                          ("cluster_shade", "CLUSTER_SHADE"))
        for t in (False, True)}
    rec.update(k1=k1, ptxas=regs)
    print(f"textures ptxas: {json.dumps(regs)}", flush=True)
    dump()

    # ---- (b) K3, K4's texture switch and K5 on the textured city ----
    t0 = time.perf_counter()
    city_host = city_overview(city_scene(CITY_TRIS, seed=CITY_SEED,
                                         textured=True, normal_mapped=True,
                                         with_env=True))
    city = prepare(city_host, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    if city.cluster_tables.tex is None:
        _fail("textures: the textured city has no texture tables")
    checks = _cluster_kernel_checks(record, dev, smi, dump, "tex_city",
                                    city_host, city, prep_s, CITY_PAGES,
                                    stf=True)
    k4 = checks["kernels"]["cluster_shade_tex_env"]

    # ---- (c) the full-size paths ----
    launches = {}
    paths = {}
    for name in ("cornell", "kitchen"):
        scene, host = scenes[name], hosts[name]
        cam = default_camera(host, w, h, device=dev)
        render_sample(scene, cam, cfg, w, h, 0)                 # warm-up
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        acc, rays = None, 0
        for s_ in range(1, 1 + TEX_SPP):
            out = render_sample(scene, cam, cfg, w, h, s_)
            acc = out["L"] if acc is None else acc + out["L"]
            rays = rays + out["ray_count"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = dict(kernels.launches)
        chunks = -(-(w * h) // cfg.ray_chunk)
        want = dict(bounce_fused_tex_env=chunks * cfg.max_bounces * TEX_SPP,
                    bounce_fused_final=chunks * TEX_SPP)
        if name == "kitchen":
            want["shadow_occlusion"] = chunks * cfg.max_bounces * TEX_SPP
        hdr = acc / TEX_SPP
        rays = int(rays)
        p = dict(res=f"{w}x{h}", spp_timed=TEX_SPP, chunks=chunks,
                 launches=launches[name], expected=want, rays=rays,
                 seconds=dt, mrays_per_s=rays / dt / 1e6,
                 ms_per_frame_1spp=dt / TEX_SPP * 1e3,
                 L_mean=float(hdr.mean()),
                 finite=bool(torch.isfinite(hdr).all()),
                 tier=out["kernel_tier"], card=smi)
        paths[name] = p
        print(f"textures path {name}: {p['mrays_per_s']:.3f} Mrays/s, "
              f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, {rays} "
              f"rays, launches {p['launches']} of {want}, mean L "
              f"{p['L_mean']:.5f} ({smi})", flush=True)
        if p["launches"] != want or not p["finite"] or p["tier"] != "fused" \
                or p["L_mean"] <= 0.0:
            dump()
            _fail(f"textures: the {name} path did not run every bounce "
                  f"through K1's texture variant or gave non-finite values")
        if name == "kitchen":
            # one profiled frame: K1's device time and launches per frame
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                render_sample(scene, cam, cfg, w, h, TEX_SPP + 1)
                torch.cuda.synchronize()
            p["k1_frame"] = k1_frame = _k1_frame(prof)
            print(f"textures path kitchen: K1 {k1_frame['ms']:.3f} ms of "
                  f"device time per profiled 1-spp frame over "
                  f"{k1_frame['launches']} launches (before its redesign: "
                  f"{K1_BEFORE['kitchen']}) ({smi})", flush=True)
    rec["paths"] = paths
    launches["city"], _ = _city_path(record, dev, smi, dump,
                                     (city_host, city, prep_s),
                                     label="tex_city_path", stf=True)

    # the kitchen without stochastic filtering: the general tier, bilinear
    gw, gh = KITCHEN_GENERAL_FRAME
    gcfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            ray_chunk=1 << 30)
    kitchen = scenes["kitchen"]
    gcam = default_camera(hosts["kitchen"], gw, gh, device=dev)
    # the warm-up frame: K8's bounce-0 launch held to its plain version on
    # every lane, and timed
    _, rec["kitchen_general_k8"], k8_ok = _k8_audit(
        "textures kitchen_general",
        lambda: render_sample(kitchen, gcam, gcfg, gw, gh, 0))
    if not k8_ok:
        dump()
        _fail("textures: K8 disagrees with its plain version on the "
              "kitchen")
    kernels.launches.clear()
    t0 = time.perf_counter()
    out = render_sample(kitchen, gcam, gcfg, gw, gh, 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["kitchen_general"] = dict(kernels.launches)
    p = dict(res=f"{gw}x{gh}", spp_timed=1, launches=launches[
        "kitchen_general"], rays=int(out["ray_count"]), seconds=dt,
        ms_per_frame_1spp=dt * 1e3, L_mean=float(out["L"].mean()),
        finite=bool(torch.isfinite(out["L"]).all()), tier=out["kernel_tier"],
        card=smi)
    rec["kitchen_general_path"] = p
    print(f"textures path kitchen_general (no STF, bilinear): "
          f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp {gw}x{gh} frame, "
          f"{p['rays']} rays, launches {p['launches']}, mean L "
          f"{p['L_mean']:.5f} ({smi})", flush=True)
    if p["tier"] != "xla" or not p["finite"] or \
            set(p["launches"]) != {"brute_closest"}:
        dump()
        _fail("textures: the kitchen without stochastic filtering did not "
              "run the general tier through K8")
    dump()

    src = "rtxpt_tpu_torch/csrc/"
    entries = {
        "bounce_fused_tex_env": dict(
            name="bounce_fused_tex_env", route="cuda",
            source=src + "bounce_fused.cu",
            replaces="rtxpt_tpu/pt/bounce_pallas.py:1389",
            launches=sum(launches[k].get("bounce_fused_tex_env", 0)
                         for k in ("cornell", "kitchen")),
            launches_by_path={k: launches[k].get("bounce_fused_tex_env", 0)
                              for k in ("cornell", "kitchen")},
            max_abs_err=k1_err, library_ms=None,
            modes=dict(slot5_kitchen=k1["kitchen"]),
            **{k: k1["cornell"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")}),
        "cluster_shade_tex_env": dict(
            k4, launches=launches["city"].get("cluster_shade_tex_env", 0))}
    return dict(entries=entries, launches=launches,
                k3_err=checks["kernels"]["cluster_closest"]["max_abs_err"],
                k5_err=checks["kernels"]["cluster_shadow"]["max_abs_err"],
                k8_kitchen=rec["kitchen_general_k8"])


ALPHA_CHUNK = 1 << 18         # phase 14: the fused paths' rays per chunk
ALPHA_SPP = 2                 # phase 14: timed samples of each full-size path
ALPHA_GENERAL_FRAME = (960, 540)   # phase 14 (e): the general tier's frame
ALPHA_K9_SIDE = 512           # phase 14: K9 timed on 512 x 512 rays


def _alpha_hosts():
    """Phase 14's scenes: the curtain Cornell box (one alpha-tested quad,
    an 8 x 8 checkerboard alpha), its 40 x 40 grid (a 64 x 64
    checkerboard; 3,212 triangles) and the foliage card (a 160 x 160 grid
    textured with leaf_texture(64); 51,212 triangles before the bake drops
    the TRANSPARENT ones)."""
    from rtxpt_tpu_torch.scene.procedural import curtain_cornell, leaf_texture
    return dict(curtain=curtain_cornell(True),
                grid=curtain_cornell(True, grid=40),
                foliage=curtain_cornell(True, grid=160,
                                        texture=leaf_texture(64)))


def _alpha_shares(scene, o, d, tmax):
    """(MIXED share, UNKNOWN share) of the rays o, d [3, N] whose first
    geometric hit (no alpha test) before tmax [N] lies on a MIXED triangle,
    and on one of its UNKNOWN micro-cells."""
    import torch

    from rtxpt_tpu_torch.accel.traverse import intersect_closest
    from rtxpt_tpu_torch.scene import omm

    n = o.shape[1]
    hit = intersect_closest(scene.bvh.replace(tri_micro=None),
                            o.T.contiguous(), d.T.contiguous(),
                            torch.zeros(n, device=o.device),
                            tmax.contiguous())
    prim = torch.clamp(hit.prim, min=0).long()
    mixed = ~hit.miss & (scene.tri_opacity[prim] == omm.MIXED)
    st = omm.micro_state(scene.tri_micromap[prim],
                         omm.micro_index(hit.bary[:, 0], hit.bary[:, 1]))
    unk = mixed & (st == omm.MICRO_UNKNOWN)
    return float(mixed.float().mean()), float(unk.float().mean())


def _passed_through(is_in, is_out):
    """Lanes that passed through an alpha-tested surface: active before
    and after the launch, their logical bounce kept."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    return (is_in[bf.IS_ACTIVE] > 0) & (is_out[bf.IS_ACTIVE] > 0) \
        & (is_out[bf.IS_LBOUNCE] == is_in[bf.IS_LBOUNCE])


def _passthrough_share(run):
    """Share of the lanes of one (untimed) frame's shading launches that
    passed through (an alpha test or a priority false hit), counted around
    the shading kernels' wrappers."""
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    counts = [0, 0]
    k1_, k4_ = bf.bounce, BC.shade

    def count(is_in, out):
        counts[0] += int(_passed_through(is_in, out[1]).sum())
        counts[1] += int((is_in[bf.IS_ACTIVE] > 0).sum())
        return out

    bf.bounce = lambda fs_, is__, *a, **k: count(is__, k1_(
        fs_, is__, *a, **k))
    BC.shade = lambda ha_, fs_, is__, *a, **k: count(is__, k4_(
        ha_, fs_, is__, *a, **k))
    try:
        run()
    finally:
        bf.bounce, BC.shade = k1_, k4_
    return counts[0] / max(counts[1], 1)


def _alpha(record, dev, smi, dump):
    """Phase 14: opacity micromaps and alpha-tested geometry on every
    tier. (a) K1's micromap variant (slot 2) and K2's (on the shadow
    requests of slot 5 and external_nee) on the curtain Cornell box;
    (b) K3, K4 and K5's micromap variants on the 40 x 40 curtain and the
    foliage card as phase 6; K9 with micromaps on the 40 x 40 curtain's
    BVH; every comparison at bounces 0 and 2 on 65,536 rays, with at
    least MIXED_SHARE of its lanes on MIXED triangles and UNKNOWN_SHARE on
    UNKNOWN cells; (c) the full-size paths at 1920x1080, 4 bounces,
    stochastic filtering: the curtain on the fused tier under power NEE
    and NEE-AT, the 40 x 40 curtain and the foliage on the clustered tier,
    each with its launches (the two pass-through iterations included),
    its share of lanes that passed through and one profiled frame; the
    curtain at 960x540 without filtering and the foliage on the general
    tier (K8 and the retrace; the K9 walk with micromaps). Returns
    dict(entries {name: kernel-line entry}, launches {path: counts})."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.accel import traverse
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.lighting import neeat as na
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render, render_adaptive, render_sample)
    from rtxpt_tpu_torch.pt.nee_external import external_nee
    from rtxpt_tpu_torch.scene.procedural import default_camera

    rec = {}
    record["alpha"] = rec
    w, h = CITY_FRAME
    sample = 1
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=ALPHA_CHUNK,
                           stochastic_texture_filtering=True)
    extra = cfg.passthrough_extra_iters
    hosts = _alpha_hosts()
    scenes, prep = {}, {}
    for name, host in hosts.items():
        t0 = time.perf_counter()
        scenes[name] = prepare(host, device=dev)
        torch.cuda.synchronize()
        prep[name] = time.perf_counter() - t0
        sc = scenes[name]
        cls = torch.bincount(sc.tri_opacity.long(), minlength=3).tolist()
        print(f"alpha: {name} {sc.geometry.num_triangles} triangles after "
              f"the bake ({sum(len(i.indices) for i in host.instances)} "
              f"before), classes opaque/mixed {cls[0]}/{cls[1]}, tier "
              f"{dispatch.resolve(sc, cfg, dev).kernel_tier}, prepare "
              f"{prep[name]:.2f}s", flush=True)

    def camera_state(host, cfg_, cols, rows):
        cam = default_camera(host, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg_, px, py, sample)
        return bf.initial_state(o, d, spread, px, py)

    def floors(label, mixed, unk):
        print(f"alpha {label}: MIXED share {mixed:.4f}, UNKNOWN share "
              f"{unk:.4f}", flush=True)
        if mixed < MIXED_SHARE or unk < UNKNOWN_SHARE:
            dump()
            _fail(f"alpha: {label}'s lanes exercise the micromaps too "
                  f"little")
        return dict(mixed_share=mixed, unknown_share=unk)

    # ---- (a) K1 (slot 2) and K2 (slot 5's requests) on the curtain ----
    curtain, ch = scenes["curtain"], hosts["curtain"]
    tbl = curtain.bounce_tables
    big = torch.full((CMP_SIDE * CMP_SIDE,), 1e27, device=dev)
    k1_err = k2_err = 0.0
    for slot, cfg_ in ((2, cfg), (5, dataclasses.replace(
            cfg, nee_external=True))):
        kcfg = bf.KernelConfig.from_cfg(cfg_)
        if not (tbl.omm and bf.use_tex(tbl, kcfg)) or kcfg.nee_mode != slot:
            _fail(f"alpha: the curtain does not run K1's micromap variant "
                  f"in slot {slot}")
        fs, is_ = camera_state(ch, cfg_, CMP_SIDE, CMP_SIDE)
        for b in range(3):
            plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample)
            if b in (0, 2):
                act = is_[bf.IS_ACTIVE] > 0
                share = floors(f"k1 slot {slot} bounce {b}", *_alpha_shares(
                    curtain, fs[bf.FS_O:bf.FS_O + 3][:, act],
                    fs[bf.FS_D:bf.FS_D + 3][:, act], big[act]))
                share["passed_through"] = float(_passed_through(
                    is_, plain[1]).float().mean())
                if slot == 2:
                    kern = _k1_audited("alpha", lambda: bf.bounce(
                        fs, is_, tbl, kcfg, sample), plain)
                    summary, err = _compare_state(kern, plain)
                    k1_err = max(k1_err, err)
                    summary.update(share)
                    rec[f"k1_bounce{b}"] = summary
                    print(f"alpha k1 bounce {b}: int lanes equal "
                          f"{summary['int_lanes_equal']:.6f}, worst float "
                          f"row {summary['worst_float_row']:.6f}, L mean "
                          f"{summary['L_mean_kernel']:.6f} vs "
                          f"{summary['L_mean_plain']:.6f}, max abs err "
                          f"{err:.3g}, passed through "
                          f"{share['passed_through']:.4f}", flush=True)
                    if not _state_ok(summary):
                        dump()
                        _fail(f"alpha: K1's micromap variant disagrees "
                              f"with its plain version at bounce {b}")
                else:
                    res = external_nee(
                        curtain, cfg_, None, plain[3], fs[bf.FS_D:bf.FS_D + 3],
                        plain[2][5] > 0.5, fs[bf.FS_PREVPDF],
                        is_[bf.IS_PREVDELTA] > 0, is_[bf.IS_PX],
                        is_[bf.IS_PY], sample, b, lb=is_[bf.IS_LBOUNCE])
                    ua = bf.alpha_uniform(cfg_, is_[bf.IS_PX], is_[bf.IS_PY],
                                          is_[bf.IS_LBOUNCE], sample)
                    sh = bf.shadow_requests(res["shadow_o"], res["shadow_d"],
                                            res["sdist"], res["do_nee"], ua)
                    req = sh[bf.SR_DO] > 0.5
                    sshare = floors(f"k2 bounce {b}", *_alpha_shares(
                        curtain, sh[bf.SR_O:bf.SR_O + 3][:, req],
                        sh[bf.SR_D:bf.SR_D + 3][:, req], sh[bf.SR_DIST][req]))
                    occ_k, tst_k = bf.occlusion(tbl, sh, stats=True)
                    occ_p, tst_p = bf.occlusion_reference(tbl, sh, stats=True)
                    torch.cuda.synchronize()
                    differ = int((occ_k != occ_p).sum())
                    k2_err = max(k2_err, float((occ_k - occ_p).abs().max()))
                    rec[f"k2_bounce{b}"] = dict(
                        occ_lanes_differ=differ,
                        tests_equal=bool(torch.equal(tst_k, tst_p)),
                        requests=int(req.sum()),
                        occluded=float(occ_p[req].mean()), **sshare)
                    print(f"alpha k2 bounce {b}: occlusion differs on "
                          f"{differ} lanes, {int(req.sum())} requests "
                          f"(occluded {float(occ_p[req].mean()):.4f}), "
                          f"tests equal "
                          f"{rec[f'k2_bounce{b}']['tests_equal']}",
                          flush=True)
                    if differ or not rec[f"k2_bounce{b}"]["tests_equal"]:
                        dump()
                        _fail(f"alpha: K2's micromap variant disagrees with "
                              f"its plain version at bounce {b}")
            fs, is_ = plain[0], plain[1]
    _k1_report(record, "alpha", dump)
    # both timed at the fused path's launch width: 2^18 camera rays,
    # bounce 0; K2 on slot 5's requests of the same rays
    side_t = int(round(RAYS_TIMED ** 0.5))
    fs_t, is_t = camera_state(ch, cfg, side_t, side_t)
    n = fs_t.shape[1]
    kcfg = bf.KernelConfig.from_cfg(cfg)
    active = int((is_t[bf.IS_ACTIVE] > 0).sum())
    k1_ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample), 10)
    k1_plain = _cuda_ms(lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg,
                                                    sample), 2)
    # as phase 13, with the micromap words and coverages (OMM_WORD_BYTES
    # each per triangle) among the tables read once; the MIP-0 alpha fetch
    # reads the same atlas
    tables_bytes = 4 * sum(t.numel() for t in (
        tbl.tri_coef, tbl.attr_rows, tbl.mat_rows, tbl.light_rows, tbl.tex,
        tbl.tex_meta, tbl.tri_micro, tbl.tri_cover))
    k1_pairs = active * tbl.n_tris + _k1_shadow_pairs(
        lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample))
    k1_bound, k1_by, _ = _bound(
        4 * n * (2 * (bf.NF + bf.NI) + bf.NH) + tables_bytes,
        **_k1_ops(tbl.n_tris, k1_pairs))
    kcfg5 = bf.KernelConfig.from_cfg(dataclasses.replace(cfg,
                                                         nee_external=True))
    out5 = bf.bounce(fs_t, is_t, tbl, kcfg5, sample)
    res = external_nee(curtain, dataclasses.replace(cfg, nee_external=True),
                       None, out5[3], fs_t[bf.FS_D:bf.FS_D + 3],
                       out5[2][5] > 0.5, fs_t[bf.FS_PREVPDF],
                       is_t[bf.IS_PREVDELTA] > 0, is_t[bf.IS_PX],
                       is_t[bf.IS_PY], sample, 0, lb=is_t[bf.IS_LBOUNCE])
    sh_t = bf.shadow_requests(
        res["shadow_o"], res["shadow_d"], res["sdist"], res["do_nee"],
        bf.alpha_uniform(cfg, is_t[bf.IS_PX], is_t[bf.IS_PY],
                         is_t[bf.IS_LBOUNCE], sample))
    k2_ms = _cuda_ms(lambda: bf.occlusion(tbl, sh_t), 20)
    k2_plain = _cuda_ms(lambda: bf.occlusion_reference(tbl, sh_t), 2)
    _, tests = bf.occlusion(tbl, sh_t, stats=True)
    k2_pairs = int(tests.sum())
    k2_bound, k2_by, _ = _bound(
        n * (SR_BYTES + 4) + 4 * (tbl.tri_coef.numel() + tbl.tri_micro.numel()
                                  + tbl.tri_cover.numel()),
        **_k1_ops(tbl.n_tris, k2_pairs))
    rec["k1"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                     bound_by=k1_by, rays=n)
    rec["k2"] = dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                     bound_by=k2_by, rays=n, pairs=k2_pairs,
                     requests=int((sh_t[bf.SR_DO] > 0.5).sum()))
    print(f"alpha k1: kernel {k1_ms:.4f} ms per {n}-ray launch, plain "
          f"{k1_plain:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}); k2: "
          f"kernel {k2_ms:.4f} ms ({rec['k2']['requests']} requests, "
          f"{k2_pairs} pairs), plain {k2_plain:.4f} ms, bound "
          f"{k2_bound:.4f} ms ({k2_by}) (before its redesign: "
          f"{K2_BEFORE['curtain']}) ({smi})", flush=True)
    rec["ptxas"] = {
        f"{lib}_{'omm' if o else 'plain'}_{'tex' if t else 'notex'}":
            _ptxas_entry(getattr(kernels, attr).ptxas_log,
                         f"{lib}_kernelILb{int(t)}ELb{int(o)}ELb0ELb0E")
        for lib, attr in (("bounce_fused", "BOUNCE_FUSED"),
                          ("cluster_shade", "CLUSTER_SHADE"))
        for t in (False, True) for o in (False, True)}
    print(f"alpha ptxas: {json.dumps(rec['ptxas'])}", flush=True)
    dump()

    # ---- (b) K3, K4, K5 on the clustered scenes; K9 ----
    # The foliage's bake leaves few MIXED triangles (its texels' edges fall
    # on the 160 x 160 grid's cell edges, so whole triangles are opaque or
    # transparent, and no cell is UNKNOWN): its comparison reports the
    # shares, the 40 x 40 curtain's holds them to the floors.
    checks = {}
    for name, pages in (("grid", 1), ("foliage", 2)):
        checks[name] = _cluster_kernel_checks(
            record, dev, smi, dump, f"alpha_{name}", hosts[name],
            scenes[name], prep[name], pages, stf=True, omm=True,
            floors=name == "grid")
    grid = scenes["grid"]
    bvh = grid.bvh
    k9 = dict(err=0.0)
    fs, is_ = camera_state(hosts["grid"], cfg, CMP_SIDE, CMP_SIDE)
    gcfg = dispatch.resolve(grid, cfg, dev)
    gk = bf.KernelConfig.from_cfg(gcfg)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    bounds_g = BC.scene_bounds(grid.cluster_tables)
    for b in range(3):
        o3 = fs[bf.FS_O:bf.FS_O + 3].T.contiguous()
        d3 = fs[bf.FS_D:bf.FS_D + 3].T.contiguous()
        if b in (0, 2):
            act = is_[bf.IS_ACTIVE] > 0
            nb = o3.shape[0]
            tmin = torch.zeros(nb, device=dev)
            tmax = torch.full((nb,), 1e27, device=dev)
            share = floors(f"k9 bounce {b}", *_alpha_shares(
                grid, o3.T[:, act], d3.T[:, act], tmax[act]))
            for any_hit in (False, True):
                kern = traverse.walk(bvh, o3, d3, tmin, tmax, any_hit, True)
                plain = traverse._traverse_wide(bvh, o3, d3, tmin, tmax,
                                                any_hit, True)
                torch.cuda.synchronize()
                same = kern["prim"] == plain["prim"]
                summ, err = _compare(
                    dict(t=kern["t"][None], uv=kern["uv"].T),
                    dict(t=plain["t"][None], uv=plain["uv"].T), same)
                summ.pop("float_rows")
                summ.update(_walk_agreement(kern, plain, any_hit), **share)
                k9["err"] = max(k9["err"], err)
                key = f"k9_{'any' if any_hit else 'closest'}_bounce{b}"
                rec[key] = summ
                print(f"alpha {key}: {summ['lanes_differ']} of {nb} lanes "
                      f"differ bit-wise, prims equal "
                      f"{summ['int_lanes_equal']:.6f}, visit and test "
                      f"counts equal {summ['counts_equal']}", flush=True)
                if not summ["ok"]:
                    dump()
                    _fail(f"alpha: K9's micromap test disagrees with its "
                          f"plain version at bounce {b}")
        # carry the rays on by the clustered kernels
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds_g)
        ha, _ = BC.closest_paged(fs, is_, grid.cluster_tables,
                                 gcfg.cluster_kslots, gcfg.cluster_pages,
                                 float(gcfg.max_ray_travel), omm=True)
        fs, is_ = BC.shade(ha, fs, is_, grid.cluster_tables, gk, sample,
                           omm=True)[:2]
    # K9 timed on 512 x 512 camera rays of the foliage, whose BVH the
    # foliage path walks; bound from its visit and test counts
    fol = scenes["foliage"]
    fs_k, _ = camera_state(hosts["foliage"], cfg, ALPHA_K9_SIDE,
                           ALPHA_K9_SIDE)
    o9 = fs_k[bf.FS_O:bf.FS_O + 3].T.contiguous()
    d9 = fs_k[bf.FS_D:bf.FS_D + 3].T.contiguous()
    n9 = o9.shape[0]
    t0_9 = torch.zeros(n9, device=dev)
    t1_9 = torch.full((n9,), 1e27, device=dev)
    k9_ms = _cuda_ms(lambda: traverse.walk(fol.bvh, o9, d9, t0_9, t1_9), 10)
    k9_plain = _cuda_ms(lambda: traverse._traverse_wide(
        fol.bvh, o9, d9, t0_9, t1_9, False), 1)
    st9 = traverse.walk(fol.bvh, o9, d9, t0_9, t1_9, stats=True)
    visits, tests9 = int(st9["visits"].sum()), int(st9["tests"].sum())
    k9_bound, k9_by, _ = _bound(
        n9 * RAY_BYTES + 4 * (fol.bvh.wide.numel() + fol.bvh.wide_tris.numel()
                              + fol.bvh.tri_micro.numel()),
        f32=visits * K9_NODE_F32 + tests9 * K9_TEST_F32)
    rec["k9"] = dict(ms=k9_ms, plain_ms=k9_plain, bound_ms=k9_bound,
                     bound_by=k9_by, rays=n9, visits=visits, tests=tests9,
                     wide_nodes=fol.bvh.num_wide)
    print(f"alpha k9 (foliage BVH, {fol.bvh.num_wide} wide nodes of "
          f"{fol.bvh.num_nodes}): kernel {k9_ms:.4f} ms per {n9}-ray "
          f"closest-hit launch ({visits / n9:.2f} wide visits, "
          f"{tests9 / n9:.3f} tests per ray), plain {k9_plain:.2f} ms, bound "
          f"{k9_bound:.4f} ms ({k9_by}) (before its redesign: "
          f"{K9_BEFORE['foliage']}) ({smi})", flush=True)
    dump()

    # ---- (c) the full-size paths ----
    from torch.profiler import ProfilerActivity, profile

    def path(label, scene, host, cfg_, tier, want, adaptive=False,
             frame=(w, h), profile_parts=()):
        fw, fh = frame
        cam = default_camera(host, fw, fh, device=dev)
        state = None

        def run(spp_, first):
            if adaptive:
                return render_adaptive(scene, cam, cfg_, fw, fh, spp_,
                                       first_sample=first)
            return render(scene, cam, cfg_, fw, fh, spp_, first_sample=first)
        run(1, 0)                                               # warm-up
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        hdr, state, rays = run(ALPHA_SPP, 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = dict(kernels.launches)
        resolved = dispatch.resolve(scene, cfg_, dev,
                                    state if adaptive else None)
        p = dict(res=f"{fw}x{fh}", spp_timed=ALPHA_SPP,
                 bounces=cfg_.max_bounces, launches=launched, expected=want,
                 rays=int(rays), seconds=dt,
                 mrays_per_s=int(rays) / dt / 1e6,
                 ms_per_frame_1spp=dt / ALPHA_SPP * 1e3,
                 L_mean=float(hdr.mean()),
                 finite=bool(torch.isfinite(hdr).all()),
                 tier=resolved.kernel_tier, card=smi)
        if tier != "xla":
            p["passed_through"] = _passthrough_share(lambda: run(1, 9))
        if profile_parts:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if adaptive:
                    out = render_sample(scene, cam, cfg_, fw, fh, 7,
                                        neeat_state=state)
                    na.update(state, out["neeat_hist"])
                else:
                    out = render_sample(scene, cam, cfg_, fw, fh, 7)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if "cull_overflow" in out:
                p["cull_overflow_profiled_frame"] = int(out["cull_overflow"])
            p["split"], p["profile_table"] = _split(prof, wall,
                                                    *profile_parts)
        rec[f"path_{label}"] = p
        print(f"alpha path {label}: {p['ms_per_frame_1spp']:.3f} ms per "
              f"1-spp {fw}x{fh} frame, {p['mrays_per_s']:.3f} Mrays/s, "
              f"{p['rays']} rays, launches {launched}"
              + (f" of {want}" if want else "")
              + (f", passed through {p['passed_through']:.4f} of the shaded "
                 f"lanes" if "passed_through" in p else "")
              + (f", cull_overflow {p['cull_overflow_profiled_frame']}"
                 if "cull_overflow_profiled_frame" in p else "")
              + f", mean L {p['L_mean']:.5f}"
              + (f", split {json.dumps(p['split'])}" if "split" in p else "")
              + f" ({smi})", flush=True)
        bad = not p["finite"] or p["L_mean"] <= 0.0 or p["tier"] != tier
        if want is not None:
            bad = bad or launched != want
        if bad:
            dump()
            _fail(f"alpha: the {label} path did not run its kernels as "
                  f"expected or gave non-finite values")
        return launched

    rounds = cfg.max_bounces + extra
    launches = {}
    chunks = -(-(w * h) // ALPHA_CHUNK)
    fused_parts = (("camera",), (("k1", "bounce_fused_kernel"),))
    launches["fused"] = path(
        "fused", curtain, ch, cfg, "fused",
        dict(bounce_fused_omm_tex=chunks * rounds * ALPHA_SPP),
        profile_parts=fused_parts)
    cfg_at = dataclasses.replace(cfg, nee=NEEMode.NEEAT)
    launches["fused_neeat"] = path(
        "fused_neeat", curtain, ch, cfg_at, "fused",
        dict(bounce_fused_omm_tex=chunks * rounds * ALPHA_SPP,
             shadow_occlusion_omm=chunks * rounds * ALPHA_SPP),
        adaptive=True, profile_parts=(("camera", "nee", "feedback"), (
            ("k1", "bounce_fused_kernel"),
            ("k2", "shadow_occlusion_kernel"))))
    ccfg = dataclasses.replace(cfg, ray_chunk=1 << 30)
    for name in ("grid", "foliage"):
        pages = dispatch.resolve(scenes[name], ccfg, dev).cluster_pages
        launches[name] = path(
            name, scenes[name], hosts[name], ccfg, "clustered",
            dict(cluster_closest_omm=pages * rounds * ALPHA_SPP,
                 cluster_shade_omm_tex=rounds * ALPHA_SPP,
                 cluster_shadow_omm=pages * rounds * ALPHA_SPP),
            profile_parts=(CITY_RANGES, CITY_KERNELS))
    gcfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            ray_chunk=1 << 30)
    gen_parts = ((), (("k8", "brute_closest_kernel"),
                      ("k9", "bvh_traverse_kernel")))
    for name, kernel in (("curtain", "brute_closest"),
                         ("foliage", "bvh_traverse_omm")):
        launched = path(f"{name}_general", scenes[name], hosts[name], gcfg,
                        "xla", None, frame=ALPHA_GENERAL_FRAME,
                        profile_parts=gen_parts)
        # each bounce's query and the retraces of its rejected hits
        if set(launched) != {kernel} or \
                launched[kernel] < (gcfg.max_bounces + 1) * ALPHA_SPP:
            dump()
            _fail(f"alpha: the {name} on the general tier did not run "
                  f"{kernel}")
        launches[f"{name}_general"] = launched
    dump()

    srcs = "rtxpt_tpu_torch/csrc/"

    def used(name):
        return {k: v.get(name, 0) for k, v in launches.items()
                if v.get(name, 0)}

    entries = {}
    for name, src_, rep_, r, err in (
            ("bounce_fused_omm_tex", "bounce_fused.cu",
             "rtxpt_tpu/pt/bounce_pallas.py:1389", rec["k1"], k1_err),
            ("shadow_occlusion_omm", "shadow_occlusion.cu",
             "rtxpt_tpu/pt/bounce_pallas.py:1573", rec["k2"], k2_err),
            ("bvh_traverse_omm", "bvh_traverse.cu",
             "rtxpt_tpu/accel/traverse_pallas.py:54", rec["k9"], k9["err"])):
        by_path = used(name)
        entries[name] = dict(
            name=name, route="cuda", source=srcs + src_, replaces=rep_,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
    for name, entry in checks["grid"]["kernels"].items():
        by_path = used(name)
        err = max(entry["max_abs_err"],
                  checks["foliage"]["kernels"][name]["max_abs_err"])
        entries[name] = dict(entry, max_abs_err=err,
                             launches=sum(by_path.values()),
                             launches_by_path=by_path,
                             foliage=checks["foliage"]["kernels"][name])
    return dict(entries=entries, launches=launches)


FALSE_HIT_SHARE = 0.05       # phase 15: the least share of a priority
#                              comparison's active lanes that are false hits
BISTRO_TRIS = 600_000
BISTRO_SPP = 2               # phase 15: timed samples of the Bistro path
BISTRO_GENERAL_FRAME = (960, 540)


def _prio_state(cols, rows, dev, sample):
    """The priority checks' camera rays on a cols x rows frame: its top
    half from procedural.OVERLAP_INSIDE_CAMERAS[0], its bottom half from
    [1], each starting in its camera's medium."""
    import torch

    from rtxpt_tpu_torch.config import PathTracerConfig
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
    from rtxpt_tpu_torch.scene.camera import look_at
    from rtxpt_tpu_torch.scene.procedural import OVERLAP_INSIDE_CAMERAS

    half = rows // 2
    parts = []
    for k, (pos, target, up, fov, medium) in enumerate(
            OVERLAP_INSIDE_CAMERAS):
        cam = look_at(pos, target, up, fov, cols, half, device=dev)
        px, py = _pixel_grid(cols, half, dev)
        o, d, spread = camera_rays(cam, PathTracerConfig(), px, py, sample)
        fs, is_ = bf.initial_state(o, d, spread, px, py + k * half)
        is_[bf.IS_MED0] = medium
        parts.append((fs, is_))
    return tuple(torch.cat([p[i] for p in parts], 1).contiguous()
                 for i in range(2))


def _false_hit_share(is_in, is_out, hit):
    """Share of the active lanes that hit and passed through: on a scene
    without micromaps, its priority false hits."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    active = int((is_in[bf.IS_ACTIVE] > 0).sum())
    return float((_passed_through(is_in, is_out) & hit).sum()) \
        / max(active, 1)


def _k4_bytes(n, tbl, tex, ext, omm=False, split=False, final=False,
              ha=True):
    """K4's bytes at n lanes: the HA rows its launch reads
    (bounce_clustered.shade_ha_read: the variant's staged rows, AT_LID only
    with the export, the hit rows in the final round; none with `ha`
    False, for K6) and the state (and split) rows read; the state, SH and
    hit rows (and in the external modes the SF_* rows, with the split its
    rows) written; the material, light, environment (and texture) tables
    read once, in the final round the environment's alone."""
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    ha_rows = len(BC.shade_ha_read(tex, omm, final, ext)) if ha else 0
    rows = ha_rows + 2 * (bf.NF + bf.NI + (bf.NF2 if split else 0)) \
        + BC.SH_ROWS + bf.NH + (bf.SF_ROWS if ext else 0)
    tables = _numel(tbl.env) if final else (
        tbl.mat_rows.numel() + tbl.light_rows.numel() + _numel(tbl.env)
        + (_numel(tbl.tex) + _numel(tbl.tex_meta) if tex else 0))
    return 4 * n * rows + 4 * tables


def _priorities(record, dev, smi, dump):
    """Phase 15: nested dielectric priorities and Bistro. (a) K1's priority
    variant on the overlap boxes and K4's on their subdivided form (the
    two cameras' rays), and K4's omm_tex_prio variant on Bistro's sorted
    1080p wavefront (the window with the most glass hits, slot 5), each
    against its plain version at bounces 0 and 2 with phase 3's criteria,
    the interior list equal on every lane and (on the overlap boxes) at
    least FALSE_HIT_SHARE of the active lanes false hits; each timed with
    its bound; the registers and spills of every K1 and K4
    instantiation. (b) The closed-form overlap radiance through the
    kernels on the fused, clustered and general tiers. (c) Bistro
    (bistro_scene(600_000, seed=0)) at 1920x1080 in rung 5's path-tracer
    configuration, 4 bounces + the 2 pass-through rounds, 1 warm-up and
    BISTRO_SPP timed samples: its tables and memory, the launches, the
    pass-through share, one profiled frame, cull_overflow, the sample at
    the smallest page count without overflow and the default image's RMSE
    against it, and the same sample on the general tier at 960x540
    against the clustered tier's. Returns dict(entries {name: kernel-line
    entry}, launches {path: counts})."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render, render_sample)
    from rtxpt_tpu_torch.scene import procedural as TP
    from rtxpt_tpu_torch.scene.camera import look_at

    rec = {}
    record["priorities"] = rec
    sample = 1
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    max_travel = float(cfg.max_ray_travel)
    boxes = prepare(TP.overlap_boxes([1, 2, 0]), device=dev)
    wall = prepare(TP.overlap_boxes([1, 2, 0, 0], wall=True), device=dev)
    tbl, ctbl = boxes.bounce_tables, wall.cluster_tables
    if not (tbl.prio and boxes.has_nested_priorities
            and wall.has_nested_priorities and ctbl is not None):
        _fail("priorities: the overlap boxes do not take the priority "
              "variants")

    def check(label, kern, plain, is_in, hit, floor=True):
        summary, err = _compare_state(kern, plain)
        med = bool(torch.equal(kern[1][bf.IS_MED0:bf.IS_MED1 + 1],
                               plain[1][bf.IS_MED0:bf.IS_MED1 + 1]))
        share = _false_hit_share(is_in, plain[1], hit)
        summary.update(interior_list_equal=med, false_hit_share=share)
        print(f"priorities {label}: int lanes equal "
              f"{summary['int_lanes_equal']:.6f}, worst float row "
              f"{summary['worst_float_row']:.6f}, interior list equal {med}, "
              f"false hits {share:.4f} of the active lanes, L mean "
              f"{summary['L_mean_kernel']:.6f} vs "
              f"{summary['L_mean_plain']:.6f}, max abs err {err:.3g}",
              flush=True)
        if not _state_ok(summary) or not med or (
                floor and share < FALSE_HIT_SHARE):
            rec[label] = summary
            dump()
            _fail(f"priorities: {label} disagrees with its plain version or "
                  f"exercises too few false hits")
        return summary, err

    # ---- (a) K1's priority variant on the overlap boxes ----
    fs, is_ = _prio_state(CMP_SIDE, CMP_SIDE, dev, sample)
    k1_err = 0.0
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample)
        if b in (0, 2):
            kern = _k1_audited("priorities", lambda: bf.bounce(
                fs, is_, tbl, kcfg, sample), plain)
            rec[f"k1_bounce{b}"], err = check(f"k1 bounce {b}", kern, plain,
                                              is_, plain[2][1] >= 0)
            k1_err = max(k1_err, err)
        fs, is_ = plain[0], plain[1]
    _k1_report(record, "priorities", dump)
    fs_t, is_t = _prio_state(512, 512, dev, sample)       # 2^18 rays
    n = fs_t.shape[1]
    k1_ms = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample), 20)
    k1_plain = _cuda_ms(lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg,
                                                    sample), 3)
    # as phase 3: the state read and written once, the tables once, every
    # active lane against every triangle, the shadow rays up to their
    # first occluder
    active = int((is_t[bf.IS_ACTIVE] > 0).sum())
    k1_pairs = active * tbl.n_tris + _k1_shadow_pairs(
        lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample))
    k1_bound, k1_by, _ = _bound(
        4 * n * (2 * (bf.NF + bf.NI) + bf.NH) + 4 * sum(
            t.numel() for t in (tbl.tri_coef, tbl.attr_rows, tbl.mat_rows,
                                tbl.light_rows)),
        **_k1_ops(tbl.n_tris, k1_pairs))
    rec["k1"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                     bound_by=k1_by, rays=n)
    print(f"priorities k1: kernel {k1_ms:.4f} ms per {n}-ray launch, plain "
          f"{k1_plain:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}) ({smi})",
          flush=True)

    # ---- (a) K4's priority variant on the boxes with their wall ----
    wcfg = dispatch.resolve(wall, cfg, dev)
    kslots, pages = wcfg.cluster_kslots, wcfg.cluster_pages
    fs, is_ = _prio_state(CMP_SIDE, CMP_SIDE, dev, sample)
    k4p_err = 0.0
    for b in range(3):
        ha, _ = BC.closest_paged(fs, is_, ctbl, kslots, pages, max_travel)
        plain = BC.shade_reference(ha, fs, is_, ctbl, kcfg, sample,
                                   prio=True)
        if b in (0, 2):
            kern = BC.shade(ha, fs, is_, ctbl, kcfg, sample, prio=True)
            torch.cuda.synchronize()
            summ, err = check(f"k4 bounce {b}", (kern[0], kern[1], kern[3]),
                              (plain[0], plain[1], plain[3]), is_,
                              ha[BC.HA_PRIM] >= 0)
            shs, err_sh = _compare(dict(sh=kern[2]), dict(sh=plain[2]),
                                   (kern[1] == plain[1]).all(0))
            summ["worst_sh_row"] = shs["worst_float_row"]
            rec[f"k4_bounce{b}"] = summ
            k4p_err = max(k4p_err, err, err_sh)
            if shs["worst_float_row"] < LANE_FRACTION:
                dump()
                _fail(f"priorities: K4's SH rows disagree at bounce {b}")
        fs, is_ = plain[0], plain[1]
    fs_t, is_t = _prio_state(*CITY_FRAME, dev, sample)   # 2,073,600 lanes
    ha_t, _ = BC.closest_paged(fs_t, is_t, ctbl, kslots, pages, max_travel)
    n = fs_t.shape[1]
    m = CMP_SIDE * CMP_SIDE
    k4p_ms = _cuda_ms(lambda: BC.shade(ha_t, fs_t, is_t, ctbl, kcfg, sample,
                                       prio=True), 10)
    hs, fss, iss = (x[:, :m].contiguous() for x in (ha_t, fs_t, is_t))
    k4p_plain = _cuda_ms(lambda: BC.shade_reference(hs, fss, iss, ctbl, kcfg,
                                                    sample, prio=True), 3)
    k4p_bound, k4p_by, _ = _bound(_k4_bytes(n, ctbl, False, False))
    rec["k4"] = dict(ms=k4p_ms, plain_ms=k4p_plain, plain_lanes=m,
                     bound_ms=k4p_bound, bound_by=k4p_by, lanes=n)
    print(f"priorities k4: kernel {k4p_ms:.4f} ms at {n} lanes, plain "
          f"{k4p_plain:.4f} ms at {m}, bound {k4p_bound:.4f} ms ({k4p_by}) "
          f"({smi})", flush=True)
    rec["ptxas"] = {
        f"{lib}_{'tex' if t else 'notex'}_{'omm' if o else 'noomm'}_"
        f"{'prio' if p else 'noprio'}": _ptxas_entry(
            getattr(kernels, attr).ptxas_log,
            f"{lib}_kernelILb{int(t)}ELb{int(o)}ELb{int(p)}ELb0E")
        for lib, attr in (("bounce_fused", "BOUNCE_FUSED"),
                          ("cluster_shade", "CLUSTER_SHADE"))
        for t in (False, True) for o in (False, True) for p in (False, True)}
    print(f"priorities ptxas: {json.dumps(rec['ptxas'])}", flush=True)
    dump()

    # ---- (b) the closed form through the kernels on every tier ----
    cam4 = look_at([-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], 10.0,
                   4, 4, device=dev)
    ccfg = PathTracerConfig(max_bounces=6, nee=NEEMode.OFF,
                            enable_russian_roulette=False,
                            passthrough_extra_iters=3)
    want = TP.OVERLAP_E * math.exp(-TP.OVERLAP_SW * 0.4
                                   - TP.OVERLAP_SG * 0.8)
    launches = {}
    for route, scene_, tier, kname in (
            ("fused", boxes, "auto", "bounce_fused_prio"),
            ("clustered", wall, "auto", "cluster_shade_prio"),
            ("general", boxes, "xla", "brute_closest")):
        kernels.launches.clear()
        hdr, _, _ = render(scene_, cam4, dataclasses.replace(
            ccfg, kernel_tier=tier), 4, 4, spp=1)
        torch.cuda.synchronize()
        launches[f"closed_form_{route}"] = dict(kernels.launches)
        got = float(hdr[2, 2, 0])
        rec[f"closed_form_{route}"] = dict(radiance=got, want=want,
                                           launches=dict(kernels.launches))
        print(f"priorities closed form, {route} tier: centre {got:.6f}, "
              f"want {want:.6f} (rel {abs(got / want - 1):.2e}), launches "
              f"{dict(kernels.launches)}", flush=True)
        if abs(got / want - 1.0) >= 5e-3 or not kernels.launches[kname]:
            dump()
            _fail(f"priorities: the closed form misses on the {route} tier")

    # ---- (a) and (c): Bistro ----
    t0 = time.perf_counter()
    host = TP.bistro_scene(BISTRO_TRIS, seed=0)
    t1 = time.perf_counter()
    scene = prepare(host, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t1
    bt = scene.cluster_tables
    bcfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            stochastic_texture_filtering=True,
                            firefly_clamp=32.0, ray_chunk=1 << 30)
    rcfg = dispatch.resolve(scene, bcfg, dev)
    bk = bf.KernelConfig.from_cfg(rcfg)
    table_bytes = sum(t.numel() * t.element_size() for t in (
        bt.blocks, bt.aabb_lo, bt.aabb_hi, bt.mat_rows, bt.light_rows,
        bt.offsets, bt.omm_word, bt.omm_cov, bt.tex, bt.tex_meta)
        if t is not None)
    w, h = CITY_FRAME
    info = dict(triangles=bt.n_tris, host_triangles=sum(
        len(i.indices) for i in host.instances), clusters=bt.n_clusters,
        lights=scene.lights.count, tables_mib=table_bytes / 2 ** 20,
        block_kib=bt.blocks[0].numel() * 4 / 1024, lanes=w * h,
        host_s=t1 - t0, prepare_s=prep_s, tier=rcfg.kernel_tier,
        nee_external=rcfg.nee_external, nee_mode=bk.nee_mode,
        kslots=rcfg.cluster_kslots, pages=rcfg.cluster_pages,
        mixed=int((scene.tri_opacity == 1).sum()))
    rec["bistro"] = info
    print(f"priorities bistro: {json.dumps(info)}", flush=True)
    if not (rcfg.kernel_tier == "clustered" and rcfg.nee_external
            and bt.omm and bf.use_tex(bt, bk) and scene.has_nested_priorities):
        dump()
        _fail("priorities: Bistro does not take the clustered external "
              "route with micromaps, textures and priorities")
    kslots, pages = rcfg.cluster_kslots, rcfg.cluster_pages
    bounds = BC.scene_bounds(bt)
    cam = TP.default_camera(host, w, h, device=dev)

    # K4 omm_tex_prio timed at the 1080p bounce-0 launch, beside omm_tex
    px, py = _pixel_grid(w, h, dev)
    o, d, spread = camera_rays(cam, rcfg, px, py, sample)
    fs0, is0 = bf.initial_state(o, d, spread, px, py)
    src = torch.arange(fs0.shape[1], dtype=torch.int32, device=dev)
    fs0, is0, _ = BC.sort_wavefront(fs0, is0, src, True, bounds)
    ha0, _ = BC.closest_paged(fs0, is0, bt, kslots, pages, max_travel,
                              omm=True)
    n = fs0.shape[1]
    k4b_ms = _cuda_ms(lambda: BC.shade(ha0, fs0, is0, bt, bk, sample,
                                       omm=True, prio=True), 10)
    k4b_noprio = _cuda_ms(lambda: BC.shade(ha0, fs0, is0, bt, bk, sample,
                                           omm=True), 10)
    hs, fss, iss = (x[:, :m].contiguous() for x in (ha0, fs0, is0))
    k4b_plain = _cuda_ms(lambda: BC.shade_reference(
        hs, fss, iss, bt, bk, sample, omm=True, prio=True), 3)
    k4b_bound, k4b_by, _ = _bound(_k4_bytes(n, bt, True, True, omm=True))
    rec["k4_bistro"] = dict(ms=k4b_ms, ms_without_prio=k4b_noprio,
                            plain_ms=k4b_plain, plain_lanes=m,
                            bound_ms=k4b_bound, bound_by=k4b_by, lanes=n)
    print(f"priorities bistro k4 omm_tex_prio (slot {bk.nee_mode}): kernel "
          f"{k4b_ms:.4f} ms at the {n}-lane bounce-0 launch (omm_tex "
          f"without priorities {k4b_noprio:.4f} ms), plain {k4b_plain:.4f} "
          f"ms at {m}, bound {k4b_bound:.4f} ms ({k4b_by}) ({smi})",
          flush=True)

    # the warm-up sample compares K4 with its plain version at rounds 0
    # and 2 on the 64 groups of the sorted wavefront with the most glass
    # hits
    k4_kernel = BC.shade
    compared = {}
    groups_cmp = m // BC.FL

    def shade_both(ha, fs, is_, tables, kcfg_, sample_idx, final_env=False,
                   omm=False, prio=False, fs2=None):
        out = k4_kernel(ha, fs, is_, tables, kcfg_, sample_idx, final_env,
                        omm, prio, fs2)
        r = len(compared)
        compared[r] = None
        if r not in (0, 2) or final_env:
            return out
        glass = (ha[BC.HA_PRIM] >= 0) & (is_[bf.IS_ACTIVE] > 0) \
            & (ha[BC.HA_ATTR + bf.AT_MID] == TP.BISTRO_GLASS)
        run = torch.cumsum(glass.view(-1, BC.FL).sum(1), 0)
        run = torch.cat([run.new_zeros(1), run])
        g0 = int(torch.argmax(run[groups_cmp:] - run[:-groups_cmp]))
        lanes = slice(g0 * BC.FL, (g0 + groups_cmp) * BC.FL)
        sub = [x[:, lanes].contiguous() for x in (ha, fs, is_)]
        kern = k4_kernel(*sub, tables, kcfg_, sample_idx, omm=omm,
                         prio=prio)
        plain = BC.shade_reference(*sub, tables, kcfg_, sample_idx, omm=omm,
                                   prio=prio)
        compared[r] = (kern, plain, sub, int(glass[lanes].sum()), g0)
        return out

    BC.shade = shade_both
    try:
        render_sample(scene, cam, rcfg, w, h, 0)                 # warm-up
    finally:
        BC.shade = k4_kernel
    torch.cuda.synchronize()
    k4b_err = 0.0
    for r in (0, 2):
        kern, plain, (ha_c, fs_c, is_c), n_glass, g0 = compared[r]
        summ, err = check(f"bistro k4 round {r} (groups {g0}-"
                          f"{g0 + groups_cmp - 1}, {n_glass} glass hits)",
                          (kern[0], kern[1], kern[3]),
                          (plain[0], plain[1], plain[3]), is_c,
                          ha_c[BC.HA_PRIM] >= 0, floor=False)
        int_eq = (kern[1] == plain[1]).all(0)
        shs, err_sh = _compare(dict(sh=kern[2], surf=kern[4]),
                               dict(sh=plain[2], surf=plain[4]), int_eq)
        summ.update(worst_sh_surf_row=shs["worst_float_row"],
                    glass_hits=n_glass, first_group=g0)
        rec[f"bistro_k4_round{r}"] = summ
        k4b_err = max(k4b_err, err, err_sh)
        if shs["worst_float_row"] < LANE_FRACTION or (r == 0
                                                        and n_glass == 0):
            dump()
            _fail(f"priorities: Bistro's K4 SH / SF_* rows disagree at round "
                  f"{r}, or no camera ray hits the glass")

    # the path: 1 warm-up (above), BISTRO_SPP timed samples
    extra = rcfg.passthrough_extra_iters
    rounds = rcfg.max_bounces + extra
    kernels.launches.clear()
    t0 = time.perf_counter()
    hdr, _, rays = render(scene, cam, rcfg, w, h, BISTRO_SPP, first_sample=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = dict(kernels.launches)
    launches["bistro"] = launched
    want_l = dict(cluster_closest_omm=pages * rounds * BISTRO_SPP,
                  cluster_shade_omm_tex_prio=rounds * BISTRO_SPP,
                  cluster_shadow_omm=pages * rounds * BISTRO_SPP)
    path = dict(res=f"{w}x{h}", spp_timed=BISTRO_SPP,
                bounces=rcfg.max_bounces, rounds=rounds, launches=launched,
                expected=want_l, rays=int(rays), seconds=dt,
                mrays_per_s=int(rays) / dt / 1e6,
                ms_per_frame_1spp=dt / BISTRO_SPP * 1e3,
                L_mean=float(hdr.mean()),
                finite=bool(torch.isfinite(hdr).all()), card=smi)
    BC.occlusion_screen_stats(dev, True)
    path["passed_through"] = _passthrough_share(
        lambda: render_sample(scene, cam, rcfg, w, h, 9))
    path["k5_screen"] = BC.occlusion_screen_stats(dev, False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = render_sample(scene, cam, rcfg, w, h, 7)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path["cull_overflow_profiled_frame"] = int(out["cull_overflow"])
    path["profiled_mrays_per_s"] = int(out["ray_count"]) / wall_ms / 1e3
    path["split"], path["profile_table"] = _split(
        prof, wall_ms, ("sort", "cull", "nee"), CITY_KERNELS)
    path["max_memory_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    rec["path"] = path
    print(f"priorities bistro path: {path['ms_per_frame_1spp']:.3f} ms per "
          f"1-spp {w}x{h} frame, {path['mrays_per_s']:.3f} Mrays/s, "
          f"{path['rays']} rays, launches {launched} of {want_l}, passed "
          f"through {path['passed_through']:.4f} of the shaded lanes, "
          f"cull_overflow {path['cull_overflow_profiled_frame']}, mean L "
          f"{path['L_mean']:.5f}, profiled frame "
          f"{path['profiled_mrays_per_s']:.3f} Mrays/s, split "
          f"{json.dumps(path['split'])}, K5 screen pass share "
          f"{_share(path['k5_screen'])} over the pass-through frame "
          f"({path['k5_screen']['passed']} of {path['k5_screen']['pairs']} "
          f"pairs), peak memory "
          f"{path['max_memory_mib']:.1f} MiB ({smi})", flush=True)
    if launched != want_l or not path["finite"] or path["L_mean"] <= 1e-3:
        dump()
        _fail("priorities: the Bistro path did not run its kernels as "
              "expected or gave a non-finite or unlit image")
    dump()

    # F7: the same sample without cull overflow. A page's cull depends
    # only on the pages before it, so one sample at ceil(clusters /
    # kslots) pages gives every query's first page without overflow; the
    # smallest page count without overflow is the largest of those
    page_log = []
    cull_kernel = BC.cull

    def cull_logged(o3, d3, active, tmax, tbl_, kslots_, lo=None):
        cand, ovf = cull_kernel(o3, d3, active, tmax, tbl_, kslots_, lo=lo)
        page_log.append((lo is None, int(ovf)))
        return cand, ovf

    pmax = -(-bt.n_clusters // kslots)
    BC.cull = cull_logged
    try:
        out_max = render_sample(scene, cam, dataclasses.replace(
            rcfg, cluster_pages=pmax), w, h, 1)
    finally:
        BC.cull = cull_kernel
    need, page = 1, 0
    first_free = None
    for start, ovf in page_log + [(True, 0)]:
        if start:
            if first_free is not None:
                need = max(need, first_free)
            page, first_free = 0, None
        else:
            page += 1
        if ovf == 0 and first_free is None:
            first_free = page + 1
    pmin = need
    t0 = time.perf_counter()
    out_min = render_sample(scene, cam, dataclasses.replace(
        rcfg, cluster_pages=pmin), w, h, 1)
    torch.cuda.synchronize()
    t_min = time.perf_counter() - t0
    out_def = render_sample(scene, cam, rcfg, w, h, 1)
    ref = out_min["L"] if int(out_min["cull_overflow"]) == 0 else out_max["L"]
    f7 = dict(pages_max=pmax, pages_min=pmin,
              overflow_default=int(out_def["cull_overflow"]),
              overflow_min=int(out_min["cull_overflow"]),
              overflow_max=int(out_max["cull_overflow"]),
              ms_min=t_min * 1e3,
              min_equals_max=bool(torch.equal(out_min["L"], out_max["L"])),
              rmse_default=float(torch.sqrt(((out_def["L"] - ref) ** 2)
                                            .mean())),
              mean_default=float(out_def["L"].mean()),
              mean_without_overflow=float(ref.mean()))
    rec["f7"] = f7
    print(f"priorities bistro F7: {json.dumps(f7)}", flush=True)

    # the same sample on the general tier (K9) at 960x540, against the
    # clustered tier's without overflow
    gw, gh = BISTRO_GENERAL_FRAME
    camg = TP.default_camera(host, gw, gh, device=dev)
    out_c = render_sample(scene, camg, dataclasses.replace(
        rcfg, cluster_pages=pmax), gw, gh, 1)
    kernels.launches.clear()
    t0 = time.perf_counter()
    out_g = render_sample(scene, camg, dataclasses.replace(
        bcfg, kernel_tier="xla"), gw, gh, 1)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    launches["bistro_general"] = dict(kernels.launches)
    # K9's micromap walk on Bistro held to its plain version: the first
    # two launches of the same sample again (bounce 0's closest hits and
    # its alpha retrace or shadow rays)
    _, rec["k9_audit"], k9_ok = _k9_audit(
        "priorities bistro", lambda: render_sample(
            scene, camg, dataclasses.replace(bcfg, kernel_tier="xla"), gw,
            gh, 1))
    if not k9_ok or not all(a["omm"] for a in rec["k9_audit"]):
        dump()
        _fail("priorities: K9's micromap walk disagrees with its plain "
              "version on Bistro")
    gen = dict(res=f"{gw}x{gh}", ms=t_g * 1e3,
               launches=dict(kernels.launches),
               overflow_clustered=int(out_c["cull_overflow"]),
               rmse=float(torch.sqrt(((out_g["L"] - out_c["L"]) ** 2).mean())),
               mean_general=float(out_g["L"].mean()),
               mean_clustered=float(out_c["L"].mean()),
               finite=bool(torch.isfinite(out_g["L"]).all()))
    rec["general"] = gen
    print(f"priorities bistro general tier: {json.dumps(gen)} ({smi})",
          flush=True)
    if not gen["finite"] or not kernels.launches["bvh_traverse_omm"]:
        dump()
        _fail("priorities: Bistro on the general tier did not run K9 or "
              "gave non-finite values")
    dump()

    srcs = "rtxpt_tpu_torch/csrc/"
    entries = {}
    for name, src_, rep_, r, err, path_ in (
            ("bounce_fused_prio", "bounce_fused.cu",
             "rtxpt_tpu/pt/bounce_pallas.py:1389", rec["k1"], k1_err,
             "closed_form_fused"),
            ("cluster_shade_prio", "cluster_shade.cu",
             "rtxpt_tpu/pt/bounce_clustered.py:462", rec["k4"], k4p_err,
             "closed_form_clustered"),
            ("cluster_shade_omm_tex_prio", "cluster_shade.cu",
             "rtxpt_tpu/pt/bounce_clustered.py:462", rec["k4_bistro"],
             k4b_err, "bistro")):
        count = launches[path_].get(name, 0)
        entries[name] = dict(
            name=name, route="cuda", source=srcs + src_, replaces=rep_,
            launches=count, launches_by_path={path_: count},
            max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
    return dict(entries=entries, launches=launches)


ROWS_SPP = 2                  # phase 16: timed samples of each per-row path
ROWS_CITIES = (               # phase 16: label, city_scene switches, STF
    ("city", {}, False),
    ("sky_city", dict(with_env=True), False),
    ("tex_city", dict(with_env=True, textured=True, normal_mapped=True),
     True))
ROWS_RANGES = ("sort", "cull")
ROWS_KERNELS = (("k6", "closest_shade_kernel"), ("k7", "shadow_rows_kernel"))
# K6's and K7's times at the 1080p bounce-0 launches before their redesign
# for the tensor cores (CUDA cores, one 128-thread block per row: PERF.md's
# K6 and K7 rows, on "NVIDIA H100 80GB HBM3, 700.00 W"), printed beside
# this run's
ROWS_BEFORE_MS = {"cluster_rows_closest_shade": "4.581-4.711",
                "cluster_rows_closest_shade_env": "4.663-4.766",
                "cluster_rows_closest_shade_tex_env": "4.862-4.902",
                "cluster_rows_closest_shade_final": "4.226-4.345",
                "cluster_rows_shadow": "6.965-7.092"}
# their dynamic shared memory per block, as csrc/cluster_rows.cu lays it
# out (K6: A 512 x 96 B, B tile 13,520 B, ring 2 x 41,904 B, lists 512 x
# 16 B; K7: K5's with a ring without coverages)
ROWS_DYN_SMEM = {"k6": 154_672, "k7": 212_016}
K3_WINNER_FLOATS = 42         # a winner's attribute, center, edge rows
K6_FINAL_WINNER_FLOATS = 14   # K6's final round: center, edges, valid, gidx
SAVED_GROUPS = 8              # --diverged-group: ray groups saved


def _per_row(record, dev, smi, dump, city_prepared, group_path=None):
    """Phase 16: the per-row clustered route (bounce_clustered.FLAT False:
    K6 closest hit and shading in one kernel, K7 per-row shadow any-hit).
    (a) Every K6 variant and K7 against their plain versions on the card,
    phase 6's criteria plus visit and test counts equal: at bounce 0 on
    65,536 camera rays spread over the 1080p frame and at bounce 2 on the
    64 groups of the sorted 1080p wavefront (carried there by K6 and K7)
    with the most hits; the city runs K6's plain variant and K7, the sky
    city `_env` and `_final`, the textured sky city with stochastic
    filtering `_tex_env`. (b) Each timed at its city's 1080p bounce-0
    launch beside its bound, with ptxas's registers and spills; on the
    city K6 against K3 (one page, the same candidate lists) plus K4 on
    that launch, and K7 against K5. (c) The three cities at 1920x1080
    through render_sample on the per-row route: 4 bounces, power NEE,
    kslots 64, one chunk, 1 warm-up and ROWS_SPP timed samples; launch
    counts (K6 bounces x spp, its `_final` spp with an environment, K7
    bounces x spp), cull_overflow, a finite lit image, its sample-1 RMSE
    against the flat route at cluster_pages=1 and at the default 2
    pages, and one profiled city frame (K6's and K7's shares of its
    device time and their time per launch over it). The lanes that differ
    bit-wise from the plain versions, the screens' pass shares, shared
    memory and the CUDA-core kernels' times are printed beside (a) and
    (b). With
    `group_path`, the city's
    1080p bounce-0 groups with the most lanes whose K6 winner differs
    from K3's are saved there (`_save_group`). Returns dict(entries={name:
    kernel-line entry})."""
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render_sample)
    from rtxpt_tpu_torch.scene.procedural import (
        city_overview, city_scene, default_camera)
    from rtxpt_tpu_torch.utils.image import rmse

    t_phase = time.perf_counter()
    rec = dict(card=smi)
    record["per_row"] = rec
    w, h = CITY_FRAME
    sample = 1
    k7n = "cluster_rows_shadow"
    err, ms, plain_ms, bounds, launch = {}, {}, {}, {}, {}

    def k6_name(tbl, kcfg, final=False):
        return bf.variant_name("cluster_rows_closest_shade",
                               tbl.env is not None, final,
                               bf.use_tex(tbl, kcfg))

    def camera_state(host, cfg, cols, rows):
        cam = default_camera(host, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        fs, is_ = bf.initial_state(o, d, spread, px, py)
        return fs, is_, torch.arange(fs.shape[1], dtype=torch.int32,
                                     device=dev)

    def cull_closest(tbl, fs, is_, cfg):
        return BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                       is_[bf.IS_ACTIVE] > 0, float(cfg.max_ray_travel), tbl,
                       cfg.cluster_kslots)[0]

    def cull_shadow(tbl, sh, bounds_, cfg):
        shp, perm = BC.sort_shadows(sh, bounds_)
        dop = shp[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3],
                            shp[BC.SH_D:BC.SH_D + 3], dop, shp[BC.SH_DIST],
                            tbl, cfg.cluster_kslots)
        return shp, perm, cand_s

    def compare(label, b, scene, cfg, fs, is_, bounds_, rows):
        """K6's variants on this scene (and its final round with an
        environment) and K7 against their plain versions on rows fs,
        is_; fails on a disagreement or too few hits."""
        tbl = scene.cluster_tables
        kcfg = bf.KernelConfig.from_cfg(cfg)
        kslots, mt = cfg.cluster_kslots, float(cfg.max_ray_travel)
        cand = cull_closest(tbl, fs, is_, cfg)
        out = {}
        plain_sh = None
        for final in (False, True) if tbl.env is not None else (False,):
            name = k6_name(tbl, kcfg, final)
            kern = BC.closest_shade(cand, fs, is_, tbl, kcfg, sample, kslots,
                                    mt, final_env=final, stats=True)
            plain = BC.closest_shade_reference(cand, fs, is_, tbl, kcfg,
                                               sample, kslots, mt,
                                               final_env=final, stats=True)
            torch.cuda.synchronize()
            s, e = _compare_state((kern[0], kern[1], kern[3]),
                                  (plain[0], plain[1], plain[3]))
            shs, e2 = _compare(dict(sh=kern[2]), dict(sh=plain[2]),
                               (kern[1] == plain[1]).all(0))
            s.update(worst_sh_row=shs["worst_float_row"],
                     lanes_differ=_lanes_differ(kern[:4], plain[:4]),
                     visits_equal=bool(torch.equal(kern[4], plain[4])),
                     row_visits=int(plain[4].sum()),
                     hit_share=float((plain[3][1] >= 0).float().mean()))
            err[name] = max(err.get(name, 0.0), e, e2)
            out[name] = s
            if not final:
                plain_sh = plain[2]
        shp, _, cand_s = cull_shadow(tbl, plain_sh, bounds_, cfg)
        occ_k, tst_k = BC.occlusion_rows(cand_s, shp, tbl.blocks, kslots,
                                         stats=True)
        occ_p, tst_p = BC.occlusion_rows_reference(cand_s, shp, tbl.blocks,
                                                   kslots, stats=True)
        torch.cuda.synchronize()
        out[k7n] = dict(occ_lanes_equal=float((occ_k == occ_p).float()
                                              .mean()),
                        lanes_differ=int((occ_k != occ_p).sum()),
                        tests_equal=bool(torch.equal(tst_k, tst_p)),
                        requests=int((shp[BC.SH_DO] > 0.5).sum()),
                        tests=int(tst_p.sum()))
        err[k7n] = max(err.get(k7n, 0.0),
                       float((occ_k - occ_p).abs().max()))
        rec.setdefault(label, {})[f"bounce{b}"] = dict(rows=rows, **out)
        k6s = [v for k, v in out.items() if k != k7n]
        print(f"per_row {label} bounce {b} ({rows}): " + "; ".join(
            f"{k} int lanes {v['int_lanes_equal']:.6f}, worst float row "
            f"{min(v['worst_float_row'], v['worst_sh_row']):.6f}, L mean "
            f"rel {v['L_mean_rel']:.3g}, {v['lanes_differ']} lanes differ "
            f"bit-wise, visits equal {v['visits_equal']} "
            f"({v['row_visits']} row visits), hit share "
            f"{v['hit_share']:.4f}" for k, v in out.items() if k != k7n)
            + f"; K7 occlusion equal {out[k7n]['occ_lanes_equal']:.6f} over "
            f"{out[k7n]['requests']} requests ({out[k7n]['lanes_differ']} "
            f"lanes differ), tests equal {out[k7n]['tests_equal']}",
            flush=True)
        ok = all(_state_ok(v) and v["worst_sh_row"] >= LANE_FRACTION
                 and v["visits_equal"] for v in k6s) \
            and out[k7n]["occ_lanes_equal"] >= LANE_FRACTION \
            and out[k7n]["tests_equal"]
        if not ok or k6s[0]["hit_share"] < MIN_HIT_SHARE:
            dump()
            _fail(f"per_row {label}: a kernel disagrees with its plain "
                  f"version at bounce {b}" if not ok else
                  f"per_row {label}: bounce {b}'s rows hit too little")

    def k6_bound(tbl, kcfg, cand, is_, cfg, visited, hit6, visits3,
                 final):
        """K6's bound at a launch: the state rows read and written, the
        SH and hit rows written, the candidate rows, the staged rows of
        each distinct block in the (row, slot) pairs K6's rows visit
        (`visited`), and each hit's winner rows: outside the final round
        the attribute, center and edge rows (K3_WINNER_FLOATS) and the
        material, light, environment (and texture) tables; in the final
        round, which shades nothing, the center, edge, valid and triangle
        rows (K6_FINAL_WINNER_FLOATS) and the environment table. The
        operations of the pairs K6's rows test (each visited pair's active
        lanes times CT), which are at most K3's on the same lists
        (`visits3`, its group visits)."""
        g = cand.shape[0]
        n = g * BC.FL
        kslots = cfg.cluster_kslots
        active_r = (is_[bf.IS_ACTIVE] > 0).view(-1, 128).sum(1)
        slots = cand[:, 0, 1:1 + kslots].repeat_interleave(BC.R, 0)
        blocks_ = int(torch.unique(slots[visited]).numel())
        hits = int((hit6[1] >= 0).sum())
        nbytes = _k4_bytes(n, tbl, bf.use_tex(tbl, kcfg), False,
                           final=final, ha=False) \
            + 4 * (K6_FINAL_WINNER_FLOATS if final else K3_WINNER_FLOATS) \
            * hits
        nbytes += 4 * cand.numel() + STAGED_BLOCK_BYTES * blocks_
        pairs3 = int((active_r.view(g, BC.R).sum(1) * visits3).sum()) * 128
        pairs = int((active_r * visited.sum(1)).sum()) * 128

        def ops(p):
            return dict(f32=p * K3_PAIR_F32, tf32=p * PAIR_TF32,
                        bf16=p * PAIR_BF16)
        return _bound(nbytes, **ops(pairs)), dict(
            groups=g, blocks=blocks_, hits=hits, pairs=pairs,
            row_visits=int(visited.sum()), k3_pairs=pairs3,
            k3_group_visits=int(visits3.sum()),
            bound_with_k3_pairs_ms=_bound(nbytes, **ops(pairs3))[0])

    BC.FLAT = False
    try:
        scenes = {}
        for label, switches, stf in ROWS_CITIES:
            if label == "city":
                host, scene = city_prepared[0], city_prepared[1]
            else:
                host = city_overview(city_scene(CITY_TRIS, seed=CITY_SEED,
                                                **switches))
                scene = prepare(host, device=dev)
            cfg = dispatch.resolve(scene, PathTracerConfig(
                max_bounces=4, nee=NEEMode.POWER, ray_chunk=1 << 30,
                stochastic_texture_filtering=stf), dev)
            scenes[label] = (host, scene, cfg)
            tbl = scene.cluster_tables
            kcfg = bf.KernelConfig.from_cfg(cfg)
            bounds_ = BC.scene_bounds(tbl)
            kslots, mt = cfg.cluster_kslots, float(cfg.max_ray_travel)
            if cfg.kernel_tier != "clustered" or kslots != 64:
                _fail(f"per_row {label}: resolves to {cfg.kernel_tier}, "
                      f"kslots {kslots}")

            # (a) bounce 0 on 65,536 spread rays, bounce 2 on a window
            fs, is_, src = camera_state(host, cfg, CMP_SIDE, CMP_SIDE)
            fs, is_, src = BC.sort_wavefront(fs, is_, src, True, bounds_)
            cmp_in = (fs, is_)
            compare(label, 0, scene, cfg, fs, is_, bounds_,
                    f"{CMP_SIDE}x{CMP_SIDE} camera rays spread over the "
                    "frame")
            cmp_groups = fs.shape[1] // BC.FL
            fs, is_, src = camera_state(host, cfg, w, h)
            for b in range(3):
                fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0,
                                                 bounds_)
                cand = cull_closest(tbl, fs, is_, cfg)
                nfs, nis, sh, hit = BC.closest_shade(cand, fs, is_, tbl, kcfg,
                                                     sample, kslots, mt)
                if b == 2:
                    run = torch.cumsum((hit[1] >= 0).view(-1, BC.FL).sum(1),
                                       0)
                    run = torch.cat([run.new_zeros(1), run])
                    g0 = int(torch.argmax(run[cmp_groups:]
                                          - run[:-cmp_groups]))
                    lanes = slice(g0 * BC.FL, (g0 + cmp_groups) * BC.FL)
                    compare(label, 2, scene, cfg,
                            fs[:, lanes].contiguous(),
                            is_[:, lanes].contiguous(), bounds_,
                            f"groups {g0}-{g0 + cmp_groups - 1} of the "
                            f"sorted {w}x{h} wavefront")
                    break
                shp, perm, cand_s = cull_shadow(tbl, sh, bounds_, cfg)
                occ = BC.occlusion_rows(cand_s, shp, tbl.blocks, kslots)
                ok_nee = (sh[BC.SH_DO] > 0.5) \
                    & (BC.unsort_rows(perm, occ[None])[0] < 0.5)
                fs, is_ = nfs, nis
                fs[bf.FS_L:bf.FS_L + 3] += torch.where(
                    ok_nee, sh[BC.SH_CONTRIB:BC.SH_CONTRIB + 3], 0.0)

            # (b) plain versions at the comparison width, kernels at the
            # 1080p bounce-0 launch beside their bounds
            pfs, pis = cmp_in
            pcand = cull_closest(tbl, pfs, pis, cfg)
            names = [k6_name(tbl, kcfg)] + (
                [k6_name(tbl, kcfg, True)] if tbl.env is not None else [])
            # the final round is timed once, on the sky city
            names = [nm for nm in names if nm not in ms]
            for name in names:
                final = name.endswith("_final")
                plain_ms[name] = _cuda_ms(
                    lambda: BC.closest_shade_reference(
                        pcand, pfs, pis, tbl, kcfg, sample, kslots, mt,
                        final_env=final), 1)
            fs, is_, src = camera_state(host, cfg, w, h)
            fs, is_, src = BC.sort_wavefront(fs, is_, src, True, bounds_)
            cand = cull_closest(tbl, fs, is_, cfg)
            od = BC.ray_operand(fs, is_)
            ha3, visits3 = BC.closest_hit(cand, od, tbl.blocks, kslots, mt,
                                          stats=True)
            BC.rows_screen_stats(dev, True)
            _, _, sh, hit6, visited6 = BC.closest_shade(
                cand, fs, is_, tbl, kcfg, sample, kslots, mt, stats=True)
            screen6 = BC.rows_screen_stats(dev, False)["closest"]
            # winners that differ from K3's on the same lists: near-ties
            # that the per-row operand and the division round otherwise
            act = is_[bf.IS_ACTIVE] > 0
            flip = act & (ha3[BC.HA_PRIM] != hit6[1])
            one = flip & ((ha3[BC.HA_PRIM] >= 0) != (hit6[1] >= 0))
            both = flip & ~one
            rel = (ha3[BC.HA_T] - hit6[0]).abs() / ha3[BC.HA_T].clamp(
                min=1e-30)
            differ = dict(winners_differ_from_k3=int(flip.sum()),
                          active=int(act.sum()),
                          hit_by_one_only=int(one.sum()),
                          max_rel_t_both_hit=float(rel[both].max())
                          if both.any() else 0.0, screen=screen6)
            for name in names:
                final = name.endswith("_final")
                bounds[name], launch[name] = k6_bound(
                    tbl, kcfg, cand, is_, cfg, visited6, hit6, visits3,
                    final)
                launch[name].update(differ)
            l6 = launch[names[0]]
            if label == "city" and group_path:
                _save_group(group_path, tbl, cand, fs, is_, ha3, hit6,
                            flip, kslots, mt, sample, cfg)
            print(f"per_row {label} 1080p bounce 0: K6 rows visit "
                  f"{l6['row_visits']} (row, slot) pairs, {l6['pairs']} "
                  f"ray-triangle pairs against K3's {l6['k3_pairs']} on the "
                  f"same lists; {l6['winners_differ_from_k3']} of "
                  f"{l6['active']} active lanes keep another winner than K3 "
                  f"({l6['hit_by_one_only']} of them a hit in one kernel "
                  f"only; t within {l6['max_rel_t_both_hit']:.3g} relative "
                  f"where both hit); K6's screen passes "
                  f"{_share(screen6)} of its pairs", flush=True)
            for name in names:
                final = name.endswith("_final")
                ms[name] = _cuda_ms(lambda: BC.closest_shade(
                    cand, fs, is_, tbl, kcfg, sample, kslots, mt,
                    final_env=final), 3)
            if label != "city":
                continue
            # the megakernel question: K6 against K3 (one page, the same
            # lists) + K4 on the same launch; K7 against K5
            ha3 = BC.post_attr_inst(ha3, tbl)
            mega = dict(k6=ms[names[0]], k3=_cuda_ms(lambda: BC.closest_hit(
                cand, od, tbl.blocks, kslots, mt), 3),
                k4=_cuda_ms(lambda: BC.shade(ha3, fs, is_, tbl, kcfg,
                                             sample), 10))
            shp, perm, cand_s = cull_shadow(tbl, sh, bounds_, cfg)
            ms[k7n] = _cuda_ms(lambda: BC.occlusion_rows(
                cand_s, shp, tbl.blocks, kslots), 3)
            mega["k7"] = ms[k7n]
            mega["k5"] = _cuda_ms(lambda: BC.occlusion(
                cand_s, shp, tbl.blocks, kslots), 3)
            BC.rows_screen_stats(dev, True)
            _, tests = BC.occlusion_rows(cand_s, shp, tbl.blocks, kslots,
                                         stats=True)
            screen7 = BC.rows_screen_stats(dev, False)["shadow"]
            g = cand_s.shape[0]
            slots = torch.arange(kslots, device=dev)[None]
            k7_blocks = int(torch.unique(cand_s[:, 0, 1:1 + kslots][
                slots < cand_s[:, 0, :1]]).numel())
            pairs7 = int(tests.sum())
            bounds[k7n] = _bound(
                4 * (cand_s.numel() + 9 * g * BC.FL)
                + STAGED_BLOCK_BYTES * k7_blocks, f32=pairs7 * K5_PAIR_F32,
                tf32=pairs7 * PAIR_TF32, bf16=pairs7 * PAIR_BF16)
            launch[k7n] = dict(groups=g, blocks=k7_blocks, pairs=pairs7,
                               requests=int((shp[BC.SH_DO] > 0.5).sum()),
                               screen=screen7)
            pshp, _, pcand_s = cull_shadow(
                tbl, BC.closest_shade_reference(
                    pcand, pfs, pis, tbl, kcfg, sample, kslots, mt)[2],
                bounds_, cfg)
            plain_ms[k7n] = _cuda_ms(lambda: BC.occlusion_rows_reference(
                pcand_s, pshp, tbl.blocks, kslots), 1)
            mega.update(k3_plus_k4=mega["k3"] + mega["k4"],
                        k6_bound=bounds[names[0]][0], k7_bound=bounds[k7n][0])
            rec["megakernel"] = mega
            print(f"per_row megakernel, the city's 1080p bounce-0 launch: "
                  f"K6 {mega['k6']:.4f} ms against K3 (one page) "
                  f"{mega['k3']:.4f} + K4 {mega['k4']:.4f} = "
                  f"{mega['k3_plus_k4']:.4f} ms; K7 {mega['k7']:.4f} ms "
                  f"against K5 {mega['k5']:.4f} ms; K7's screen passes "
                  f"{_share(screen7)} of its pairs ({smi})", flush=True)
        libs_log = kernels.CLUSTER_ROWS.ptxas_log
        ptxas = {name: _ptxas_entry(
            libs_log, "shadow_rows_kernel" if name == k7n else
            f"closest_shade_kernelILb{int('_tex' in name)}E")
            for name in ms}
        rec.update(ms=ms, plain_ms=plain_ms, bounds=bounds, launch=launch,
                   ptxas=ptxas)
        for name in ms:
            ptxas[name]["dynamic_smem"] = ROWS_DYN_SMEM[
                "k7" if name == k7n else "k6"]
            terms = ", ".join(f"{k} {v:.4f}"
                              for k, v in bounds[name][2].items())
            print(f"per_row {name}: kernel {ms[name]:.4f} ms at the 1080p "
                  f"bounce-0 launch (the CUDA-core kernel before it "
                  f"{ROWS_BEFORE_MS[name]} ms, PERF.md), "
                  f"{bounds[name][0] / ms[name]:.1%} of its bound, plain "
                  f"{plain_ms[name]:.4f} ms at 64 "
                  f"groups, bound {bounds[name][0]:.4f} ms "
                  f"({bounds[name][1]}; ms by term: {terms}), "
                  f"{ptxas[name]['registers']} registers, spills "
                  f"{ptxas[name]['spill_store_bytes']}/"
                  f"{ptxas[name]['spill_load_bytes']} B, "
                  f"{ptxas[name]['dynamic_smem']} B of dynamic shared "
                  f"memory per block ({smi})", flush=True)
        dump()

        # (c) the three 1080p per-row frames
        launches = {}
        for label, (host, scene, cfg) in scenes.items():
            tbl = scene.cluster_tables
            kcfg = bf.KernelConfig.from_cfg(cfg)
            cam = default_camera(host, w, h, device=dev)
            render_sample(scene, cam, cfg, w, h, 0)               # warm-up
            torch.cuda.synchronize()
            kernels.launches.clear()
            t0 = time.perf_counter()
            acc, rays, overflow, images = None, 0, 0, {}
            for s in range(1, 1 + ROWS_SPP):
                out = render_sample(scene, cam, cfg, w, h, s)
                images[s] = out["L"]
                acc = out["L"] if acc is None else acc + out["L"]
                rays = rays + out["ray_count"]
                overflow = overflow + out["cull_overflow"]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[label] = dict(kernels.launches)
            want = {k6_name(tbl, kcfg): cfg.max_bounces * ROWS_SPP,
                    k7n: cfg.max_bounces * ROWS_SPP}
            if tbl.env is not None:
                want[k6_name(tbl, kcfg, True)] = ROWS_SPP
            rays, overflow = int(rays), int(overflow)
            hdr = acc / ROWS_SPP
            # the flat route on sample 1, at one page and at the default
            # pages, each timed by the host clock (one frame each)
            BC.FLAT = True
            try:
                flat_ms = []
                flat = []
                for c in (dataclasses.replace(cfg, cluster_pages=1), cfg):
                    t1 = time.perf_counter()
                    flat.append(render_sample(scene, cam, c, w, h, 1)["L"])
                    torch.cuda.synchronize()
                    flat_ms.append((time.perf_counter() - t1) * 1e3)
                flat1, flat2 = flat
            finally:
                BC.FLAT = False
            img1 = images[1].cpu().numpy()
            p = dict(res=f"{w}x{h}", spp_timed=ROWS_SPP,
                     bounces=cfg.max_bounces, launches=launches[label],
                     expected=want, rays=rays, seconds=dt,
                     mrays_per_s=rays / dt / 1e6,
                     ms_per_frame_1spp=dt / ROWS_SPP * 1e3,
                     cull_overflow=overflow,
                     occupancy=out["occupancy"].tolist(),
                     L_mean=float(hdr.mean()),
                     finite=bool(torch.isfinite(hdr).all()),
                     tier=out["kernel_tier"],
                     rmse_flat_1page=rmse(img1, flat1.cpu().numpy()),
                     pixels_equal_flat_1page=float(
                         (images[1] == flat1).all(-1).float().mean()),
                     rmse_flat_default=rmse(img1, flat2.cpu().numpy()),
                     flat_default_pages=cfg.cluster_pages,
                     flat_ms_1page=flat_ms[0], flat_ms_default=flat_ms[1],
                     card=smi)
            rec[f"{label}_path"] = p
            print(f"per_row path {label}: {tbl.n_tris} triangles {w}x{h} "
                  f"{cfg.max_bounces} bounces, {ROWS_SPP} spp: "
                  f"{p['mrays_per_s']:.3f} Mrays/s, "
                  f"{p['ms_per_frame_1spp']:.3f} ms per 1-spp frame, "
                  f"{rays} rays, cull_overflow {overflow}, launches "
                  f"{p['launches']} of {want}, mean L {p['L_mean']:.5f}; "
                  f"sample 1 against the flat route: 1 page RMSE "
                  f"{p['rmse_flat_1page']:.6g} ({p['pixels_equal_flat_1page']:.6f}"
                  f" of pixels equal), {cfg.cluster_pages} pages RMSE "
                  f"{p['rmse_flat_default']:.6g}; the flat route's sample-1 "
                  f"frame {flat_ms[0]:.3f} ms at 1 page, {flat_ms[1]:.3f} ms "
                  f"at {cfg.cluster_pages} ({smi})", flush=True)
            if p["launches"] != want or not p["finite"] or \
                    p["tier"] != "clustered" or p["L_mean"] <= 1e-3:
                dump()
                _fail(f"per_row {label}: the path did not run every bounce "
                      f"through K6 and K7, or gave a non-finite or dark "
                      f"image")
            if label != "city":
                continue
            from torch.profiler import ProfilerActivity, profile
            kernels.launches.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                render_sample(scene, cam, cfg, w, h, ROWS_SPP + 1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            p["split"], p["profile_table"] = _split(
                prof, wall, ranges=ROWS_RANGES, kernel_parts=ROWS_KERNELS)
            sp = p["split"]
            n6 = kernels.launches[k6_name(tbl, kcfg)]
            n7 = kernels.launches[k7n]
            busy = sp["device_busy"]
            sp.update(k6_share=sp["k6"] / busy, k7_share=sp["k7"] / busy,
                      k6_ms_per_launch=sp["k6"] / n6,
                      k7_ms_per_launch=sp["k7"] / n7)
            print(f"per_row city split (one profiled frame, ms): "
                  f"{json.dumps(sp)}; K6 {sp['k6_share']:.1%} and K7 "
                  f"{sp['k7_share']:.1%} of the device time, per launch "
                  f"over the frame K6 {sp['k6_ms_per_launch']:.4f} ms ({n6} "
                  f"launches), K7 {sp['k7_ms_per_launch']:.4f} ms ({n7}) "
                  f"({smi})", flush=True)
    finally:
        BC.FLAT = True
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"per_row: phase 16 in {rec['seconds']:.1f}s", flush=True)
    dump()

    entries = {}
    for name in ms:
        by_path = {k: v.get(name, 0) for k, v in launches.items()}
        if not sum(by_path.values()):
            _fail(f"per_row: {name} never launched on the per-row paths")
        entries[name] = dict(
            name=name, route="cuda",
            source="rtxpt_tpu_torch/csrc/cluster_rows.cu",
            replaces="rtxpt_tpu/pt/bounce_clustered.py:"
            + ("1080" if name == k7n else "825"),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err[name], ms=ms[name], plain_ms=plain_ms[name],
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            library_ms=None)
    return dict(entries=entries)


def _save_group(path, tbl, cand, fs, is_, ha3, hit6, flip, kslots, mt,
                sample, cfg):
    """Save, as an .npz at `path`, the SAVED_GROUPS ray groups of a launch
    with the most lanes whose K6 winner (`hit6`) differs from K3's (`ha3`)
    on the same lists: their candidate rows with the listed clusters
    renumbered 0..k-1, those clusters' blocks, their state rows, the
    material and light tables, both kernels' winners and t, and the
    launch's settings. Replayed through the JAX package's own kernels by
    tools/replay_diverged_group.py."""
    import numpy as np
    import torch

    from rtxpt_tpu_torch.pt import bounce_clustered as BC

    per_group = flip.view(-1, BC.FL).sum(1)
    gs = torch.argsort(per_group, descending=True, stable=True)[
        :SAVED_GROUPS]
    lanes = (gs[:, None] * BC.FL
             + torch.arange(BC.FL, device=gs.device)).reshape(-1)
    rows = cand[gs].clone()
    cids, local = torch.unique(rows[:, 0, 1:1 + kslots], return_inverse=True)
    rows[:, 0, 1:1 + kslots] = local.to(rows.dtype)
    arrays = dict(
        groups=gs, cand=rows, blocks=tbl.blocks[cids.long()],
        cluster_ids=cids, fs=fs[:, lanes], is_=is_[:, lanes],
        mat_rows=tbl.mat_rows, light_rows=tbl.light_rows,
        k3_prim=ha3[BC.HA_PRIM, lanes], k3_t=ha3[BC.HA_T, lanes],
        k6_prim=hit6[1, lanes], k6_t=hit6[0, lanes], differ=flip[lanes])
    np.savez_compressed(
        path, kslots=kslots, max_travel=mt, sample=sample,
        n_lights=tbl.n_lights, max_bounces=cfg.max_bounces,
        nee=cfg.nee.value,
        **{k: v.cpu().numpy() for k, v in arrays.items()})
    print(f"per_row: groups {gs.tolist()} ({int(flip[lanes].sum())} lanes "
          f"whose K6 winner differs from K3's) saved to {path}", flush=True)


SPLIT_SPP = 2                 # phase 17: timed samples of each path, each way
SPLIT_SIDE = 64               # phase 17 (a): 4,096 rays per instantiation
PARTITION_TOL = 2e-2          # |L - emission - L_diff - L_spec| (tests/
#                               test_split_hot_tiers.py:37-39)
AUX_KEYS = ("L_diff", "L_spec", "albedo", "albedo_diff", "albedo_spec",
            "normal", "depth", "wpos", "emission")


def _bit_exact(kern, plain):
    """(bit-exact, max abs err) of a launch's outputs against its plain
    version's: integer rows equal, non-finite values on the same lanes,
    and the largest |difference| where both are finite (0 when exact)."""
    import torch
    same, err = True, 0.0
    for k, p in zip(kern, plain):
        if k.dtype == torch.int32:
            same = same and bool(torch.equal(k, p))
            continue
        fk, fp = torch.isfinite(k), torch.isfinite(p)
        same = same and bool(torch.equal(fk, fp)) and bool(
            torch.equal(torch.isnan(k), torch.isnan(p)))
        both = fk & fp
        if both.any():
            err = max(err, float((k - p)[both].abs().max()))
    return same and err == 0.0, err


def _k1_screen_instantiations(phase, dev, restart):
    """K1's eight instantiations without the priority switch (texture,
    micromaps, split) on 4,096 camera rays of the 44-triangle curtain grid
    (procedural.curtain_cornell(True, grid=4)), whose table takes K1's
    tensor-core screen (the one-quad curtain's 14 triangles take its exact
    loops; the priority instantiations' overlap curtain, 28, the screen):
    bounces 0 and 2 against the plain version, `restart` with
    first_direct=False and bounce 0 injected, audited under `phase`.
    Returns ({key: {bounce: (bit-exact, max abs err)}}, failures)."""
    import itertools

    import torch

    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
    from rtxpt_tpu_torch.scene.procedural import curtain_cornell, default_camera

    host = curtain_cornell(True, grid=4)
    scene = prepare(host, device=dev)
    if scene.bounce_tables.n_tris <= bf.EXACT_TRIS:
        _fail(f"{phase}: the curtain grid does not take K1's screen")
    out, failed = {}, []
    for t, o_, s_ in itertools.product((False, True), repeat=3):
        cfg = PathTracerConfig(max_bounces=3, nee=NEEMode.POWER,
                               stochastic_texture_filtering=t)
        kcfg = bf.KernelConfig.from_cfg(cfg)
        tb = dataclasses.replace(scene.bounce_tables, omm=o_)
        cam = default_camera(host, SPLIT_SIDE, SPLIT_SIDE, device=dev)
        px, py = _pixel_grid(SPLIT_SIDE, SPLIT_SIDE, dev)
        fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
        fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=dev) if s_ else None
        inj = bf.bounce_reference(fs, is_, tb, kcfg, 1, fs2=fs2)[2][
            :bf.NINJ].contiguous() if restart else None
        key = f"tex{int(t)}_omm{int(o_)}_split{int(s_)}"
        out[key] = {}
        for b in range(3):
            kw = dict(fs2=fs2)
            if restart:
                kw.update(inj=inj if b == 0 else None, first_direct=False)
            plain = bf.bounce_reference(fs, is_, tb, kcfg, 1, **kw)
            if b in (0, 2):
                kern = _k1_audited(phase, lambda: bf.bounce(
                    fs, is_, tb, kcfg, 1, **kw), plain)
                out[key][f"b{b}"] = _bit_exact(kern, plain)
                if not out[key][f"b{b}"][0]:
                    failed.append(f"k1 screen {key} bounce {b}")
            fs, is_ = plain[0], plain[1]
            fs2 = plain[-1] if s_ else None
    return out, failed


def _split_aux(record, dev, smi, dump, city_prepared):
    """Phase 17: the split channels and the aux guide buffers. (a) All
    sixteen instantiations (tex, omm, prio, split) of K1 on the curtain
    Cornell box and of K4 on its 40 x 40 grid (K3's hits), the priority
    ones on the overlap curtain (procedural.overlap_curtain, without and
    with its wall) from its inside cameras with at least FALSE_HIT_SHARE
    of the active lanes priority false hits off the curtain, 4,096 camera
    rays, bounces 0 and 2 (the plain version carries the state and the
    split rows), and the split variants on the main paths' inputs: K1 on
    65,536 Cornell rays (slot 2) and rooms rays (slot 3, SF_* rows), K4 on
    the 64 groups of the city's sorted 1080p wavefront with the most hits
    at bounces 0 and 2 (carried by the kernels), in slot 2 and in the
    export slots 3 and 5 (SF_* rows): each bit-exact with its plain
    version (max abs err 0). (b) K1 split and K1 timed at the Cornell
    path's and the rooms' 2^18-ray launches, K4 split and K4 at the city's
    1080p bounce-0 launch, beside their bounds (the non-split bound plus
    the fs2 rows read and written), with every instantiation's registers
    and spills. (c) The three paths at 1920x1080, 4 bounces, each without
    and with split_channels + want_aux in turns (1 warm-up each, then
    SPLIT_SPP timed samples each): the Cornell box (fused, power NEE, 8
    chunks of 2^18), rooms_scene(16) with NEE-AT through the tile state
    render_adaptive keeps (K1 split in slot 3, external_nee's cdiff, K2)
    and the city (flat clustered, 2 pages; K3, K4 split, K5, with its
    cull_overflow); the split run's launch counts, the partition residual,
    finite L_diff, L_spec and aux buffers. Returns dict(entries={name:
    kernel-line entry}, launches={path: counts})."""
    import dataclasses as dc

    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
    from rtxpt_tpu_torch.lighting import neeat as na
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_clustered as BC
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render_sample)
    from rtxpt_tpu_torch.scene.procedural import (
        OVERLAP_CURTAIN_Y, cornell_box, default_camera, overlap_curtain,
        rooms_scene)

    t_phase = time.perf_counter()
    rec = dict(card=smi)
    record["split"] = rec
    sample = 1
    w, h = EXT_FRAME

    def grid_state(host, cfg, cols, rows, side_w=None, side_h=None):
        """Camera rays of a cols x rows grid spread over a side_w x side_h
        frame (the grid itself when not given)."""
        cam = default_camera(host, side_w or cols, side_h or rows,
                             device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        if side_w:
            px, py = px * side_w // cols, py * side_h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        return bf.initial_state(o, d, spread, px, py)

    def zeros2(fs):
        return torch.zeros((bf.NF2, fs.shape[1]), device=dev)

    failed = []
    err_k1 = err_k4 = 0.0

    # ---- (a) the sixteen instantiations of K1 and K4 ----
    hosts = _alpha_hosts()
    curtain = prepare(hosts["curtain"], device=dev)
    grid = prepare(hosts["grid"], device=dev)
    nest = prepare(overlap_curtain([1, 2, 0]), device=dev)
    nest_wall = prepare(overlap_curtain([1, 2, 0, 0], wall=True), device=dev)
    if not (nest.has_nested_priorities and nest.bounce_tables.omm
            and nest_wall.has_nested_priorities
            and nest_wall.cluster_tables.omm):
        _fail("split: the overlap curtain does not take every switch")

    def false_hits(fs, is_in, is_out, t, hit):
        """Share of the active lanes that passed through a priority false
        hit: a hit off the curtain's plane."""
        y = fs[bf.FS_O + 1] + t * fs[bf.FS_D + 1]
        off = (y - OVERLAP_CURTAIN_Y).abs() >= 1e-3
        return _false_hit_share(is_in, is_out, hit & off)

    inst = {}
    for t in (False, True):
        cfg = PathTracerConfig(max_bounces=3, nee=NEEMode.POWER,
                               stochastic_texture_filtering=t)
        kcfg = bf.KernelConfig.from_cfg(cfg)
        for o_ in (False, True):
            for p in (False, True):
                for s_ in (False, True):
                    key = f"tex{int(t)}_omm{int(o_)}_prio{int(p)}_" \
                          f"split{int(s_)}"
                    k1_scene = nest if p else curtain
                    tb = dc.replace(k1_scene.bounce_tables, omm=o_, prio=p)
                    fs, is_ = _prio_state(SPLIT_SIDE, SPLIT_SIDE, dev,
                                          sample) if p else grid_state(
                        hosts["curtain"], cfg, SPLIT_SIDE, SPLIT_SIDE)
                    fs2 = zeros2(fs) if s_ else None
                    res, shares = {}, {}
                    for b in range(3):
                        plain = bf.bounce_reference(fs, is_, tb, kcfg,
                                                    sample, fs2=fs2)
                        if b in (0, 2):
                            kern = _k1_audited("split", lambda: bf.bounce(
                                fs, is_, tb, kcfg, sample, fs2=fs2), plain)
                            res[f"k1_b{b}"] = _bit_exact(kern, plain)
                            if p:
                                shares[f"k1_b{b}"] = false_hits(
                                    fs, is_, plain[1], plain[2][0],
                                    plain[2][1] >= 0)
                        fs, is_ = plain[0], plain[1]
                        fs2 = plain[-1] if s_ else None
                    ctbl = (nest_wall if p else grid).cluster_tables
                    fs, is_ = _prio_state(SPLIT_SIDE, SPLIT_SIDE, dev,
                                          sample) if p else grid_state(
                        hosts["grid"], cfg, SPLIT_SIDE, SPLIT_SIDE)
                    fs2 = zeros2(fs) if s_ else None
                    for b in range(3):
                        od = BC.ray_operand(fs, is_)
                        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3],
                                          fs[bf.FS_D:bf.FS_D + 3],
                                          is_[bf.IS_ACTIVE] > 0, 1e27, ctbl,
                                          ctbl.n_clusters)
                        ha = BC.closest_hit(cand, od, ctbl.blocks,
                                            ctbl.n_clusters, 1e27,
                                            micro=ctbl.omm_word if o_
                                            else None)
                        plain = BC.shade_reference(ha, fs, is_, ctbl, kcfg,
                                                   sample, omm=o_, prio=p,
                                                   fs2=fs2)
                        if b in (0, 2):
                            kern = BC.shade(ha, fs, is_, ctbl, kcfg, sample,
                                            omm=o_, prio=p, fs2=fs2)
                            torch.cuda.synchronize()
                            res[f"k4_b{b}"] = _bit_exact(kern, plain)
                            if p:
                                shares[f"k4_b{b}"] = false_hits(
                                    fs, is_, plain[1], ha[BC.HA_T],
                                    ha[BC.HA_PRIM] >= 0)
                        fs, is_ = plain[0], plain[1]
                        fs2 = plain[-1] if s_ else None
                    inst[key] = {k: dict(exact=v[0], max_abs_err=v[1],
                                         false_hit_share=shares.get(k))
                                 for k, v in res.items()}
                    for k, (ok, e) in res.items():
                        if k.startswith("k1"):
                            err_k1 = max(err_k1, e)
                        else:
                            err_k4 = max(err_k4, e)
                        if not ok:
                            failed.append(f"{key} {k}")
                        if p and shares[k] < FALSE_HIT_SHARE:
                            failed.append(f"{key} {k} false hits "
                                          f"{shares[k]:.4f}")
    rec["instantiations"] = inst
    exact = {lib: sum(all(v[f"{lib}_b{b}"]["exact"] for b in (0, 2))
                      for v in inst.values()) for lib in ("k1", "k4")}
    least = min(v[k]["false_hit_share"] for v in inst.values() for k in v
                if v[k]["false_hit_share"] is not None)
    print(f"split (a): 16 K1 and 16 K4 instantiations at bounces 0 and 2 "
          f"on {SPLIT_SIDE * SPLIT_SIDE} rays: {exact['k1']} K1 and "
          f"{exact['k4']} K4 instantiations bit-exact, max abs err K1 "
          f"{err_k1:.3g}, K4 {err_k4:.3g}; the priority ones on the overlap "
          f"curtain, false hits at least {least:.4f} of the active lanes",
          flush=True)
    rec["k1_screen_instantiations"], bad = _k1_screen_instantiations(
        "split", dev, False)
    failed += bad
    print(f"split (a): K1's 8 instantiations without priorities on the "
          f"44-triangle curtain grid (the screen): "
          f"{8 - len({f.split()[2] for f in bad})} of 8 bit-exact at bounces "
          f"0 and 2", flush=True)

    # ---- (a) the split variants on the main paths' inputs, (b) times ----
    chost = cornell_box()
    cornell = prepare(chost, device=dev)
    rhost = rooms_scene(ROOMS)
    rooms = prepare(rhost, device=dev)
    cfgs = dict(
        cornell=(chost, cornell, PathTracerConfig(
            max_bounces=4, nee=NEEMode.POWER, split_channels=True,
            ray_chunk=RAYS_TIMED)),
        rooms=(rhost, rooms, PathTracerConfig(
            max_bounces=4, nee=NEEMode.NEEAT, split_channels=True,
            ray_chunk=EXT_CHUNK)))
    k1 = {}
    for name, (host, scene, cfg) in cfgs.items():
        tbl = scene.bounce_tables
        kcfg = bf.KernelConfig.from_cfg(cfg)
        fs, is_ = grid_state(host, cfg, CMP_SIDE, CMP_SIDE, w, h)
        fs2 = zeros2(fs)
        cmp = {}
        for b in range(3):
            plain = bf.bounce_reference(fs, is_, tbl, kcfg, sample, fs2=fs2)
            if b in (0, 2):
                kern = _k1_audited("split", lambda: bf.bounce(
                    fs, is_, tbl, kcfg, sample, fs2=fs2), plain)
                ok, e = _bit_exact(kern, plain)
                cmp[f"bounce{b}"] = dict(exact=ok, max_abs_err=e)
                err_k1 = max(err_k1, e)
                if not ok:
                    failed.append(f"k1 split {name} bounce {b}")
            fs, is_, fs2 = plain[0], plain[1], plain[-1]
        # times at the path's launch width: 2^18 rays over the frame
        side = int(round(RAYS_TIMED ** 0.5))
        fs_t, is_t = grid_state(host, cfg, side, side, w, h)
        f2_t = zeros2(fs_t)
        ms_split = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg, sample,
                                              fs2=f2_t), 20)
        ms_plain_variant = _cuda_ms(lambda: bf.bounce(fs_t, is_t, tbl, kcfg,
                                                      sample), 20)
        plain_ms = _cuda_ms(lambda: bf.bounce_reference(
            fs_t, is_t, tbl, kcfg, sample, fs2=f2_t), 2)
        n = side * side
        rows = 2 * (bf.NF + bf.NI) + bf.NH \
            + (bf.SF_ROWS if kcfg.external else 0)
        tables_b = 4 * sum(_numel(t) for t in (
            tbl.tri_coef, tbl.attr_rows, tbl.mat_rows, tbl.light_rows,
            tbl.env))
        active = int((is_t[bf.IS_ACTIVE] > 0).sum())
        ops = _k1_ops(tbl.n_tris, active * tbl.n_tris + _k1_shadow_pairs(
            lambda: bf.bounce_reference(fs_t, is_t, tbl, kcfg, sample,
                                        fs2=f2_t)))
        bound, by, _ = _bound(4 * n * (rows + 2 * bf.NF2) + tables_b, **ops)
        bound_ns, by_ns, _ = _bound(4 * n * rows + tables_b, **ops)
        k1[name] = dict(cmp, slot=kcfg.nee_mode, rays=n, ms=ms_split,
                        ms_without_split=ms_plain_variant, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by,
                        bound_without_split_ms=bound_ns,
                        bound_without_split_by=by_ns)
        print(f"split k1 {name} slot {kcfg.nee_mode}: bounces 0/2 exact "
              f"{cmp['bounce0']['exact']}/{cmp['bounce2']['exact']}; split "
              f"{ms_split:.4f} ms, without {ms_plain_variant:.4f} ms per "
              f"{n}-ray launch, plain {plain_ms:.4f} ms, bound {bound:.4f} "
              f"ms ({by}; without split {bound_ns:.4f}) ({smi})", flush=True)
    rec["k1"] = k1
    _k1_report(record, "split", dump)

    # K4 split on the city's 1080p wavefront: bounce 0 and 2 (the kernels
    # carry it), the 64 groups with the most hits compared
    chost_city, city, _ = city_prepared
    ctb = city.cluster_tables
    ccfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                            split_channels=True, ray_chunk=1 << 30)
    kcfg = bf.KernelConfig.from_cfg(ccfg)
    export = {3: dc.replace(ccfg, nee=NEEMode.NEEAT),
              5: dc.replace(ccfg, nee_external=True)}
    export = {k: bf.KernelConfig.from_cfg(v) for k, v in export.items()}
    if [k.nee_mode for k in export.values()] != [3, 5]:
        _fail("split: the export configurations are not slots 3 and 5")
    cw, ch = CITY_FRAME
    fs, is_ = grid_state(chost_city, ccfg, cw, ch)
    n = fs.shape[1]
    fs2 = zeros2(fs)
    src = torch.arange(n, dtype=torch.int32, device=dev)
    bounds = BC.scene_bounds(ctb)
    k4 = {}
    for b in range(3):
        fs, is_, src, fs2 = BC.sort_wavefront(fs, is_, src, b == 0, bounds,
                                              fs2)
        ha, _ = BC.closest_paged(fs, is_, ctb, 64, CITY_PAGES, 1e27)
        if b in (0, 2):
            hits = (ha[BC.HA_T] < bf._BIG).reshape(-1, BC.FL).sum(1)
            top = torch.topk(hits, min(64, hits.numel())).indices.sort() \
                .values
            lanes = (top[:, None] * BC.FL + torch.arange(
                BC.FL, device=dev)).reshape(-1)
            sub = [x[:, lanes].contiguous() for x in (ha, fs, is_, fs2)]
            kern = BC.shade(*sub[:3], ctb, kcfg, sample, fs2=sub[3])
            plain = BC.shade_reference(*sub[:3], ctb, kcfg, sample,
                                       fs2=sub[3])
            torch.cuda.synchronize()
            ok, e = _bit_exact(kern, plain)
            err_k4 = max(err_k4, e)
            k4[f"bounce{b}"] = dict(exact=ok, max_abs_err=e,
                                    hit_share=float(hits[top].sum())
                                    / lanes.numel())
            if not ok:
                failed.append(f"k4 split city bounce {b}")
            for slot, kx in export.items():
                # the export slots on the same rows: the SF_* rows too
                kern = BC.shade(*sub[:3], ctb, kx, sample, fs2=sub[3])
                plain = BC.shade_reference(*sub[:3], ctb, kx, sample,
                                           fs2=sub[3])
                torch.cuda.synchronize()
                ok, e = _bit_exact(kern, plain)
                err_k4 = max(err_k4, e)
                shaded = float((plain[3][5] > 0.5).float().mean())
                k4[f"slot{slot}_bounce{b}"] = dict(
                    exact=ok, max_abs_err=e, shaded_share=shaded,
                    outputs=len(kern))
                if not ok or len(kern) != 6:
                    failed.append(f"k4 split city slot {slot} bounce {b}")
                if shaded < 0.05:
                    failed.append(f"k4 split city slot {slot} bounce {b} "
                                  f"shaded share {shaded:.4f}")
        if b == 0:
            ms_split = _cuda_ms(lambda: BC.shade(ha, fs, is_, ctb, kcfg,
                                                 sample, fs2=fs2), 10)
            ms_ns = _cuda_ms(lambda: BC.shade(ha, fs, is_, ctb, kcfg,
                                              sample), 10)
            plain_ms = _cuda_ms(lambda: BC.shade_reference(
                *sub[:3], ctb, kcfg, sample, fs2=sub[3]), 2)
            bound, by, _ = _bound(_k4_bytes(n, ctb, False, False,
                                            split=True))
            bound_ns, by_ns, _ = _bound(_k4_bytes(n, ctb, False, False))
            k4.update(lanes=n, ms=ms_split, ms_without_split=ms_ns,
                      plain_ms=plain_ms, plain_lanes=sub[1].shape[1],
                      bound_ms=bound, bound_by=by,
                      bound_without_split_ms=bound_ns)
        out = BC.shade(ha, fs, is_, ctb, kcfg, sample, fs2=fs2)
        fs, is_, fs2 = out[0], out[1], out[-1]
    rec["k4"] = k4
    print(f"split k4 city: bounces 0/2 exact {k4['bounce0']['exact']}/"
          f"{k4['bounce2']['exact']}, in the export slots 3/5 "
          f"{k4['slot3_bounce0']['exact'] and k4['slot3_bounce2']['exact']}/"
          f"{k4['slot5_bounce0']['exact'] and k4['slot5_bounce2']['exact']}"
          f" (hit shares "
          f"{k4['bounce0']['hit_share']:.3f}/{k4['bounce2']['hit_share']:.3f}"
          f"); split {k4['ms']:.4f} ms, without {k4['ms_without_split']:.4f}"
          f" ms at {n} lanes, plain {k4['plain_ms']:.4f} ms at "
          f"{k4['plain_lanes']}, bound {k4['bound_ms']:.4f} ms "
          f"({k4['bound_by']}; without split "
          f"{k4['bound_without_split_ms']:.4f}) ({smi})", flush=True)
    rec["ptxas"] = {
        f"{lib}_tex{t}_omm{o_}_prio{p}_split{s_}": _ptxas_entry(
            getattr(kernels, attr).ptxas_log,
            f"{lib}_kernelILb{t}ELb{o_}ELb{p}ELb{s_}E")
        for lib, attr in (("bounce_fused", "BOUNCE_FUSED"),
                          ("cluster_shade", "CLUSTER_SHADE"))
        for t in (0, 1) for o_ in (0, 1) for p in (0, 1) for s_ in (0, 1)}
    print("split ptxas (registers, spill store bytes): " + ", ".join(
        f"{k} {v['registers']}/{v['spill_store_bytes']}"
        for k, v in rec["ptxas"].items()), flush=True)
    dump()
    if failed:
        _fail(f"split: not bit-exact with the plain version, or too few "
              f"lanes exercised: {failed}")

    # ---- (c) the three paths, without and with split + aux ----
    paths = dict(
        cornell=(chost, cornell, cfgs["cornell"][2], (w, h)),
        rooms=(rhost, rooms, cfgs["rooms"][2], (w, h)),
        city=(chost_city, city, ccfg, CITY_FRAME))
    launches, frames = {}, {}
    for name, (host, scene, cfg, (fw, fh)) in paths.items():
        cam = default_camera(host, fw, fh, device=dev)
        plain_cfg = dc.replace(cfg, split_channels=False)
        neeat = cfg.nee == NEEMode.NEEAT
        state = {False: None, True: None}

        def frame(split, s):
            """One sample, the NEE-AT tile state updated after it as
            render_adaptive does."""
            kw = {}
            if neeat:
                if state[split] is None:
                    state[split] = na.init_state(fw, fh, scene.lights.count,
                                                 device=dev)
                kw["neeat_state"] = state[split]
            out = render_sample(scene, cam, cfg if split else plain_cfg, fw,
                                fh, s, want_aux=split, **kw)
            if neeat:
                state[split] = na.update(state[split], out["neeat_hist"])
            return out

        frame(False, 0)                                      # warm-ups
        frame(True, 0)
        torch.cuda.synchronize()
        res = {}
        for split in (False, True):
            kernels.launches.clear()
            t0 = time.perf_counter()
            outs = [frame(split, s) for s in range(1, 1 + SPLIT_SPP)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(kernels.launches)
            rays = sum(int(o["ray_count"]) for o in outs)
            r = dict(ms_per_frame=dt / SPLIT_SPP * 1e3,
                     mrays_per_s=rays / dt / 1e6, launches=counts,
                     finite=all(bool(torch.isfinite(o["L"]).all())
                                for o in outs))
            if "cull_overflow" in outs[0]:
                r["cull_overflow"] = sum(int(o["cull_overflow"])
                                         for o in outs)
            if split:
                launches[name] = counts
                r["partition_residual"] = max(float((
                    o["L"] - o["emission"] - o["L_diff"]
                    - o["L_spec"]).abs().max()) for o in outs)
                r["finite_split_aux"] = all(
                    bool(torch.isfinite(o[k]).all()) for o in outs
                    for k in AUX_KEYS)
                r["L_diff_mean"] = float(outs[-1]["L_diff"].mean())
                r["L_spec_mean"] = float(outs[-1]["L_spec"].mean())
                r["L_mean"] = float(outs[-1]["L"].mean())
            res["split_aux" if split else "without"] = r
        frames[name] = res
        s_, p_ = res["split_aux"], res["without"]
        k = "cluster_shade_split" if name == "city" else "bounce_fused_split"
        n_chunks = -(-(fw * fh) // cfg.ray_chunk)
        want = n_chunks * cfg.max_bounces * SPLIT_SPP
        print(f"split path {name} {fw}x{fh}: without {p_['ms_per_frame']:.1f}"
              f" ms per 1-spp frame ({p_['mrays_per_s']:.2f} Mrays/s), with "
              f"split + aux {s_['ms_per_frame']:.1f} ms "
              f"({s_['mrays_per_s']:.2f}); {k} launches "
              f"{s_['launches'].get(k, 0)} of {want}; partition residual "
              f"{s_['partition_residual']:.3g}; L/L_diff/L_spec means "
              f"{s_['L_mean']:.5f}/{s_['L_diff_mean']:.5f}/"
              f"{s_['L_spec_mean']:.5f}"
              + (f"; cull_overflow {s_['cull_overflow']} (without "
                 f"{p_['cull_overflow']})" if "cull_overflow" in s_ else "")
              + f" ({smi})", flush=True)
        if s_["launches"].get(k, 0) != want or not s_["finite"] \
                or not s_["finite_split_aux"] or not p_["finite"] \
                or s_["partition_residual"] >= PARTITION_TOL \
                or (name == "rooms"
                    and s_["launches"].get("shadow_occlusion", 0) != want):
            rec["paths"] = frames
            dump()
            _fail(f"split: the {name} path did not run through the split "
                  f"kernels or its buffers are not right")
    rec["paths"] = frames
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"split: phase 17 in {rec['seconds']:.1f}s", flush=True)
    dump()

    def regs(lib):
        return {k: v for k, v in rec["ptxas"].items()
                if k.startswith(lib) and k.endswith("split1")}

    entries = dict(
        bounce_fused_split=dict(
            name="bounce_fused_split", route="cuda",
            source="rtxpt_tpu_torch/csrc/bounce_fused.cu",
            replaces="rtxpt_tpu/pt/bounce_pallas.py:1389",
            launches=sum(launches[p].get("bounce_fused_split", 0)
                         for p in ("cornell", "rooms")),
            launches_by_path={p: launches[p].get("bounce_fused_split", 0)
                              for p in ("cornell", "rooms")},
            max_abs_err=err_k1, ms=k1["cornell"]["ms"],
            plain_ms=k1["cornell"]["plain_ms"],
            bound_ms=k1["cornell"]["bound_ms"],
            bound_by=k1["cornell"]["bound_by"], library_ms=None,
            ms_rooms_slot3=k1["rooms"]["ms"],
            bound_rooms_slot3_ms=k1["rooms"]["bound_ms"],
            instantiations_bit_exact=exact["k1"],
            ptxas=regs("bounce_fused")),
        cluster_shade_split=dict(
            name="cluster_shade_split", route="cuda",
            source="rtxpt_tpu_torch/csrc/cluster_shade.cu",
            replaces="rtxpt_tpu/pt/bounce_clustered.py:462",
            launches=launches["city"].get("cluster_shade_split", 0),
            launches_by_path={"city": launches["city"].get(
                "cluster_shade_split", 0)},
            max_abs_err=err_k4, ms=k4["ms"], plain_ms=k4["plain_ms"],
            bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
            library_ms=None, instantiations_bit_exact=exact["k4"],
            export_slots_bit_exact=all(
                k4[f"slot{s_}_bounce{b}"]["exact"] for s_ in (3, 5)
                for b in (0, 2)),
            ptxas=regs("cluster_shade")))
    return dict(entries=entries, launches=launches)


RT_FRAME = (1920, 1080)       # phase 18: the real-time frames' display size
RT_CHUNK = 1 << 18            # the fused tier's rays per chunk (phase 5's)
RT_FRAMES = 4                 # timed frames of each fused-tier path
RT_CITY_FRAMES = 2            # timed frames of the city path
RT_CITY_PLANES_FRAME = (960, 540)   # the city's stable-planes frame (cut)
RT_COMPOSITE = (480, 270, 64)       # the composite check: size, frames
RT_COMPOSITE_RMSE = 2e-2      # tests/test_stable_planes.py:116-149
RT_REF_SPP = 128              # the denoiser check's reference accumulation
RT_STEP = 0.002               # camera motion per frame, in units of the
#                               distance to the camera's target


def _moving_camera(host, w, h, frame, dev):
    """The host's camera moved sideways by RT_STEP of its target distance
    per frame (the target moves with it)."""
    import numpy as np

    from rtxpt_tpu_torch.scene.camera import look_at
    c = host.camera or dict(position=[0, 1, 3], target=[0, 0, 0],
                            up=[0, 1, 0], fov_y_deg=45.0)
    pos = np.asarray(c["position"], np.float64)
    tgt = np.asarray(c["target"], np.float64)
    fwd = tgt - pos
    right = np.cross(fwd, np.asarray(c["up"], np.float64))
    right /= np.linalg.norm(right)
    shift = right * (RT_STEP * np.linalg.norm(fwd) * frame)
    return look_at(pos + shift, tgt + shift, c["up"], c["fov_y_deg"], w, h,
                   device=dev)


def _lane_exact_share(kern, plain):
    """Share of the lanes whose every row (integer and float) is the same
    in the kernel's and the plain version's outputs, NaN equal to NaN."""
    import torch
    same = None
    for k, p in zip(kern, plain):
        eq = (k == p) | (torch.isnan(k) & torch.isnan(p)) \
            if k.is_floating_point() else (k == p)
        eq = eq.all(0)
        same = eq if same is None else same & eq
    return float(same.float().mean())


def _realtime(record, dev, smi, dump, city_prepared):
    """Phase 18: real-time mode. (a) K1's inject variant (the V-buffer
    restart) and first_direct=False on the glass-over-mirror Cornell box
    (procedural.glass_mirror_cornell) at 1080p: 65,536 camera rays spread
    over the frame, the V-buffers of stable planes 0, 1 and 2 from
    `decompose`, bounce 0 injected with the planes' budgets and bounce 2
    (the plain version carries the state), first_direct=False at both,
    against the plain version: phase 3's criteria and the share of lanes
    bit-exact >= LANE_FRACTION. All sixteen instantiations with inject on
    (phase 17's 4,096 rays; the injected rows are the plain version's own
    bounce-0 hits), bounces 0 and 2, first_direct=False: bit-exact. The
    inject launch timed at 2^18 lanes (plane 0 of 512 x 512 rays over the
    frame) beside the ordinary K1 on the same camera rays, with the bound.
    (b) The frames at 1920x1080, 4 bounces, power NEE, the camera moving
    RT_STEP per frame, 1 warm-up then RT_FRAMES timed: render_frame on the
    Cornell box with RELAX, TAA and bloom; the same with split_denoise;
    the same at render_scale 0.5; render_frame_stable_planes on the
    glass-over-mirror box with RELAX and TAA; render_frame on the city
    (clustered, 2 pages; RT_CITY_FRAMES timed; cull_overflow); one
    stable-planes frame of the city at 960x540 (the general tier). ms per
    frame, launch counts (K1 inject per stable-planes frame: one per
    plane), each plane's share of valid pixels, and one profiled
    stable-planes frame split into BUILD, fills (K1), denoise, TAA with
    tonemap, the rest and idle. (c) Correctness: the glass-over-mirror
    composite at 480x270 (64 frames, no denoiser, firefly clamp 0.5, 4
    bounces) against `render` at 64 spp: RMSE < 2e-2, plane 1 valid on
    some pixels; the denoised Cornell render_frame at 1080p after 4 frames
    against the raw 1-spp frame: roughness < 0.35 x the raw one's, mean
    ratio within 0.5-2 (tests/test_realtime.py:17-51), and its RMSE
    against a 128-spp accumulation lower than the raw frame's. Returns
    dict(entries={name: kernel-line entry}, launches={path: counts})."""
    import dataclasses as dc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.config import (
        DenoiserMode, NEEMode, PathTracerConfig, RenderConfig)
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    from rtxpt_tpu_torch.pt import realtime
    from rtxpt_tpu_torch.pt.integrator import (
        _pixel_grid, camera_rays, render)
    from rtxpt_tpu_torch.pt.stable_planes import decompose
    from rtxpt_tpu_torch.pt.integrator import render_sample
    from rtxpt_tpu_torch.scene.procedural import (
        cornell_box, default_camera, glass_mirror_cornell, overlap_curtain)

    t_phase = time.perf_counter()
    rec = dict(card=smi)
    record["realtime"] = rec
    failed = []
    err = 0.0
    w, h = RT_FRAME
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode.POWER,
                           ray_chunk=RT_CHUNK)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    ghost = glass_mirror_cornell()
    glass = prepare(ghost, device=dev)
    gtb = glass.bounce_tables
    sample = 1

    def plane_states(cols, rows):
        """(planes, camera rays) of a cols x rows grid of rays spread over
        the 1080p frame."""
        cam = default_camera(ghost, w, h, device=dev)
        px, py = _pixel_grid(cols, rows, dev)
        px, py = px * w // cols, py * h // rows
        o, d, spread = camera_rays(cam, cfg, px, py, sample)
        planes, _ = decompose(glass, o, d)
        return planes, (o, d, spread, px, py)

    def restart_state(plane, rays):
        _, _, spread, px, py = rays
        fs, is_ = bf.initial_state(plane.o.contiguous(),
                                   plane.d.contiguous(), spread, px, py)
        is_[bf.IS_BUDGET] = torch.where(plane.valid, torch.clamp(
            cfg.max_bounces - plane.nverts, min=0), 0).to(torch.int32)
        return fs, is_, bf.pack_injection(plane.vbuffer(cfg.max_ray_travel))

    # ---- (a) K1 inject and first_direct=False against the plain version --
    planes, rays = plane_states(CMP_SIDE, CMP_SIDE)
    k1 = {}
    for i, plane in enumerate(planes):
        fs, is_, inj = restart_state(plane, rays)
        s_i = (sample + i * realtime.PLANE_SEED) & 0xFFFFFFFF
        for b in range(3):
            inj_b = inj if b == 0 else None
            plain = bf.bounce_reference(fs, is_, gtb, kcfg, s_i, inj=inj_b,
                                        first_direct=False)
            if b in (0, 2):
                kern = _k1_audited("realtime", lambda: bf.bounce(
                    fs, is_, gtb, kcfg, s_i, inj=inj_b, first_direct=False),
                    plain)
                summary, e = _compare_state(kern, plain)
                exact = _lane_exact_share(kern, plain)
                summary.update(lanes_bit_exact=exact,
                               active=int((is_[bf.IS_ACTIVE] > 0).sum()),
                               valid=int(plane.valid.sum()))
                k1[f"plane{i}_bounce{b}"] = summary
                err = max(err, e)
                if not _state_ok(summary) or exact < LANE_FRACTION:
                    failed.append(f"k1 inject plane {i} bounce {b}")
            fs, is_ = plain[0], plain[1]
    rec["k1"] = k1
    print("realtime k1 inject, first_direct=False, glass-over-mirror 1080p "
          f"({CMP_SIDE * CMP_SIDE} rays): " + "; ".join(
              f"{k} valid {v['valid']} exact {v['lanes_bit_exact']:.6f} "
              f"int {v['int_lanes_equal']:.6f} worst float "
              f"{v['worst_float_row']:.6f}" for k, v in k1.items())
          + f"; max abs err {err:.3g}", flush=True)
    if not planes[1].valid.any() or not planes[2].valid.any():
        failed.append("planes 1 and 2 empty on the comparison rays")

    # all sixteen instantiations with inject on
    hosts = _alpha_hosts()
    curtain = prepare(hosts["curtain"], device=dev)
    nest = prepare(overlap_curtain([1, 2, 0]), device=dev)
    inst = {}
    for t in (False, True):
        icfg = PathTracerConfig(max_bounces=3, nee=NEEMode.POWER,
                                stochastic_texture_filtering=t)
        ikcfg = bf.KernelConfig.from_cfg(icfg)
        for o_ in (False, True):
            for p in (False, True):
                for s_ in (False, True):
                    key = f"tex{int(t)}_omm{int(o_)}_prio{int(p)}_" \
                          f"split{int(s_)}"
                    tb = dc.replace((nest if p else curtain).bounce_tables,
                                    omm=o_, prio=p)
                    if p:
                        fs, is_ = _prio_state(SPLIT_SIDE, SPLIT_SIDE, dev,
                                              sample)
                    else:
                        cam = default_camera(hosts["curtain"], SPLIT_SIDE,
                                             SPLIT_SIDE, device=dev)
                        px, py = _pixel_grid(SPLIT_SIDE, SPLIT_SIDE, dev)
                        o, d, spread = camera_rays(cam, icfg, px, py, sample)
                        fs, is_ = bf.initial_state(o, d, spread, px, py)
                    fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=dev) \
                        if s_ else None
                    # the injected rows: the plain version's own hits
                    inj = bf.bounce_reference(fs, is_, tb, ikcfg, sample,
                                              fs2=fs2)[2][:bf.NINJ] \
                        .contiguous()
                    res = {}
                    for b in range(3):
                        inj_b = inj if b == 0 else None
                        plain = bf.bounce_reference(
                            fs, is_, tb, ikcfg, sample, fs2=fs2, inj=inj_b,
                            first_direct=False)
                        if b in (0, 2):
                            kern = _k1_audited("realtime", lambda: bf.bounce(
                                fs, is_, tb, ikcfg, sample, fs2=fs2,
                                inj=inj_b, first_direct=False), plain)
                            res[f"b{b}"] = _bit_exact(kern, plain)
                        fs, is_ = plain[0], plain[1]
                        fs2 = plain[-1] if s_ else None
                    inst[key] = {k: dict(exact=v[0], max_abs_err=v[1])
                                 for k, v in res.items()}
                    for k, (ok, e) in res.items():
                        err = max(err, e)
                        if not ok:
                            failed.append(f"inject {key} {k}")
    rec["instantiations"] = inst
    n_exact = sum(all(v[k]["exact"] for k in v) for v in inst.values())
    print(f"realtime k1 inject: {n_exact} of 16 instantiations bit-exact at "
          f"bounces 0 (injected) and 2 on {SPLIT_SIDE * SPLIT_SIDE} rays, "
          f"first_direct=False", flush=True)
    rec["k1_screen_instantiations"], bad = _k1_screen_instantiations(
        "realtime", dev, True)
    failed += bad
    print(f"realtime k1 inject: the 8 instantiations without priorities on "
          f"the 44-triangle curtain grid (the screen): "
          f"{8 - len({f.split()[2] for f in bad})} of 8 bit-exact at bounces "
          f"0 (injected) and 2", flush=True)
    _k1_report(record, "realtime", dump)

    # the inject launch timed beside the ordinary K1 (2^18 lanes)
    side = int(round(RAYS_TIMED ** 0.5))
    tplanes, trays = plane_states(side, side)
    fs_i, is_i, inj_t = restart_state(tplanes[0], trays)
    o, d, spread, px, py = trays
    fs_c, is_c = bf.initial_state(o, d, spread, px, py)
    ms_inj = _cuda_ms(lambda: bf.bounce(fs_i, is_i, gtb, kcfg, sample,
                                        inj=inj_t), 20)
    ms_k1 = _cuda_ms(lambda: bf.bounce(fs_c, is_c, gtb, kcfg, sample), 20)
    plain_ms = _cuda_ms(lambda: bf.bounce_reference(
        fs_i, is_i, gtb, kcfg, sample, inj=inj_t), 2)
    n = side * side
    tables_b = 4 * sum(_numel(x) for x in (
        gtb.tri_coef, gtb.attr_rows, gtb.mat_rows, gtb.light_rows))
    # the inject launch traces no closest hit, but its shadow rays run
    bound, by, _ = _bound(
        4 * n * (2 * (bf.NF + bf.NI) + bf.NH + bf.NINJ) + tables_b,
        **_k1_ops(gtb.n_tris, _k1_shadow_pairs(lambda: bf.bounce_reference(
            fs_i, is_i, gtb, kcfg, sample, inj=inj_t))))
    tests = int((is_c[bf.IS_ACTIVE] > 0).sum()) * gtb.n_tris \
        + _k1_shadow_pairs(lambda: bf.bounce_reference(
            fs_c, is_c, gtb, kcfg, sample))
    bound_k1, by_k1, _ = _bound(4 * n * (2 * (bf.NF + bf.NI) + bf.NH)
                                + tables_b, **_k1_ops(gtb.n_tris, tests))
    rec["timing"] = dict(lanes=n, ms=ms_inj, ms_k1=ms_k1, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, bound_k1_ms=bound_k1,
                         bound_k1_by=by_k1)
    rec["ptxas"] = {
        f"tex{t}_omm{o_}_prio{p}_split{s_}": _ptxas_entry(
            kernels.BOUNCE_FUSED_RESTART.ptxas_log,
            f"bounce_fused_restart_kernelILb{t}ELb{o_}ELb{p}ELb{s_}E")
        for t in (0, 1) for o_ in (0, 1) for p in (0, 1) for s_ in (0, 1)}
    print("realtime restart ptxas (registers, spill store bytes): "
          + ", ".join(f"{k} {v['registers']}/{v['spill_store_bytes']}"
                      for k, v in rec["ptxas"].items()), flush=True)
    print(f"realtime k1 inject: {ms_inj:.4f} ms per {n}-lane launch, K1 "
          f"{ms_k1:.4f} ms on the camera rays, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}; K1 {bound_k1:.4f}, {by_k1}) ({smi})",
          flush=True)
    dump()
    if failed:
        _fail(f"realtime: K1's inject variant disagrees with its plain "
              f"version: {failed}")

    # ---- (b) the frames ----
    chost = cornell_box()
    cornell = prepare(chost, device=dev)
    city_host, city, _ = city_prepared
    relax = DenoiserMode.RELAX
    city_cfg = dc.replace(cfg, ray_chunk=1 << 30)
    paths = dict(
        cornell=(chost, cornell, cfg, dict(enable_bloom=True),
                 realtime.render_frame, RT_FRAME, RT_FRAMES),
        cornell_split=(chost, cornell, cfg,
                       dict(enable_bloom=True, split_denoise=True),
                       realtime.render_frame, RT_FRAME, RT_FRAMES),
        cornell_half=(chost, cornell, cfg,
                      dict(enable_bloom=True, render_scale=0.5),
                      realtime.render_frame, RT_FRAME, RT_FRAMES),
        glass_planes=(ghost, glass, cfg, {},
                      realtime.render_frame_stable_planes, RT_FRAME,
                      RT_FRAMES),
        city=(city_host, city, city_cfg, {}, realtime.render_frame,
              RT_FRAME, RT_CITY_FRAMES),
        city_planes=(city_host, city, city_cfg, {},
                     realtime.render_frame_stable_planes,
                     RT_CITY_PLANES_FRAME, 1))
    launches, frames = {}, {}
    prof_args = None
    for name, (host, scene, pcfg, extra, fn, (fw, fh), n_frames) in \
            paths.items():
        rc = RenderConfig(width=fw, height=fh, denoiser=relax,
                          enable_taa=True, **extra)
        state = realtime.init_state(fh, fw, scene, pcfg)
        _, _, state = fn(scene, _moving_camera(host, fw, fh, 0, dev), pcfg,
                         rc, state)                         # warm-up
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        for f in range(1, 1 + n_frames):
            img, hdr, state = fn(scene, _moving_camera(host, fw, fh, f, dev),
                                 pcfg, rc, state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(kernels.launches)
        launches[name] = counts
        r = dict(size=f"{fw}x{fh}", frames=n_frames,
                 ms_per_frame=dt / n_frames * 1e3, launches=counts,
                 finite=bool(torch.isfinite(hdr).all()),
                 hdr_mean=float(hdr.mean()),
                 motion_px=float(state.motion.abs().mean())
                 if state.motion is not None else 0.0)
        if fn is realtime.render_frame_stable_planes:
            cam = _moving_camera(host, fw, fh, n_frames, dev)
            px, py = _pixel_grid(fw, fh, dev)
            o, d, _ = camera_rays(cam, pcfg, px, py, state.frame_index)
            if name == "city_planes":
                # the BUILD walk's first K9 launches held to the plain walk
                (pls, _), r["k9_audit"], k9_ok = _k9_audit(
                    f"realtime {name}", lambda: decompose(scene, o, d))
                if not k9_ok:
                    failed.append(f"{name}: K9 disagrees with its plain "
                                  f"version")
            else:
                # the BUILD pass's K8 launches of depths 0 and 2 held to
                # the plain version on every lane, and timed
                (pls, _), r["k8_audit"], k8_ok = _k8_audit(
                    f"realtime {name}", lambda: decompose(scene, o, d),
                    keep=(0, 2))
                if not k8_ok:
                    failed.append(f"{name}: K8 disagrees with its plain "
                                  f"version")
            r["plane_valid_share"] = [float(p.valid.float().mean())
                                      for p in pls]
            r["k1_inject_per_frame"] = sum(
                v for k, v in counts.items()
                if k.startswith("bounce_fused_inj")) / n_frames
            r["k1_per_frame"] = sum(
                v for k, v in counts.items()
                if k.startswith("bounce_fused")) / n_frames
            if name == "glass_planes":
                prof_args = (host, scene, pcfg, rc, state, n_frames + 1)
        if name == "city":
            # the clustered tier's overflow of the last frame's trace
            out = render_sample(scene, _moving_camera(host, fw, fh,
                                                      n_frames, dev),
                                pcfg, fw, fh, state.frame_index - 1,
                                want_aux=True)
            r["cull_overflow"] = int(out["cull_overflow"])
        frames[name] = r
        print(f"realtime {name} {fw}x{fh}: {r['ms_per_frame']:.1f} ms per "
              f"frame over {n_frames} frames, mean motion "
              f"{r['motion_px']:.3f} px, launches {counts}"
              + (f", K1 inject {r['k1_inject_per_frame']:.0f} and K1 "
                 f"{r['k1_per_frame']:.0f} per frame, plane valid shares "
                 f"{[round(x, 4) for x in r['plane_valid_share']]}"
                 if "plane_valid_share" in r else "")
              + (f", cull_overflow {r['cull_overflow']}"
                 if "cull_overflow" in r else "")
              + f" ({smi})", flush=True)
        if not r["finite"] or not counts:
            failed.append(f"path {name}")
    rec["paths"] = frames
    dump()
    # what each path must have launched
    need = dict(cornell=("bounce_fused",), cornell_split=(
        "bounce_fused_split",), cornell_half=("bounce_fused",),
        glass_planes=("bounce_fused_inj", "bounce_fused", "brute_closest"),
        city=("cluster_closest", "cluster_shade", "cluster_shadow"),
        city_planes=("bvh_traverse",))
    for name, names in need.items():
        for k in names:
            if not launches[name].get(k):
                failed.append(f"{name}: {k} not launched")
    if frames["glass_planes"]["k1_inject_per_frame"] != 3:
        failed.append("glass_planes: K1 inject not once per plane")

    # one profiled stable-planes frame
    host, scene, pcfg, rc, state, f = prof_args
    cam = _moving_camera(host, w, h, f, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        realtime.render_frame_stable_planes(scene, cam, pcfg, rc, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split, table = _split(prof, wall, ("build", "fill", "denoise", "taa"),
                          (("k1", "bounce_fused_kernel"),))
    split["other"] = split["device_busy"] - sum(
        split[k] for k in ("build", "fill", "denoise", "taa"))
    rec["split"], rec["profile_table"] = split, table
    print(f"realtime glass_planes split (one profiled frame, ms): "
          f"{json.dumps({k: v for k, v in split.items() if k != 'spans'})} "
          f"({smi})", flush=True)

    # ---- (c) correctness ----
    cw, ch, nfr = RT_COMPOSITE
    ccfg = dc.replace(cfg, firefly_clamp=0.5)
    cam = default_camera(ghost, cw, ch, device=dev)
    rc = RenderConfig(width=cw, height=ch, denoiser=DenoiserMode.NONE,
                      tonemap="none")
    state = realtime.init_state(ch, cw, glass, ccfg)
    acc = None
    for _ in range(nfr):
        _, hdr, state = realtime.render_frame_stable_planes(glass, cam, ccfg,
                                                             rc, state)
        acc = hdr if acc is None else acc + hdr
    ref, _, _ = render(glass, cam, ccfg, cw, ch, spp=nfr)
    comp_rmse = float(((acc / nfr - ref) ** 2).mean().sqrt())
    px, py = _pixel_grid(cw, ch, dev)
    o, d, _ = camera_rays(cam, ccfg, px, py, 0)
    p1 = int(decompose(glass, o, d)[0][1].valid.sum())
    rec["composite"] = dict(rmse=comp_rmse, plane1_pixels=p1, frames=nfr,
                            size=f"{cw}x{ch}")
    print(f"realtime composite: glass-over-mirror {cw}x{ch}, {nfr} frames "
          f"against render at {nfr} spp: RMSE {comp_rmse:.5f} (limit "
          f"{RT_COMPOSITE_RMSE}); plane 1 valid on {p1} pixels", flush=True)
    if not comp_rmse < RT_COMPOSITE_RMSE or p1 <= 0:
        failed.append("composite")

    cam = default_camera(chost, w, h, device=dev)
    rc = RenderConfig(width=w, height=h, denoiser=relax, tonemap="none")
    state = realtime.init_state(h, w, cornell, cfg)
    for _ in range(4):
        _, den, state = realtime.render_frame(cornell, cam, cfg, rc, state)
    raw, _, _ = render(cornell, cam, cfg, w, h, spp=1, first_sample=7)
    ref, _, _ = render(cornell, cam, cfg, w, h, spp=RT_REF_SPP,
                       first_sample=1000)

    def roughness(img):
        img = torch.clamp(img, 0.0, 1.0)
        lap = (4 * img[1:-1, 1:-1] - img[:-2, 1:-1] - img[2:, 1:-1]
               - img[1:-1, :-2] - img[1:-1, 2:])
        return float(lap.abs().mean())

    def rmse_to_ref(img):
        return float(((img - ref) ** 2).mean().sqrt())

    dq = dict(rough_denoised=roughness(den), rough_raw=roughness(raw),
              mean_ratio=float(den.mean()) / float(raw.mean()),
              rmse_denoised=rmse_to_ref(den), rmse_raw=rmse_to_ref(raw),
              ref_spp=RT_REF_SPP)
    rec["denoiser"] = dq
    print(f"realtime denoiser: Cornell {w}x{h} after 4 RELAX frames: "
          f"roughness {dq['rough_denoised']:.5f} against the raw 1-spp "
          f"frame's {dq['rough_raw']:.5f} (limit 0.35x), mean ratio "
          f"{dq['mean_ratio']:.4f}; RMSE against {RT_REF_SPP} spp "
          f"{dq['rmse_denoised']:.5f} against the raw frame's "
          f"{dq['rmse_raw']:.5f}", flush=True)
    if not (dq["rough_denoised"] < 0.35 * dq["rough_raw"]
            and 0.5 < dq["mean_ratio"] < 2.0
            and dq["rmse_denoised"] < dq["rmse_raw"]):
        failed.append("denoiser")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"realtime: phase 18 in {rec['seconds']:.1f}s", flush=True)
    dump()
    if failed:
        _fail(f"realtime: {failed}")
    n_inj = launches["glass_planes"].get("bounce_fused_inj", 0)
    entries = dict(bounce_fused_inj=dict(
        name="bounce_fused_inj", route="cuda",
        source="rtxpt_tpu_torch/csrc/bounce_fused_restart.cu",
        replaces="rtxpt_tpu/pt/bounce_pallas.py:1389",
        launches=n_inj, launches_by_path={"glass_planes": n_inj},
        max_abs_err=err, ms=ms_inj, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, ms_k1_same_rays=ms_k1,
        lanes_bit_exact=min(v["lanes_bit_exact"] for v in k1.values()),
        instantiations_bit_exact=n_exact, first_direct=False,
        ptxas=rec["ptxas"]))
    return dict(entries=entries, launches=launches,
                k8_build=frames["glass_planes"].get("k8_audit", []))


PROBE_K10_SIZES = ((64, 8), (64, 64))   # phase 19: K10 compared at the
#                                        script's CPU size and at 64 groups
PROBE_K11_GROUPS = (32, 2048)  # K11 compared and timed at the script's 32
#                                groups, timed at 2,048 (K10's 32,768 visits)
PROBE_BMM_VISITS = 2048        # visits per torch.bmm of K10's products
# Operations per (ray, triangle) pair of the probes. K10: four quantities of
# 16 multiplies and 15 adds, 3 adds, 1 minimum (f32 on the CUDA cores: the
# TPU kernel's HIGHEST precision). K11: four quantities of 30 split-bf16
# products, each a multiply and an add, counted at the bf16 tensor-core
# rate; its f32 selection: the sign (2), four scalings, the margin and its
# negation, five comparisons, u + v, two margin adds, four ands, the clamp,
# the division, the select, the minimum and the first-index search (3).
K10_PAIR_F32 = 128
K11_PAIR_BF16 = 4 * 30 * 2
K11_PAIR_F32 = 27
K12_MM_F32 = 1                 # the maximum's comparison per product


def _probes(record, dev, smi, dump):
    """Phase 19: the probes K10-K12 (rtxpt_tpu_torch/probes). (a) Each
    probe's entry point main() on the card, the launch counts set to 0
    before and read after: each must exit 0 and launch its kernels. (b) K10
    against its plain version, all 8 rows, at 64 clusters x 8 and x 64
    groups (counts from 0 to 16) and at the script's timed size (2,344
    clusters, 2,048 groups of 16 full slots): equal; timed there with the
    script's line, its bound and registers, and torch.bmm of its gathered
    products (products only, TF32 off and on). (c) K11 against its plain
    version at 32 groups (the script's rays and rays aimed at the probe's
    triangles) and 2,048 groups, t and prim equal, the script's brute-force
    check on its sampled lanes and on every lane of groups 0-1 against the
    triangles the probe intersects (local_tris; the aimed rays with the
    kernel's margins); timed at 32 and 2,048 groups. (d) The seven K12
    constructs against their plain versions, equal, each timed, with the
    one library call that computes a construct where there is one. (e)
    ns per visit (1,024 rays x 128 triangles) of K10, K11 and K3 at the
    city's 1080p bounce-0 launch (phase 6). Returns dict(entries)."""
    import numpy as np
    import torch

    from rtxpt_tpu_torch import kernels
    from rtxpt_tpu_torch.probes import micro_cluster_kernel as K10
    from rtxpt_tpu_torch.probes import micro_constructs as K12
    from rtxpt_tpu_torch.probes import micro_flat_kernel as K11

    t_phase = time.perf_counter()
    rec = {}
    failed = []

    def to_dev(arrays, keys):
        return {k: torch.from_numpy(arrays[k]).to(dev) for k in keys}

    # (a) the entry points
    kernels.launches.clear()
    rcs = {m.__name__.rsplit(".", 1)[1]: m.main([]) for m in (K10, K11, K12)}
    launches = dict(kernels.launches)
    names = ["probe_cluster", "probe_flat"] + [
        f"probe_constructs_{n}" for n in K12.CONSTRUCTS]
    missing = [n for n in names if not launches.get(n)]
    rec["entry_points"] = dict(exit_codes=rcs, launches=launches)
    print(f"probes: entry points exit {rcs}, launches {launches}", flush=True)
    if any(rcs.values()) or missing:
        failed.append(f"entry points (exit codes {rcs}, not launched "
                      f"{missing})")

    # (b) K10
    k10_keys = ("counts", "cands", "cols", "tris")
    k10_err, k10_cmp = 0.0, {}
    for c, g in PROBE_K10_SIZES:
        arrays = K10.inputs(0, c, g)
        arrays["counts"][-1] = 0
        ops = to_dev(arrays, k10_keys)
        kern = K10.run(**ops, all_rows=True)
        plain = K10.cluster_reference(**ops)
        err = float((kern - plain).abs().max())
        k10_err = max(k10_err, err)
        k10_cmp[f"{c}x{g}"] = dict(
            equal=bool(torch.equal(kern, plain)), max_abs_err=err,
            counts=sorted(set(arrays["counts"].tolist())))
        print(f"probes k10 {c} clusters x {g} groups: all 8 rows equal "
              f"{k10_cmp[f'{c}x{g}']['equal']}, max abs err {err:.3g}",
              flush=True)
        if not k10_cmp[f"{c}x{g}"]["equal"]:
            failed.append(f"k10 at {c}x{g}")
    small = to_dev(K10.inputs(0, *PROBE_K10_SIZES[0]), k10_keys)
    k10_plain_ms = _cuda_ms(lambda: K10.cluster_reference(**small), 1)
    timed = to_dev(K10.inputs(0, timed=K10.TIMED), k10_keys)
    # the timed size too: the shapes the probe's time is taken at
    kern = K10.run(**timed, all_rows=True)
    plain, k10_plain_timed_ms = _once_ms(
        lambda: K10.cluster_reference(**timed))
    err = float((kern - plain).abs().max())
    k10_err = max(k10_err, err)
    k10_cmp["x".join(map(str, K10.TIMED))] = dict(
        equal=bool(torch.equal(kern, plain)), max_abs_err=err, counts=[16])
    print(f"probes k10 {K10.TIMED[0]} clusters x {K10.TIMED[1]} groups "
          f"(timed size): all 8 rows equal {torch.equal(kern, plain)}, max "
          f"abs err {err:.3g}", flush=True)
    if not torch.equal(kern, plain):
        failed.append("k10 at the timed size")
    del kern, plain
    k10_ms = _cuda_ms(lambda: K10.run(**timed), 5)
    n_g = K10.TIMED[1]
    k10_visits = int(torch.clamp(timed["counts"], 0, K10.KSLOTS).sum())
    pairs = k10_visits * 1024 * 128
    blocks_read = int(torch.unique(timed["cands"]).numel())
    k10_bytes = 4 * (n_g + timed["cands"].numel() + timed["cols"].numel()
                     + n_g * 128) + blocks_read * 16 * 512 * 4
    k10_bound = _bound(k10_bytes, f32=pairs * K10_PAIR_F32)
    k10_tf32_ms = pairs * K10_PAIR_F32 / TF32_FLOPS_PER_S * 1e3
    k10_ptxas = _ptxas_summary(kernels.PROBE_CLUSTER.ptxas_log)
    dt = k10_ms / 1e3
    print(f"probes k10 timed: {k10_ms:.2f} ms, {k10_visits} visits, "
          f"{k10_visits/dt/1e6:.2f} Mvisits/s, "
          f"{k10_visits*128*128/dt/1e9:.1f} G ray-tri/s (the script's "
          f"count: row 0's 128 rays per visit; all 8 rows: "
          f"{pairs/dt/1e9:.1f} G); plain {k10_plain_timed_ms:.1f} ms "
          f"(one call; {k10_plain_ms:.3f} ms at {PROBE_K10_SIZES[0][1]} "
          f"groups); bound {k10_bound[0]:.4f} ms "
          f"({k10_bound[1]}; f32 {k10_bound[2]['f32']:.4f}, at the TF32 "
          f"rate {k10_tf32_ms:.4f}); {k10_ptxas['registers']} registers, "
          f"spills {k10_ptxas['spill_store_bytes']}/"
          f"{k10_ptxas['spill_load_bytes']} B ({smi})", flush=True)
    # torch.bmm of the gathered products, in PROBE_BMM_VISITS-visit calls
    # into one output buffer: the products only, not the function
    gathered = timed["tris"][timed["cands"].reshape(-1).long()]
    a = timed["cols"].permute(0, 2, 1).reshape(1024, 16)
    nb = PROBE_BMM_VISITS
    a_b = a.expand(nb, 1024, 16).contiguous()
    prod = torch.empty((nb, 1024, 512), dtype=torch.float32, device=dev)

    def products():
        for i in range(0, gathered.shape[0], nb):
            torch.bmm(a_b, gathered[i:i + nb], out=prod)
    bmm = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            bmm["tf32" if tf32 else "f32"] = _cuda_ms(products, 2)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    del gathered, prod
    bmm_bytes = pairs * 4 * 4
    print(f"probes k10 products only, not the function: torch.bmm of the "
          f"{k10_visits} visits' [1024, 16] x [16, 512] products in calls of "
          f"{nb}: {bmm['f32']:.3f} ms with TF32 off, {bmm['tf32']:.3f} ms "
          f"with TF32 on (they write {bmm_bytes / 1e9:.1f} GB of products, "
          f"{bmm_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at the memory rate) "
          f"({smi})", flush=True)
    rec["k10"] = dict(compare=k10_cmp, ms=k10_ms,
                      plain_ms=k10_plain_timed_ms,
                      plain_ms_8_groups=k10_plain_ms,
                      visits=k10_visits, pairs=pairs, bytes=k10_bytes,
                      bound=k10_bound, tf32_ms=k10_tf32_ms, ptxas=k10_ptxas,
                      bmm_ms=bmm, bmm_bytes=bmm_bytes, card=smi)
    dump()

    # (c) K11
    k11_keys = ("cand", "od", "blocks")
    g_cmp, g_big = PROBE_K11_GROUPS
    arrays = K11.inputs(0, g_cmp)
    ops = to_dev(arrays, k11_keys)
    kern = K11.run(**ops)
    plain = K11.flat_reference(**ops)
    k11_err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
    k11_equal = all(torch.equal(k, p) for k, p in zip(kern, plain))
    t_host = kern[0].cpu().numpy()
    cand, od = arrays["cand"], arrays["od"]
    script_hits = K11.brute_force(cand, od, arrays["tris"])
    script_bad = K11.check(t_host, script_hits)
    local_hits = K11.brute_force(cand, od, K11.local_tris(arrays),
                                 lane_step=1)
    local_bad = K11.check(t_host, local_hits)
    hit_share = float((kern[0] < K11.BIG).float().mean())
    print(f"probes k11 {g_cmp} groups: t and prim equal {k11_equal}, max "
          f"abs err {k11_err:.3g}, hit share {hit_share:.5f}; the script's "
          f"check {len(script_hits)} hits on its sampled lanes, "
          f"{len(script_bad)} off; every lane of groups 0-1 against the "
          f"local triangles {len(local_hits)} hits, {len(local_bad)} off "
          f"(limit {K11.TOL_T} x max(1, t))", flush=True)
    od_aim = torch.from_numpy(K11.aimed_rays(arrays)).to(dev)
    kern_aim = K11.run(ops["cand"], od_aim, ops["blocks"])
    plain_aim = K11.flat_reference(ops["cand"], od_aim, ops["blocks"])
    aim_equal = all(torch.equal(k, p) for k, p in zip(kern_aim, plain_aim))
    k11_err = max([k11_err] + [float((k - p).abs().max())
                               for k, p in zip(kern_aim, plain_aim)])
    aim_hits, aim_bad = K11.aimed_check(kern_aim[0].cpu().numpy(), arrays,
                                        od_aim.cpu().numpy())
    aim_share = float((kern_aim[0] < K11.BIG).float().mean())
    print(f"probes k11 {g_cmp} groups, rays aimed at the local triangles: t "
          f"and prim equal {aim_equal}, hit share {aim_share:.5f}; every lane "
          f"of groups 0-1 against the local triangles (the kernel's margins "
          f"+- {K11.MARGIN_SLACK}) {aim_hits} hits, {len(aim_bad)} off",
          flush=True)
    if (not k11_equal or script_bad or local_bad or not aim_equal
            or aim_bad):
        failed.append("k11")
    k11_plain_ms = _cuda_ms(lambda: K11.flat_reference(**ops), 1)
    k11 = {}
    for g in PROBE_K11_GROUPS:
        arr = arrays if g == g_cmp else K11.inputs(0, g)
        o_g = to_dev(arr, k11_keys)
        if g != g_cmp:
            # the timed size too: the shapes the probe's time is taken at
            kern = K11.run(**o_g)
            plain, k11_plain_big_ms = _once_ms(
                lambda: K11.flat_reference(**o_g))
            equal = all(torch.equal(k, p) for k, p in zip(kern, plain))
            err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
            k11_err = max(k11_err, err)
            k11_equal = k11_equal and equal
            print(f"probes k11 {g} groups (timed size): t and prim equal "
                  f"{equal}, max abs err {err:.3g}; plain "
                  f"{k11_plain_big_ms:.1f} ms (one call)", flush=True)
            if not equal:
                failed.append(f"k11 at {g} groups")
            del kern, plain
        ms = _cuda_ms(lambda: K11.run(**o_g), 20 if g == g_cmp else 5)
        visits = int(torch.clamp(o_g["cand"][:, 0, 0], 0, K11.KSLOTS).sum())
        pairs_g = visits * K11.FLAT * 128
        blocks_read = int(torch.unique(o_g["cand"][:, 0, 1:]).numel())
        nbytes = 4 * (o_g["cand"].numel() + o_g["od"].numel()
                      + 2 * g * K11.FLAT) + blocks_read * 20 * 512 * 4
        bound = _bound(nbytes, f32=pairs_g * K11_PAIR_F32,
                       bf16=pairs_g * K11_PAIR_BF16)
        k11[g] = dict(ms=ms, visits=visits, pairs=pairs_g, bytes=nbytes,
                      bound=bound, ns_per_visit=ms * 1e6 / visits)
        print(f"probes k11 timed: {ms:.3f} ms for {g} groups x "
              f"{K11.KSLOTS} visits ({ms * 1e6 / visits:.0f} ns/visit, all "
              f"1024 rays); bound {bound[0]:.4f} ms ({bound[1]}; bf16 "
              f"products {bound[2]['bf16']:.4f}, f32 selection "
              f"{bound[2]['f32']:.4f})", flush=True)
    k11_ptxas = _ptxas_summary(kernels.PROBE_FLAT.ptxas_log)
    print(f"probes k11: plain {k11_plain_ms:.3f} ms at {g_cmp} groups; "
          f"{k11_ptxas['registers']} registers, spills "
          f"{k11_ptxas['spill_store_bytes']}/{k11_ptxas['spill_load_bytes']}"
          f" B ({smi})", flush=True)
    rec["k11"] = dict(equal=k11_equal, max_abs_err=k11_err,
                      hit_share=hit_share,
                      script_check=dict(hits=len(script_hits),
                                        off=len(script_bad)),
                      local_check=dict(hits=len(local_hits),
                                       off=len(local_bad)),
                      aimed=dict(equal=aim_equal, hit_share=aim_share,
                                 hits=aim_hits, off=len(aim_bad)),
                      timed={str(g): v for g, v in k11.items()},
                      plain_ms=k11_plain_big_ms,
                      plain_ms_32_groups=k11_plain_ms, ptxas=k11_ptxas,
                      card=smi)
    dump()

    # (d) K12: each construct's device time per launch from the profiler
    # (a wrapper call takes longer on the host than these kernels on the
    # card, so CUDA events around a run of calls time the host), its call
    # time from CUDA events beside it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, kernel, iters=50):
        """Device time per call of fn: its kernels whose name holds
        `kernel` (every kernel it launches with None)."""
        fn()
        torch.cuda.synchronize()
        # profile again when the first profile records no kernel (the
        # first one of this phase did so once, after the profiles of
        # earlier phases in the same process)
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            total, count = 0.0, 0
            for evt in prof.key_averages():
                if evt.device_type == DeviceType.CUDA and (
                        kernel is None or kernel in evt.key):
                    total += getattr(evt, "self_device_time_total",
                                     getattr(evt, "self_cuda_time_total",
                                             0.0))
                    count += evt.count
            if count:
                return total / 1e3 / (count if kernel else iters)
        return None

    xb = to_dev(K12.inputs(0), ("x", "b"))
    # one PyTorch call that computes the construct, where there is one (the
    # [8] twos and the [8, 8] ones are made once, as weights would be):
    # tile8's eight doubled tiles are an outer product, unflat's summed and
    # repeated rows a product with ones, subl_concat one sum. The others
    # have none: mm_concat_* is three products, a maximum and a repeat,
    # scratch32 a comparison and a select, iota_sel an argmin, a one-hot
    # product and a maximum.
    twos = torch.full((8,), 2.0, device=dev)
    ones = torch.ones((8, 8), device=dev)
    library = dict(
        tile8=lambda x, b: torch.outer(twos, x[0, 0:128]),
        subl_concat=lambda x, b: torch.sum(x[0:K12.KC], 0, keepdim=True),
        unflat=lambda x, b: torch.mm(ones, x[0].view(8, 128)))
    k12 = {}
    for name in K12.CONSTRUCTS:
        kern = K12.run(name, **xb)
        plain = K12.construct_reference(name, **xb)
        equal = bool(torch.equal(kern, plain))
        err = float((kern - plain).abs().max())
        call_ms = _cuda_ms(lambda: K12.run(name, **xb), 200)
        kname = ("mm_concat" if name.startswith("mm_concat") else name)
        dev_ms = device_ms(lambda: K12.run(name, **xb), f"{kname}_kernel")
        ms = dev_ms if dev_ms is not None else call_ms
        plain_ms = _cuda_ms(lambda: K12.construct_reference(name, **xb), 20)
        lib_ms = lib_err = None
        if name in library:
            torch.backends.cuda.matmul.allow_tf32 = False
            lib = library[name](**xb).reshape(1, 1024)
            lib_err = float((lib - plain).abs().max())
            lib_ms = device_ms(lambda: library[name](**xb), None)
            if lib_ms is None:
                lib_ms = _cuda_ms(lambda: library[name](**xb), 200)
        # bytes: the rows of x and b the construct reads, its output
        n = 256 if name == "mm_concat_256" else 1024
        read = dict(tile8=128, subl_concat=10 * 1024,
                    mm_concat_256=10 * 256 + 20 * 512,
                    mm_concat_1024=10 * 1024 + 20 * 512)
        nbytes = 4 * (read.get(name, 1024) + 1024)
        mm_pairs = 512 * n if name.startswith("mm_concat") else 0
        bound = _bound(nbytes, f32=mm_pairs * K12_MM_F32,
                       bf16=mm_pairs * 30 * 2)
        k12[name] = dict(equal=equal, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound=bound, library_ms=lib_ms,
                         library_max_abs_err=lib_err)
        dev_txt = (f"{dev_ms * 1e3:.2f} us on the card" if dev_ms is not None
                   else "device time not measured")
        lib_txt = (f"library call {lib_ms * 1e3:.2f} us (max abs diff "
                   f"{lib_err:.3g})" if lib_ms is not None
                   else "no library call")
        print(f"probes k12 {name}: equal {equal}, kernel {dev_txt}, "
              f"{call_ms * 1e3:.2f} us per call, plain "
              f"{plain_ms * 1e3:.1f} us, {lib_txt}, bound "
              f"{bound[0] * 1e3:.4f} us ({bound[1]}) ({smi})", flush=True)
        if not equal:
            failed.append(f"k12 {name}")
    k12_ptxas = _ptxas_summary(kernels.PROBE_CONSTRUCTS.ptxas_log)
    rec["k12"] = dict(constructs=k12, ptxas=k12_ptxas, card=smi)

    # (e) beside K3 at the city's 1080p bounce-0 launch (phase 6)
    k3 = record.get("clustered", {})
    k3_ms = k3.get("ms", {}).get("cluster_closest")
    k3_visits = k3.get("launch", {}).get("visits")
    per_visit = dict(k10=k10_ms * 1e6 / k10_visits,
                     k11=k11[g_big]["ns_per_visit"],
                     k3=(k3_ms * 1e6 / k3_visits if k3_ms and k3_visits
                         else None))
    rec["ns_per_visit"] = dict(per_visit, k3_ms=k3_ms, k3_visits=k3_visits)
    k3_txt = (f"{per_visit['k3']:.0f} ({k3_ms:.3f} ms over {k3_visits} "
              f"visits)" if per_visit["k3"] else "not measured")
    print(f"probes beside K3: ns per visit (1,024 rays x 128 triangles): "
          f"K10 {per_visit['k10']:.0f}, K11 {per_visit['k11']:.0f} "
          f"({g_big} groups), K3 {k3_txt} at the city's 1080p bounce-0 "
          f"launch ({smi})", flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    record["probes"] = rec
    print(f"probes: phase 19 in {rec['seconds']:.1f}s", flush=True)
    dump()
    if failed:
        _fail(f"probes: {failed}")

    entries = {}

    def entry(name, source, replaces, err, ms, plain_ms, bound,
              library_ms=None, **extra):
        entries[name] = dict(
            name=name, route="cuda", source=f"rtxpt_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches.get(name, 0),
            launches_by_path={"probes": launches.get(name, 0)},
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=library_ms, **extra)
    entry("probe_cluster", "probe_cluster.cu",
          "scripts/micro_cluster_kernel.py:36", k10_err, k10_ms,
          k10_plain_timed_ms, k10_bound, bmm_products_only_ms=bmm,
          plain_ms_8_groups=k10_plain_ms, ns_per_visit=per_visit["k10"])
    entry("probe_flat", "probe_flat.cu", "scripts/micro_flat_kernel.py:47",
          k11_err, k11[g_big]["ms"], k11_plain_big_ms, k11[g_big]["bound"],
          ms_32_groups=k11[g_cmp]["ms"], plain_ms_32_groups=k11_plain_ms,
          ns_per_visit=per_visit["k11"])
    for name, v in k12.items():
        entry(f"probe_constructs_{name}", "probe_constructs.cu",
              "scripts/micro_constructs.py:32", v["max_abs_err"], v["ms"],
              v["plain_ms"], v["bound"], library_ms=v["library_ms"],
              device_ms=v["device_ms"], call_ms=v["call_ms"])
    return dict(entries=entries)


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
    parser.add_argument("--diverged-group", metavar="PATH",
                        help="save the city's 1080p bounce-0 ray groups whose "
                        "K6 winners differ most from K3's as .npz at PATH "
                        "(for tools/replay_diverged_group.py)")
    args = parser.parse_args()
    try:
        main(args.record, args.diverged_group)
    except Exception:
        traceback.print_exc()
        _fail("an exception ended the run")

"""K12, the seven construct probes (counterpart of scripts/micro_constructs.py).

The JAX package bisected which construct of its all-rows clustered kernel
wedged the TPU compiler, one small Pallas kernel per construct, each a
function of x [16, 1024] and b [32, 512] (f32) to o [1, 1024]:

    tile8           a [1, 128] tile repeated 8 times along the lanes, x 2
    subl_concat     rows 0..9 of x stacked and summed
    mm_concat_256   the split-bf16 product of b's rows 0..19 with x's rows
    mm_concat_1024  0..9 over the first 256 / 1024 lanes ([512, n]), its
                    maximum over the 512 columns, tiled to 1024 lanes
    unflat          x[0] as [8, 128] rows, summed over the rows, tiled
    scratch32       a [32, 1024] scratch filled with x[0], doubled where
                    x[0] > 0.5; its row 0
    iota_sel        the first row reaching the minimum of x[0] broadcast to
                    [128, 1024], its one-hot [27, 128] x [128, 1024] product
                    with x[0, 0:128], the maximum over the 27 rows

`run(name, x, b)` launches the construct's kernel (csrc/probe_constructs.cu)
on CUDA tensors and runs the plain version `construct_reference` on CPU
tensors; both sum in the same order, so they agree bit for bit on the card.
The script's subprocess-and-timeout harness, which only survived compiler
wedges on the TPU, is not ported:

    python -m rtxpt_tpu_torch.probes.micro_constructs [NAME ...] [--device cpu]

runs each construct in this process, holds it against a float64 evaluation
of the same function (limits in LIMITS; on the card also against the plain
version, bit for bit) and prints `name: OK` or fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.probes import one_device
from rtxpt_tpu_torch.probes.micro_flat_kernel import bf16_round_np, bf16_split

CONSTRUCTS = ("tile8", "subl_concat", "mm_concat_256", "mm_concat_1024",
              "unflat", "scratch32", "iota_sel")
LANES = 1024
KC = 10
# rtol = atol of each construct against its float64 evaluation; 0: equal
LIMITS = dict(tile8=0.0, subl_concat=1e-6, mm_concat_256=1e-5,
              mm_concat_1024=1e-5, unflat=1e-6, scratch32=0.0, iota_sel=0.0)


def inputs(seed=0):
    """x [16, 1024] and b [32, 512], uniform in [0, 1) as f32 (the
    script's: generators seeded `seed` and `seed + 1`)."""
    x = np.random.default_rng(seed).uniform(0, 1, (16, 1024)).astype(
        np.float32)
    b = np.random.default_rng(seed + 1).uniform(0, 1, (32, 512)).astype(
        np.float32)
    return dict(x=x, b=b)


def _width(name):
    return 256 if name == "mm_concat_256" else LANES


def _seq_sum(rows):
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    return s


def construct_reference(name, x, b):
    """The plain version of construct `name`: o [1, 1024] f32."""
    if name == "tile8":
        return x[0:1, 0:128].repeat(1, 8) * 2.0
    if name == "subl_concat":
        return _seq_sum([x[i:i + 1] for i in range(KC)])
    if name in ("mm_concat_256", "mm_concat_1024"):
        n = _width(name)
        r_hi, r_lo = bf16_split(x[0:KC, 0:n])
        chi, clo = b[0:KC, :, None], b[KC:2 * KC, :, None]    # [10, 512, 1]
        terms = ([chi[k] * r_hi[k] for k in range(KC)]
                 + [chi[k] * r_lo[k] for k in range(KC)]
                 + [clo[k] * r_hi[k] for k in range(KC)])
        m = torch.amax(_seq_sum(terms), dim=0, keepdim=True)   # [1, n]
        return m.repeat(1, LANES // n)
    if name == "unflat":
        s = _seq_sum([x[0:1, r * 128:(r + 1) * 128] for r in range(8)])
        return s.repeat(1, 8)
    if name == "scratch32":
        scr = torch.zeros((32, LANES), dtype=x.dtype, device=x.device) \
            + x[0:1]
        scr = torch.where(x[0:1] > 0.5, scr * 2.0, scr)
        return scr[0:1]
    if name == "iota_sel":
        t_m = x[0:1].expand(128, LANES)
        t_c = torch.amin(t_m, dim=0, keepdim=True)
        iota = torch.arange(128, device=x.device)[:, None]
        jrow = torch.amin(torch.where(t_m <= t_c, iota, 128), dim=0,
                          keepdim=True)
        sel = (iota == jrow).to(torch.float32)               # [128, 1024]
        amat = x[0:1, 0:128].expand(27, 128)
        attr = _seq_sum([amat[:, j:j + 1] * sel[j:j + 1] for j in range(128)])
        return torch.amax(attr, dim=0, keepdim=True)
    raise ValueError(f"unknown construct {name!r}; one of {CONSTRUCTS}")


def construct64(name, x, b):
    """Construct `name` evaluated in float64 with numpy: o [1, 1024]."""
    x64 = x.astype(np.float64)
    if name == "tile8":
        return np.tile(2.0 * x64[0:1, 0:128], (1, 8))
    if name == "subl_concat":
        return x64[0:KC].sum(0, keepdims=True)
    if name in ("mm_concat_256", "mm_concat_1024"):
        n = _width(name)
        hi = bf16_round_np(x[0:KC, 0:n]).astype(np.float64)
        lo = x64[0:KC, 0:n] - hi
        b64 = b.astype(np.float64)
        prod = b64[0:KC].T @ hi + b64[0:KC].T @ lo + b64[KC:2 * KC].T @ hi
        return np.tile(prod.max(0, keepdims=True), (1, LANES // n))
    if name == "unflat":
        return np.tile(x64[0].reshape(8, 128).sum(0, keepdims=True), (1, 8))
    if name == "scratch32":
        return np.where(x64[0:1] > 0.5, 2.0 * x64[0:1], x64[0:1])
    if name == "iota_sel":
        # every row of the broadcast reaches the column minimum, so row 0
        # is selected, and the product picks x[0, 0] in each of 27 rows
        return np.full((1, LANES), x64[0, 0])
    raise ValueError(f"unknown construct {name!r}; one of {CONSTRUCTS}")


def run(name, x, b):
    """Construct `name` over x [16, 1024] and b [32, 512] f32: o [1, 1024]
    f32. CUDA tensors launch its kernel (counted as
    "probe_constructs_<name>"), CPU tensors run the plain version; operands
    on two devices, and build or launch errors, raise."""
    if name not in CONSTRUCTS:
        raise ValueError(f"unknown construct {name!r}; one of {CONSTRUCTS}")
    dev = one_device("micro_constructs.run", x=x, b=b)
    if dev.type == "cpu":
        return construct_reference(name, x, b)
    if dev.type != "cuda":
        raise ValueError(f"micro_constructs.run: no kernel for {dev}")
    kernels.check_tensor("x", x, torch.float32, (16, LANES), dev)
    kernels.check_tensor("b", b, torch.float32, (32, 512), dev)
    o = torch.empty((1, LANES), dtype=torch.float32, device=dev)
    lib = kernels.PROBE_CONSTRUCTS
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (x.data_ptr(), b.data_ptr())
        if name.startswith("mm_concat"):
            lib.launch("rtxpt_probe_mm_concat", *args, o.data_ptr(),
                       _width(name), stream)
        elif name == "scratch32":
            scratch = torch.empty((32, LANES), dtype=torch.float32,
                                  device=dev)
            lib.launch("rtxpt_probe_scratch32", *args, scratch.data_ptr(),
                       o.data_ptr(), stream)
        elif name == "iota_sel":
            # the broadcasts' row strides: x[0] to [128, 1024], x[0, 0:128]
            # to [27, 128]
            lib.launch("rtxpt_probe_iota_sel", *args, o.data_ptr(), 0, 0,
                       stream)
        else:
            lib.launch(f"rtxpt_probe_{name}", *args, o.data_ptr(), stream)
    kernels.launches[f"probe_constructs_{name}"] += 1
    return o


def main(argv=None) -> int:
    import rtxpt_tpu_torch

    ap = argparse.ArgumentParser(description="K12, the construct probes")
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"constructs to run (default: all of {CONSTRUCTS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain "
                    "versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = rtxpt_tpu_torch.device(args.device)
    arrays = inputs(args.seed)
    x, b = (torch.from_numpy(arrays[k]).to(dev) for k in ("x", "b"))
    for name in args.names or CONSTRUCTS:
        if name not in CONSTRUCTS:
            print(f"{name}: FAIL unknown construct; one of {CONSTRUCTS}")
            return 1
        y = run(name, x, b)
        got = y.cpu().numpy().astype(np.float64)
        want = construct64(name, arrays["x"], arrays["b"])
        lim = LIMITS[name]
        why = []
        if not np.isfinite(got).all():
            why.append("non-finite values")
        if not np.allclose(got, want, rtol=lim, atol=lim):
            why.append(f"max |err| {np.abs(got - want).max():.3g} against "
                       f"float64, limit rtol = atol = {lim}")
        if dev.type == "cuda" and not torch.equal(
                y, construct_reference(name, x, b)):
            why.append("differs from the plain version")
        print(f"{name}: {'FAIL ' + '; '.join(why) if why else 'OK'}",
              flush=True)
        if why:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K10, the cluster-visit probe (counterpart of scripts/micro_cluster_kernel.py).

The JAX package's feasibility probe for its clustered closest-hit kernel:
per ray group, each of the first `count` candidate clusters is visited, and
for each of 8 rows of 128 rays one dense product forms det, u, v and t of
the cluster's 128 triangles from 16 coefficients each; the visit keeps the
minimum over the triangles of ((det + u) + v) + t, and the group the
running minimum over its visits. The output is row 0 of that [8, 128]
state, [G, 1, 128], as the TPU kernel stores it.

`run` launches K10 (csrc/probe_cluster.cu) on CUDA tensors and runs the
plain version `cluster_reference` on CPU tensors. Both sum each quantity in
k order, a multiply then an add, so they agree bit for bit on the card.
The kernel writes all 8 rows; `run(..., all_rows=True)` returns them.

    python -m rtxpt_tpu_torch.probes.micro_cluster_kernel [--device cpu]

prints the script's lines: the maximum relative error against the float64
`reference` (limit LIMIT) and, on the card, the time of the script's timed
size (TIMED: 2,344 clusters, 2,048 groups of 16 full slots).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.probes import one_device

CT = 128          # triangles per cluster
KSLOTS = 16       # candidate slots per group
ROWS = 8          # rows of 128 rays
K = 16            # coefficients per ray and triangle
BIG = 1e30
TIMED = (2344, 2048)      # clusters, groups: the script's timed size
REPS = 5                  # timed runs (the script's)
LIMIT = 1e-5              # max |out - ref| / max(1, |ref|) against float64
_CHUNK = 16               # groups per step of the plain version


def inputs(seed=0, clusters=64, groups=8, timed=None):
    """The script's arrays, drawn with numpy in its order: tris [C, 16, 512],
    cols [8, 16, 128] f32, counts [G] i32 (0..16), cands [G, 16] i32. With
    `timed` = (clusters, groups) the same generator goes on to the script's
    timed arrays, returned instead (same cols, every count 16)."""
    rng = np.random.default_rng(seed)
    tris = rng.standard_normal((clusters, K, 4 * CT)).astype(np.float32)
    cols = rng.standard_normal((ROWS, K, 128)).astype(np.float32)
    counts = rng.integers(0, KSLOTS + 1, size=(groups,)).astype(np.int32)
    cands = rng.integers(0, clusters, size=(groups, KSLOTS)).astype(np.int32)
    if timed is None:
        return dict(counts=counts, cands=cands, cols=cols, tris=tris)
    c2, g2 = timed
    tris2 = rng.standard_normal((c2, K, 4 * CT)).astype(np.float32)
    cands2 = rng.integers(0, c2, size=(g2, KSLOTS)).astype(np.int32)
    return dict(counts=np.full((g2,), KSLOTS, np.int32), cands=cands2,
                cols=cols, tris=tris2)


def cluster_reference(counts, cands, cols, tris):
    """The plain version of K10: the whole [G, 8, 128] state (row 0 is the
    probe's output). Each quantity is summed in k order, the visit's minimum
    and the running minimum propagate NaN, as the kernel's."""
    g = counts.shape[0]
    best = torch.full((g, ROWS, 128), BIG, dtype=torch.float32,
                      device=cols.device)
    c = cols[None, :, :, :, None]                    # [1, 8, 16, 128, 1]
    for i in range(KSLOTS):
        live = torch.nonzero(counts > i).squeeze(1)   # the groups visiting
        for lo in range(0, live.numel(), _CHUNK):
            grp = live[lo:lo + _CHUNK]
            blk = tris[cands[grp, i].long()][:, None, :, None, :]
            p = c[:, :, 0] * blk[:, :, 0]            # [g, 8, 128, 512]
            for k in range(1, K):
                p = p + c[:, :, k] * blk[:, :, k]
            s = ((p[..., 0:CT] + p[..., CT:2 * CT]) + p[..., 2 * CT:3 * CT]) \
                + p[..., 3 * CT:4 * CT]
            best[grp] = torch.minimum(best[grp], torch.amin(s, dim=-1))
    return best


def run(counts, cands, cols, tris, all_rows=False):
    """K10 over counts [G] i32, cands [G, 16] i32 (ids in [0, C)), cols
    [8, 16, 128] f32 and tris [C, 16, 512] f32: [G, 1, 128] f32 (with
    `all_rows`, the whole [G, 8, 128] state). CUDA tensors launch the
    kernel, CPU tensors run the plain version; operands on two devices, and
    build or launch errors, raise."""
    dev = one_device("micro_cluster_kernel.run", counts=counts, cands=cands,
                     cols=cols, tris=tris)
    if dev.type == "cpu":
        best = cluster_reference(counts, cands, cols, tris)
        return best if all_rows else best[:, 0:1]
    if dev.type != "cuda":
        raise ValueError(f"micro_cluster_kernel.run: no kernel for {dev}")
    g, n_c = counts.shape[0], tris.shape[0]
    kernels.check_tensor("counts", counts, torch.int32, (g,), dev)
    kernels.check_tensor("cands", cands, torch.int32, (g, KSLOTS), dev)
    kernels.check_tensor("cols", cols, torch.float32, (ROWS, K, 128), dev)
    kernels.check_tensor("tris", tris, torch.float32, (n_c, K, 4 * CT), dev)
    best = torch.empty((g, ROWS, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernels.PROBE_CLUSTER.launch(
            "rtxpt_probe_cluster", counts.data_ptr(), cands.data_ptr(),
            cols.data_ptr(), tris.data_ptr(), best.data_ptr(), g,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.launches["probe_cluster"] += 1
    return best if all_rows else best[:, 0:1]


def reference(counts, cands, cols, tris):
    """The script's float64 check (numpy): row 0's running minimum [G, 128]."""
    g = counts.shape[0]
    out = np.full((g, 128), BIG, np.float32)
    c0 = cols[0].astype(np.float64).T
    for i in range(g):
        for k in range(int(counts[i])):
            prod = c0 @ tris[int(cands[i, k])].astype(np.float64)
            s = (prod[:, 0:CT] + prod[:, CT:2 * CT] + prod[:, 2 * CT:3 * CT]
                 + prod[:, 3 * CT:4 * CT])
            out[i] = np.minimum(out[i], s.min(1))
    return out


def rel_err(out, ref):
    """The script's metric: max |out - ref| / max(1, |ref|)."""
    return float(np.max(np.abs(out - ref) / np.maximum(1.0, np.abs(ref))))


def _to(arrays, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def main(argv=None) -> int:
    import rtxpt_tpu_torch

    ap = argparse.ArgumentParser(description="K10, the cluster-visit probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, default) or cpu (the plain "
                    "version)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = rtxpt_tpu_torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "plain version")
    print("device:", dev, name, flush=True)
    arrays = inputs(args.seed)
    out = run(**_to(arrays, dev))[:, 0, :].cpu().numpy()
    err = rel_err(out, reference(**arrays))
    print("max rel err:", err, flush=True)
    if not err < LIMIT:
        print(f"FAIL: max rel err {err} against the float64 reference, "
              f"limit {LIMIT}", flush=True)
        return 1
    print("CORRECT", flush=True)
    if dev.type != "cuda":
        return 0
    timed = _to(inputs(args.seed, timed=TIMED), dev)
    run(**timed)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        run(**timed)
    torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / REPS
    visits = TIMED[1] * KSLOTS
    print(f"{dt*1e3:.2f} ms, {visits} visits, "
          f"{visits/dt/1e6:.2f} Mvisits/s, "
          f"{visits*128*CT/dt/1e9:.1f} G ray-tri/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

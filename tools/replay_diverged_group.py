"""Replay ray groups of the per-row clustered route through the JAX
package's own Pallas kernels on the CPU (interpret mode), and say whether
the JAX per-row kernel and the JAX flat kernel pick different winners on
the same candidate lists.

The groups come from a CUDA card:

    python3 chip_smoke.py --diverged-group group.npz

saves the city's 1080p bounce-0 ray groups with the most lanes whose
winner in the port's K6 (per-row closest hit and shading) differs from
the winner in K3 (flat closest hit, one page) on the same lists, with
the clusters of their lists, their state rows and both kernels'
winners. Then

    python3 tools/replay_diverged_group.py group.npz

runs the groups through `_kernel_a_call` (K6, `_kernel_a`) and
`_kernel_a1_call` (K3, `_kernel_a1`) of rtxpt_tpu/pt/bounce_clustered.py
and prints one JSON object: on how many active lanes the two JAX kernels
pick different triangles, on how many the port's two kernels do, on how
many both packages' kernels do, and on how many each JAX kernel's winner
differs from the port's kernel's. It imports the JAX package and numpy
only; eight groups take about half a minute.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from rtxpt_tpu.config import NEEMode, PathTracerConfig  # noqa: E402
from rtxpt_tpu.pt import bounce_clustered as JBC  # noqa: E402
from rtxpt_tpu.pt import wide as W  # noqa: E402
from rtxpt_tpu.pt.bounce_pallas import (  # noqa: E402
    FS_D, FS_O, IS_ACTIVE, NF, NI, _cfg_key)


def replay(path):
    z = np.load(path)
    kslots, mt = int(z["kslots"]), float(z["max_travel"])
    cand = jnp.asarray(z["cand"], jnp.int32)
    blocks = jnp.asarray(z["blocks"], jnp.float32)
    fs = jnp.asarray(z["fs"], jnp.float32)                   # [NF, G*FL]
    is_ = jnp.asarray(z["is_"], jnp.int32)                   # [NI, G*FL]
    g = cand.shape[0]
    active = np.asarray(z["is_"][IS_ACTIVE] > 0)

    # K3, as the flat route calls it (one page, the same lists)
    of, df = fs[FS_O:FS_O + 3], fs[FS_D:FS_D + 3]
    od = jnp.concatenate([df, W.cross3(of, df), of,
                          (is_[IS_ACTIVE] > 0).astype(jnp.float32)[None]])
    ha = JBC._kernel_a1_call(cand, JBC._to_flat_groups(od, g), blocks,
                             kslots, mt, interpret=True)
    k3_prim = np.asarray(ha[:, JBC.HA_PRIM]).reshape(-1)

    # K6, as the per-row route calls it at bounce 0
    cfg = PathTracerConfig(max_bounces=int(z["max_bounces"]),
                           nee=NEEMode(int(z["nee"])), max_ray_travel=mt)
    scal = jnp.asarray([[int(z["sample"]), 0]], jnp.uint32)
    out = JBC._kernel_a_call(
        scal, cand, fs.reshape(NF, g * JBC._R, 128),
        is_.reshape(NI, g * JBC._R, 128),
        jnp.asarray(z["mat_rows"]), jnp.asarray(z["light_rows"]), None, None,
        None, blocks, _cfg_key(cfg), kslots, int(z["n_lights"]), 0, True,
        interpret=True)
    k6_prim = np.asarray(out[3][1]).reshape(-1)

    differ = active & (k6_prim != k3_prim)
    port_differ = np.asarray(z["differ"])

    def count(x):
        return int((active & x).sum())
    return dict(
        groups=z["groups"].tolist(), active_lanes=int(active.sum()),
        listed_clusters=z["cand"][:, 0, 0].tolist(),
        jax_k6_vs_jax_k3_lanes_differ=count(differ),
        port_k6_vs_port_k3_lanes_differ=count(port_differ),
        both_packages_differ_lanes=count(differ & port_differ),
        jax_k6_vs_port_k6_lanes_differ=count(k6_prim != z["k6_prim"]),
        jax_k3_vs_port_k3_lanes_differ=count(k3_prim != z["k3_prim"]),
        jax_k6_hit_k3_miss=count(differ & (k6_prim >= 0) & (k3_prim < 0)),
        jax_k3_hit_k6_miss=count(differ & (k3_prim >= 0) & (k6_prim < 0)))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("group", help=".npz from chip_smoke.py "
                        "--diverged-group")
    print(json.dumps(replay(parser.parse_args().group)))

"""K8's screens (csrc/brute_closest.cu, csrc/brute.cuh) on the CPU.

K8 screens every (ray, triangle) pair before the divide and resolves the
pairs that pass with the plain version's arithmetic
(accel/brute.py `_intersect_chunk`), keeping the least (t, triangle
index). Two routes:

- the CUDA-core screen (`brute.screen_model`, brute.cuh `brute_screen`)
  on the exact det, u and v numerators: |det| > 1e-12 and the signed
  numerators against |det| with a 2^-20 slack;
- above brute.MMA_TRIS triangles, K1's tensor-core screen on the split-bf16
  coefficient tile of K8's rows (`brute.brute_tile`): the stacked products
  summed exactly (float64) and rounded to f32 here, K1's margins widened by
  its error term.

Each must pass every pair the plain test accepts, whatever its t; the
resolve of the passing pairs must give the plain version's t, prim, uv
and front bit for bit. Cases: the Cornell box's and the kitchen's camera
rays, a random soup, rays grazing its triangles' planes, rays through
their edges and vertices, degenerate triangles (det ~ 0) and the padding
triangles of the tile. No JAX; -s prints the pass shares."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.accel import brute
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.utils import math as m

CSRC = Path(brute.__file__).resolve().parents[1] / "csrc"
CASES = ("cornell", "kitchen", "soup", "grazing", "edges", "degenerate")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(host, cols, rows):
    cam = TP.default_camera(host, cols, rows, device="cpu")
    px, py = _pixel_grid(cols, rows, "cpu")
    o, d, _ = camera_rays(cam, PathTracerConfig(), px, py, 1)
    return o.contiguous(), d.contiguous()


def _soup(rng, n_tris):
    v0 = rng.uniform(-1.0, 1.0, (n_tris, 3))
    e1 = rng.normal(0.0, 0.4, (n_tris, 3))
    e2 = rng.normal(0.0, 0.4, (n_tris, 3))
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def case(name):
    """(BruteTris on the CPU, o, d [N, 3] f32)."""
    rng = np.random.default_rng(8)
    if name in ("cornell", "kitchen"):
        host = TP.cornell_box() if name == "cornell" else TP.kitchen_scene()
        tris = prepare(host, device="cpu").bvh.brute
        o, d = _camera(host, 64, 32)
        return tris, o, d
    v0, e1, e2 = _soup(rng, 300)
    n = 2048
    if name == "soup":
        o = rng.uniform(-3.0, 3.0, (n, 3))
        d = _unit(rng.normal(size=(n, 3)))
    elif name == "grazing":
        # rays in (or within an ulp-scale tilt of) a triangle's plane,
        # through a point of it
        k = rng.integers(0, len(v0), n)
        nrm = _unit(np.cross(e1[k], e2[k]).astype(np.float64))
        inplane = _unit(np.cross(nrm, rng.normal(size=(n, 3))))
        tilt = rng.choice([0.0, 1e-7, -1e-7, 1e-5], n)[:, None]
        d = _unit(inplane + tilt * nrm)
        a, b = rng.uniform(0, 1, (2, n, 1))
        p = v0[k] + a * (1 - b) * e1[k] + a * b * e2[k]
        o = p - 2.0 * d
    elif name == "edges":
        # rays aimed at a vertex or an edge's point of a triangle
        k = rng.integers(0, len(v0), n)
        s = rng.uniform(0, 1, (n, 1))
        pick = rng.integers(0, 5, n)[:, None]
        p = np.where(pick == 0, v0[k], np.where(
            pick == 1, v0[k] + e1[k], np.where(
                pick == 2, v0[k] + e2[k], np.where(
                    pick == 3, v0[k] + s * e1[k],
                    v0[k] + (1 - s) * e1[k] + s * e2[k]))))
        o = rng.uniform(-3.0, 3.0, (n, 3))
        d = _unit(p - o)
    else:
        # degenerate triangles: collinear or repeated vertices, tiny ones
        e2 = e2.copy()
        e2[:100] = e1[:100] * rng.uniform(-2, 2, (100, 1)).astype(np.float32)
        e2[100:150] = 0.0
        e1[150:200] *= 1e-6
        e2[150:200] *= 1e-6
        o = rng.uniform(-3.0, 3.0, (n, 3))
        d = _unit(v0[rng.integers(0, len(v0), n)] - o)
    tris = brute.brute_from_edges(v0, e1, e2, device="cpu")
    return (tris, torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


def plain_pairs(tris, o, d, tmin, tmax):
    """(det, u_num, v_num, accept, u, v, t) [N, T] as `_intersect_chunk`
    computes them (the same operations in the same order)."""
    c = tris.table.T
    n, e1, e2 = (c[k:k + 3] for k in (brute.TB_N, brute.TB_E1, brute.TB_E2))
    oxd = m.cross(o, d)
    det = -brute._dot(d, n)
    un = (brute._dot(oxd, e2)
          + brute._dot(d, c[brute.TB_V0XE2:brute.TB_V0XE2 + 3]))
    vn = (-brute._dot(oxd, e1)
          - brute._dot(d, c[brute.TB_V0XE1:brute.TB_V0XE1 + 3]))
    tn = brute._dot(o, n) - c[brute.TB_V0N][None, :]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    u, v, t = un * inv, vn * inv, tn * inv
    accept = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > tmin[:, None]) & (t < tmax[:, None]))
    return det, un, vn, accept, u, v, t


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def mma_screen(tris, o, d):
    """[N, T8] the pairs K1's tensor-core screen passes on K8's tile: the
    stacked split-bf16 products summed exactly and rounded to f32, the
    error term SCREEN_EPS x scale x max |r_k|, bounce_fused_mma.cuh
    `screen`."""
    tile, scale = brute.brute_tile(tris.table)
    t = tile.float()
    r = torch.cat([d, m.cross(o, d)], 1).T                  # [6, N]
    hi = _bf16(r)
    l1 = _bf16(r - hi)
    full = (hi + l1 + ((r - hi) - l1)).double()
    q = []
    for base, nc in zip(bf.TT_BASE, bf.TT_COMPS):
        ch = t[base:base + nc].T.double()
        cl = t[base + nc:base + 2 * nc].T.double()
        q.append((ch @ full[:nc] + cl @ hi[:nc].double()).float().T)
    det, un, vn = q
    e = (bf.SCREEN_EPS * r.abs().amax(0)).float()[:, None] * scale[None, :]
    absd = det.abs()
    s = torch.where(det >= 0.0, 1.0, -1.0)
    su, sv = un * s, vn * s
    w = bf.SCREEN_MARGIN * absd + e
    lim = absd + 2.0 * (w + e)
    unknown = (absd < e) & (un.abs() + vn.abs() <= lim)
    return unknown | ((absd >= e) & (absd > 0.0) & (su >= -w) & (sv >= -w)
                      & (su + sv <= lim))


def resolve(passed, accept, u, v, t, det, tmax):
    """The kernel's winner per ray among the passing pairs: the least (t,
    index) of those brute_pair accepts; dict as `_intersect_chunk`."""
    ok = passed & accept
    t_m = torch.where(ok, t, torch.inf)
    best = t_m.amin(1)
    idx = torch.arange(t.shape[1])[None]
    j = torch.where(ok & (t_m == best[:, None]), idx, t.shape[1]).amin(1)
    hit = j < t.shape[1]
    jc = j.clamp(max=t.shape[1] - 1)[:, None]

    def pick(x):
        return torch.gather(x, 1, jc)[:, 0]
    zero = torch.zeros_like(best)
    return dict(t=torch.where(hit, pick(t), tmax),
                prim=torch.where(hit, j, -1).to(torch.int32),
                uv=torch.stack([torch.where(hit, pick(u), zero),
                                torch.where(hit, pick(v), zero)], -1),
                front=hit & (pick(det) > 0.0))


def _bits_equal(a, b):
    for k in ("t", "uv", "prim", "front"):
        x, y = a[k], b[k]
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


def _ranges(n):
    """(tmin, tmax) pairs: the general tier's (0, 1e27) and any t at all."""
    return ((torch.zeros(n), torch.full((n,), 1e27)),
            (torch.full((n,), -torch.inf), torch.full((n,), torch.inf)))


@pytest.mark.parametrize("name", CASES)
def test_cuda_core_screen_passes_every_accepted_pair(name, capsys):
    tris, o, d = case(name)
    passed = brute.screen_model(tris, o, d)
    for tmin, tmax in _ranges(o.shape[0]):
        accept = plain_pairs(tris, o, d, tmin, tmax)[3]
        assert not (accept & ~passed).any()
    with capsys.disabled():
        print(f"\nK8 CUDA-core screen {name}: {tris.num_triangles} "
              f"triangles, pass share {float(passed.float().mean()):.4%}, "
              f"accepted (any t) {float(accept.float().mean()):.4%}")


@pytest.mark.parametrize("name", CASES)
def test_tensor_core_screen_passes_every_accepted_pair(name, capsys):
    tris, o, d = case(name)
    n_tris = tris.num_triangles
    passed = mma_screen(tris, o, d)
    # the tile's padding triangles (zero rows, zero scale) never pass
    assert not passed[:, n_tris:].any()
    passed = passed[:, :n_tris]
    for tmin, tmax in _ranges(o.shape[0]):
        accept = plain_pairs(tris, o, d, tmin, tmax)[3]
        assert not (accept & ~passed).any()
    with capsys.disabled():
        print(f"\nK8 tensor-core screen {name}: pass share "
              f"{float(passed.float().mean()):.4%}")


@pytest.mark.parametrize("route", ["cuda-core", "tensor-core"])
@pytest.mark.parametrize("name", CASES)
def test_resolve_matches_the_plain_version(name, route):
    tris, o, d = case(name)
    n = o.shape[0]
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e27)
    det, _, _, accept, u, v, t = plain_pairs(tris, o, d, tmin, tmax)
    passed = (brute.screen_model(tris, o, d) if route == "cuda-core"
              else mma_screen(tris, o, d)[:, :tris.num_triangles])
    got = resolve(passed, accept, u, v, t, det, tmax)
    want = brute._intersect_chunk(tris, o, d, tmin, tmax)
    _bits_equal(got, want)
    if name != "degenerate":
        assert (want["prim"] >= 0).any()


def test_tile_coefficients_are_the_numerators():
    """The tile's f32 coefficient rows times [d | o x d], summed in
    float64, equal the plain numerators summed in float64: det from -n, u
    from [v0 x e2 | e2], v from [-(v0 x e1) | -e1]."""
    tris, o, d = case("soup")
    coef = brute.tile_coefficients(tris.table).double()
    r = torch.cat([d, m.cross(o, d)], 1).double()
    c = tris.table.double().T
    x = m.cross(o, d).double()
    det = -(d.double() @ c[brute.TB_N:brute.TB_N + 3])
    un = x @ c[brute.TB_E2:brute.TB_E2 + 3] + d.double() @ c[
        brute.TB_V0XE2:brute.TB_V0XE2 + 3]
    vn = -(x @ c[brute.TB_E1:brute.TB_E1 + 3]) - d.double() @ c[
        brute.TB_V0XE1:brute.TB_V0XE1 + 3]
    for q, want in ((bf.TC_DET, det), (bf.TC_U, un), (bf.TC_V, vn)):
        nc = 3 if q == bf.TC_DET else 6
        got = r[:, :nc] @ coef[:, q:q + nc].T
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_tables_carry_the_tile_up_to_the_tensor_core_limit():
    """brute_from_fields builds K8's tensor-core tile beside a CUDA table
    that the tensor-core route takes (more than MMA_TRIS and at most
    MMA_MAX_TRIS triangles), and beside no CPU table; brute_tile gives it
    its shapes."""
    sizes = (1, brute.MMA_TRIS, brute.MMA_TRIS + 1, brute.MMA_MAX_TRIS,
             brute.MMA_MAX_TRIS + 1, brute.BRUTE_MAX_TRIS)
    assert [brute._route(n) for n in sizes] == [
        "cuda-core", "cuda-core", "mma", "mma", "cuda-core", "cuda-core"]
    small = case("cornell")[0]
    assert small.tile is None and small.scale is None
    tile, scale = brute.brute_tile(small.table)
    assert tile.dtype == torch.bfloat16 and scale.dtype == torch.float32
    assert tile.shape == (bf.TT_ROWS, 40) and scale.shape == (40,)
    rng = np.random.default_rng(3)
    mid = brute.brute_from_edges(*_soup(rng, brute.MMA_TRIS + 1),
                                 device="cpu")
    assert brute.route(mid) == "mma" and mid.tile is None


def test_screen_constants_match_the_kernel():
    """brute.cuh and brute_closest.cu spell out the screen's slack, its
    |det| limits and the routes' thresholds that accel/brute.py states."""
    src = (CSRC / "brute.cuh").read_text()
    assert "w = absd * (1.0f / 1048576.0f)" in src
    assert brute.SCREEN_SLACK == 2.0 ** -20
    huge = float(re.search(r"kBruteHuge = ([0-9.e]+)f;", src).group(1))
    assert float(np.float32(huge)) == brute.SCREEN_HUGE == 2.0 ** 125
    assert "absd > 1e-12f" in src and "fabsf(det) > 1e-12f" in src
    mma = (CSRC / "bounce_fused_mma.cuh").read_text()
    assert int(re.search(r"kMaxTris = (\d+);", mma).group(1)) \
        == brute.MMA_MAX_TRIS == bf.MAX_TRIS
    k8 = (CSRC / "brute_closest.cu").read_text()
    assert re.search(r"kRays = \d+;", k8) and re.search(r"kThreads = \d+;",
                                                        k8)
    assert brute.BRUTE_MAX_TRIS > brute.MMA_MAX_TRIS > brute.MMA_TRIS > 0

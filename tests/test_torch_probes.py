"""The probes K10-K12 of rtxpt_tpu_torch/probes against the JAX package's
own probe kernels (scripts/micro_cluster_kernel.py, micro_flat_kernel.py,
micro_constructs.py), run in interpret mode on the CPU on the same numpy
inputs: the port's inputs are the scripts' arrays, its plain versions (what
`run` takes on CPU tensors) agree with the JAX kernels within the stated
limits, and each module's `main` passes its own check on the CPU. One JAX
interpret run per probe, shared through module fixtures. The kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 19).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.probes import micro_cluster_kernel as K10
from rtxpt_tpu_torch.probes import micro_constructs as K12
from rtxpt_tpu_torch.probes import micro_flat_kernel as K11

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K12's limits against the JAX kernel: the split-bf16 products and the sums
# run in another order there
K12_LIMITS = dict(mm_concat_256=1e-5, mm_concat_1024=1e-5, subl_concat=1e-6,
                  unflat=1e-6)


def _script(name):
    """scripts/<name>.py as a module (the scripts are not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_cluster.py: the test run
    puts several processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Drawn(Exception):
    """Raised by a stand-in for a script's `run` once it has its inputs."""


def _script_inputs(script, monkeypatch):
    """The arrays the script's own main() draws, taken at its first call
    of `run` (which then stops main)."""
    seen = {}

    def stand_in(*args, **kwargs):
        seen["args"] = [np.asarray(a) for a in args]
        raise _Drawn

    monkeypatch.setattr(script, "run", stand_in)
    with pytest.raises(_Drawn):
        script.main()
    return seen["args"]


@pytest.fixture(scope="module")
def k10_case():
    script = _script("micro_cluster_kernel")
    with pytest.MonkeyPatch.context() as mp:
        drawn = _script_inputs(script, mp)
    arrays = K10.inputs(0)
    counts = arrays["counts"]
    counts[-1] = 0                     # slots 0 and 16 both occur
    assert (counts == K10.KSLOTS).any() and (counts == 0).any()
    out = np.asarray(script.run(*(jnp.asarray(arrays[k]) for k in (
        "counts", "cands", "cols", "tris")), interpret=True))
    return script, drawn, arrays, out


@pytest.fixture(scope="module")
def k11_case():
    script = _script("micro_flat_kernel")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FORCE_CPU", "1")    # the script's interpret size, G = 2
        drawn = _script_inputs(script, mp)
    arrays = K11.inputs(0, groups=2)
    t, prim = script.run(*(jnp.asarray(arrays[k])
                           for k in ("cand", "od", "blocks")), interpret=True)
    return script, drawn, arrays, np.asarray(t), np.asarray(prim)


@pytest.fixture(scope="module")
def k11_aimed(k11_case):
    """The JAX kernel on rays aimed at the probe's triangles (same shapes,
    so jit's cache holds the interpret compile): od, t, prim."""
    script, _, arrays, _, _ = k11_case
    od = K11.aimed_rays(arrays)
    t, prim = script.run(jnp.asarray(arrays["cand"]), jnp.asarray(od),
                         jnp.asarray(arrays["blocks"]), interpret=True)
    return od, np.asarray(t), np.asarray(prim)


def _k11_same_as_jax(t, prim, t_jax, p_jax):
    """Hit / miss equal on every lane, prim equal wherever JAX hits, t
    within rtol = atol = 1e-5 there."""
    hit, hit_jax = t < K11.BIG, t_jax < K11.BIG
    np.testing.assert_array_equal(hit, hit_jax)
    np.testing.assert_array_equal(prim[hit_jax], p_jax[hit_jax])
    np.testing.assert_allclose(t[hit_jax], t_jax[hit_jax], rtol=1e-5,
                               atol=1e-5)


def test_k10_inputs_match_script(k10_case):
    """The port draws the script's arrays from the same seed."""
    _, drawn, _, _ = k10_case
    mine = K10.inputs(0)
    assert len(drawn) == 4
    for got, key in zip(drawn, ("counts", "cands", "cols", "tris")):
        np.testing.assert_array_equal(mine[key], got)


def test_k10_matches_jax_interpret(k10_case):
    """The script's metric, max |d| / max(1, |ref|) < 1e-5, on its CPU size
    (64 clusters, 8 groups, counts from 0 to 16)."""
    script, _, arrays, out_jax = k10_case
    out = K10.run(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    assert tuple(out.shape) == out_jax.shape == (8, 1, 128)
    assert K10.rel_err(out.numpy()[:, 0], out_jax[:, 0]) < 1e-5
    # the count-0 group keeps its initial value, as the TPU kernel's
    assert (out.numpy()[-1] == np.float32(K10.BIG)).all()
    # and the script's float64 reference holds the port as it holds JAX
    ref = script.reference(*(arrays[k] for k in (
        "counts", "cands", "cols", "tris")))
    assert K10.rel_err(out.numpy()[:, 0], ref) < K10.LIMIT


def test_k10_all_rows_is_the_state():
    """run(all_rows=True) returns the 8-row state whose row 0 is the
    output; each row is the row-0 computation on its own rays."""
    arrays = K10.inputs(0, 16, 4)
    ops = {k: torch.from_numpy(v) for k, v in arrays.items()}
    best = K10.run(**ops, all_rows=True)
    assert tuple(best.shape) == (4, 8, 128)
    assert torch.equal(best[:, 0:1], K10.run(**ops))
    cols = ops["cols"]
    swapped = cols.clone()
    swapped[0] = cols[7]
    assert torch.equal(K10.run(**dict(ops, cols=swapped))[:, 0], best[:, 7])


def test_k11_inputs_match_script(k11_case):
    _, drawn, arrays, _, _ = k11_case
    assert len(drawn) == 3
    for got, key in zip(drawn, ("cand", "od", "blocks")):
        np.testing.assert_array_equal(arrays[key], got)


def test_k11_matches_jax_interpret(k11_case):
    """G = 2 (the script's interpret size): hit / miss equal on every lane,
    prim equal and t within rtol = atol = 1e-5 wherever JAX hits."""
    _, _, arrays, t_jax, p_jax = k11_case
    t, prim = K11.run(*(torch.from_numpy(arrays[k])
                        for k in ("cand", "od", "blocks")))
    t, prim = t.numpy(), prim.numpy()
    assert t.shape == t_jax.shape == (2, 8, 128)
    hit_jax = t_jax < K11.BIG
    assert hit_jax.any()                      # the random rays hit rarely
    _k11_same_as_jax(t, prim, t_jax, p_jax)
    cand, od = arrays["cand"], arrays["od"]
    # the script's own check (vacuous at seed 0: none of its sampled lanes
    # hits a world triangle), and every lane against the triangles the
    # probe intersects, where each of the JAX kernel's hits is found
    assert not K11.check(t, K11.brute_force(cand, od, arrays["tris"]))
    local = K11.brute_force(cand, od, K11.local_tris(arrays), lane_step=1)
    assert len(local) == int(hit_jax.sum())
    assert not K11.check(t, local) and not K11.check(t_jax, local)


def test_k11_aimed_rays_match_jax_interpret(k11_case, k11_aimed):
    """Rays aimed at the probe's triangles, so that the lanes hit: the same
    agreement with JAX on every lane, and every hit within the script's
    2e-2 of a float64 brute force that selects with the kernel's margins
    (aimed_check)."""
    _, _, arrays, _, _ = k11_case
    od, t_jax, p_jax = k11_aimed
    t, prim = K11.run(torch.from_numpy(arrays["cand"]), torch.from_numpy(od),
                      torch.from_numpy(arrays["blocks"]))
    t, prim = t.numpy(), prim.numpy()
    assert (t_jax < K11.BIG).mean() > 0.99
    _k11_same_as_jax(t, prim, t_jax, p_jax)
    hits, bad = K11.aimed_check(t, arrays, od)
    assert hits >= int((t_jax < K11.BIG).sum()) and not bad


def test_bf16_split_matches_script(k11_case):
    """The port's bf16 split (torch) equals the script's _bf16_split (JAX)
    and its uint32 rounding (numpy), ties to even included."""
    script = k11_case[0]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    # exactly half a bf16 ulp above a bf16 value; exponents kept away from
    # the subnormals, which XLA's CPU backend flushes to zero
    ties = (rng.integers(0x0C00, 0x7000, 256, dtype=np.uint32) << 16
            | 0x8000).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, -0.0, 1.0])])
    hi, lo = (v.numpy() for v in K11.bf16_split(torch.from_numpy(x)))
    hi_j, lo_j = (np.asarray(v) for v in script._bf16_split(jnp.asarray(x)))
    np.testing.assert_array_equal(hi, hi_j)
    np.testing.assert_array_equal(lo, lo_j)
    np.testing.assert_array_equal(hi, K11.bf16_round_np(x))
    np.testing.assert_array_equal(lo, x - K11.bf16_round_np(x))


@pytest.fixture(scope="module")
def k12_script():
    return _script("micro_constructs")


@pytest.mark.parametrize("name", K12.CONSTRUCTS)
def test_k12_matches_jax_interpret(k12_script, name, monkeypatch):
    """Each construct: the script's BODY run with pallas_call in interpret
    mode against the port's plain version on the same x, b."""
    assert tuple(k12_script.CONSTRUCTS) == K12.CONSTRUCTS
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    ns = {}
    exec(compile(k12_script.BODY % name, f"micro_constructs:{name}", "exec"),
         ns)
    arrays = K12.inputs(0)
    np.testing.assert_array_equal(arrays["x"], np.asarray(ns["x"]))
    np.testing.assert_array_equal(arrays["b"], np.asarray(ns["b"]))
    out = K12.run(name, torch.from_numpy(arrays["x"]),
                  torch.from_numpy(arrays["b"])).numpy()
    assert out.shape == ns["y"].shape == (1, 1024)
    lim = K12_LIMITS.get(name, 0.0)
    np.testing.assert_allclose(out, ns["y"], rtol=lim, atol=lim)


@pytest.mark.parametrize("module", [K10, K11, K12],
                         ids=["k10", "k11", "k12"])
def test_main_on_cpu(module, capsys):
    """Each probe's entry point passes its own check on the CPU."""
    assert module.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out


def test_k12_main_refuses_unknown_construct(capsys):
    assert K12.main(["nope", "--device", "cpu"]) == 1
    assert "nope: FAIL" in capsys.readouterr().out


def test_probes_refuse_mixed_devices():
    """A CPU table with an operand on another device raises instead of
    running either version (the meta device stands in for the card)."""
    a = {k: torch.from_numpy(v) for k, v in K10.inputs(0, 4, 2).items()}
    with pytest.raises(ValueError, match="different devices"):
        K10.run(**dict(a, cols=a["cols"].to("meta")))
    b = K11.inputs(0, groups=1)
    with pytest.raises(ValueError, match="different devices"):
        K11.run(torch.from_numpy(b["cand"]),
                torch.from_numpy(b["od"]).to("meta"),
                torch.from_numpy(b["blocks"]))
    x = torch.zeros((16, 1024))
    with pytest.raises(ValueError, match="different devices"):
        K12.run("tile8", x, torch.zeros((32, 512), device="meta"))


def test_cpu_runs_count_no_launch():
    before = dict(kernels.launches)
    a = {k: torch.from_numpy(v) for k, v in K10.inputs(0, 4, 2).items()}
    K10.run(**a)
    K12.run("iota_sel", torch.rand(16, 1024), torch.rand(32, 512))
    assert dict(kernels.launches) == before

"""Package rules of rtxpt_tpu_torch: no JAX anywhere in the port, the
kernel layer imports without nvcc or a GPU, CPU tensors never count a
kernel launch, and the dispatch refuses what the kernel does not serve
instead of demoting it (the one choice of another tier, "xla" under "auto"
for what only the general tier samples, is the JAX package's own)."""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import rtxpt_tpu.config as jconfig
from rtxpt_tpu_torch import config as tconfig
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel.bvh import bvh_from_numpy
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig, PTMode
from rtxpt_tpu_torch.lighting import neeat
from rtxpt_tpu_torch.lighting.lights_baker import (
    KIND_SPHERE, lights_from_numpy)
from rtxpt_tpu_torch.lighting.sky import make_sky
from rtxpt_tpu_torch.prepare import (
    cluster_scene_from_numpy, prepare, scene_from_numpy)
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "rtxpt_tpu_torch", "rtxpt_tpu_torch.config", "rtxpt_tpu_torch.kernels",
    "rtxpt_tpu_torch.prepare", "rtxpt_tpu_torch.utils.rng",
    "rtxpt_tpu_torch.utils.math", "rtxpt_tpu_torch.utils.image",
    "rtxpt_tpu_torch.scene.scene", "rtxpt_tpu_torch.scene.camera",
    "rtxpt_tpu_torch.scene.procedural", "rtxpt_tpu_torch.scene.textures",
    "rtxpt_tpu_torch.lighting.envmap",
    "rtxpt_tpu_torch.lighting.lights_baker", "rtxpt_tpu_torch.pt.bsdf",
    "rtxpt_tpu_torch.pt.wide", "rtxpt_tpu_torch.pt.bounce_fused",
    "rtxpt_tpu_torch.pt.dispatch", "rtxpt_tpu_torch.pt.integrator",
    "rtxpt_tpu_torch.render.postprocess", "rtxpt_tpu_torch.apps.cli",
    "rtxpt_tpu_torch.accel.cluster", "rtxpt_tpu_torch.accel.cull",
    "rtxpt_tpu_torch.ops.wavefront", "rtxpt_tpu_torch.pt.bounce_clustered",
    "rtxpt_tpu_torch.pt.surface", "rtxpt_tpu_torch.pt.restir",
    "rtxpt_tpu_torch.lighting.neeat", "rtxpt_tpu_torch.pt.nee_external",
    "rtxpt_tpu_torch.accel.bvh", "rtxpt_tpu_torch.accel.lbvh",
    "rtxpt_tpu_torch.accel.native", "rtxpt_tpu_torch.accel.brute",
    "rtxpt_tpu_torch.accel.traverse", "rtxpt_tpu_torch.accel.tlas",
    "rtxpt_tpu_torch.lighting.sky", "rtxpt_tpu_torch.scene.omm",
    "rtxpt_tpu_torch.pt.stable_planes", "rtxpt_tpu_torch.pt.realtime",
    "rtxpt_tpu_torch.render.denoise", "rtxpt_tpu_torch.render.taa",
]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_slice_imports_no_jax():
    """Every slice module imports in a fresh process without JAX, Flax or
    the JAX package (rtxpt_tpu)."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'rtxpt_tpu'))\n"
            "assert not bad, bad\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_kernel_layer_imports_without_nvcc():
    """The kernel module and its wrapper import with no CUDA toolkit on
    PATH; building then raises (it never falls back)."""
    if os.path.exists(os.path.join(kernels.DEFAULT_CUDA_HOME, "bin", "nvcc")):
        pytest.skip("a CUDA toolkit is installed at the default prefix, so "
                    "nvcc cannot be hidden from the build")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(REPO, "no-such-cuda"))
    env.pop("CUDA_PATH", None)
    code = ("from rtxpt_tpu_torch import kernels\n"
            "import rtxpt_tpu_torch.pt.bounce_fused\n"
            "import rtxpt_tpu_torch.pt.bounce_clustered\n"
            "import rtxpt_tpu_torch.accel.traverse\n"
            "for lib in kernels.LIBRARIES:\n"
            "    try:\n"
            "        lib.load()\n"
            "    except RuntimeError as e:\n"
            "        assert 'nvcc' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('built without nvcc')\n")
    res = _run(code, env)
    assert res.returncode == 0, res.stderr


def test_prepare_defaults_to_the_card(monkeypatch):
    """prepare, scene_from_numpy, lights_from_numpy and the NEE-AT state's
    constructors run on the GPU unless the caller asks for the CPU;
    without a GPU they raise instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = TP.cornell_box()
    for make in (lambda: prepare(host), lambda: scene_from_numpy({}),
                 lambda: cluster_scene_from_numpy({}),
                 lambda: lights_from_numpy({}),
                 lambda: neeat.init_state(8, 8, 2),
                 lambda: neeat.state_from_numpy({}),
                 lambda: bvh_from_numpy({})):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert prepare(host, device="cpu").bounce_tables.device.type == "cpu"
    assert neeat.init_state(8, 8, 2, device="cpu").tile_pdf.device.type \
        == "cpu"


def test_builders_default_to_the_card(monkeypatch):
    """The public builders and the constructors that carry the JAX
    package's tables across build on the GPU unless asked for the CPU,
    and raise without one."""
    from rtxpt_tpu_torch.accel import brute, bvh, cluster, lbvh, tlas
    from rtxpt_tpu_torch.lighting.envmap import bake_envmap
    from rtxpt_tpu_torch.lighting.lights_baker import bake_lights

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos = np.eye(3, dtype=np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    host = TP.instanced_boxes()
    flat = TP.cornell_box().flatten()
    for make in (lambda: lbvh.build_bvh(pos, idx),
                 lambda: bvh.bvh_from_packed(np.zeros((1, 17)), [0], pos[:1],
                                             pos[:1], pos[:1]),
                 lambda: brute.build_brute(pos, idx),
                 lambda: brute.brute_from_fields({}),
                 lambda: bake_envmap(None),
                 lambda: bake_lights(flat, bake_envmap(None, device="cpu"),
                                     1.0),
                 lambda: bf.tables_from_numpy(0, 0, 0, 0, 1, 1, 0, 0),
                 lambda: tlas.tlas_from_numpy({}),
                 lambda: tlas.build_two_level(host),
                 lambda: cluster.cluster_tables_from_numpy(
                     0, 0, 0, 0, 0, 0, 0, 0, 0)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert lbvh.build_bvh(pos, idx, device="cpu").device.type == "cpu"
    assert tlas.build_two_level(host, device="cpu")["tlas"].device.type \
        == "cpu"


@pytest.fixture(scope="module")
def cornell():
    host = TP.cornell_box()
    return host, prepare(host, device="cpu")


@pytest.fixture(scope="module")
def small_city():
    """A scene with cluster tables (3,512 triangles)."""
    return prepare(TP.city_scene(tri_budget=4000, seed=1, blocks=2),
                   device="cpu")


@pytest.fixture(scope="module")
def instanced_city():
    """A two-level scene with instanced cluster tables (4 towers sharing
    one prototype and a floor: 2,928 world triangles)."""
    return prepare(TP.instanced_city(grid=2, subdiv=6), device="cpu")


@pytest.fixture(scope="module")
def sky_cornell():
    """The Cornell box under make_sky(64, 32): fused tables with the
    environment table."""
    host = TP.cornell_box()
    host.envmap_image = make_sky(64, 32)
    return prepare(host, device="cpu")


def _state(n_lights, device="cpu"):
    return neeat.init_state(8, 8, n_lights, device=device)


def _more_lights(scene):
    """The scene with a light list and cluster tables of 129 lights."""
    kind = torch.zeros((bf.MAX_LIGHTS + 1,), dtype=torch.int32)
    return scene.replace(
        lights=dataclasses.replace(scene.lights, kind=kind),
        cluster_tables=dataclasses.replace(scene.cluster_tables,
                                           n_lights=bf.MAX_LIGHTS + 1))


def test_cpu_tensors_launch_no_kernel(cornell):
    """The 'fused' tier on CPU tensors runs the plain version: the launch
    counter stays where it was."""
    host, scene = cornell
    kernels.launches.clear()
    out = render_sample(scene, TP.default_camera(host, 8, 8),
                        PathTracerConfig(max_bounces=2, kernel_tier="fused"),
                        8, 8, 0)
    assert out["kernel_tier"] == "fused"
    assert kernels.launches["bounce_fused"] == 0
    assert torch.isfinite(out["L"]).all()


def test_bounce_refuses_other_devices(cornell):
    _, scene = cornell
    fs = torch.zeros((bf.NF, 4), device="meta")
    is_ = torch.zeros((bf.NI, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        bf.bounce(fs, is_, scene.bounce_tables, bf.KernelConfig(), 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_checks(bad):
    x = torch.zeros((bf.NF, 8))
    if bad == "dtype":
        x, err = x.double(), ValueError
    elif bad == "shape":
        x, err = x[:-1], ValueError
    else:
        x, err = torch.zeros((8, bf.NF)).T, ValueError
    with pytest.raises(err):
        bf._check("fs", x, torch.float32, (bf.NF, 8), torch.device("cpu"))


@pytest.mark.parametrize("device,tier", [("cpu", "torch"), ("cuda", "fused")])
def test_resolve_tiers(cornell, device, tier):
    _, scene = cornell
    assert dispatch.resolve(scene, PathTracerConfig(),
                            device).kernel_tier == tier


def test_resolve_refuses_plain_tier_on_cuda(cornell):
    _, scene = cornell
    with pytest.raises(ValueError, match="no CUDA path"):
        dispatch.resolve(scene, PathTracerConfig(kernel_tier="torch"),
                         "cuda")


# case: (scene, scene fields, config fields, the name the error gives);
# the external routes of the fused and clustered tiers serve NEE-AT with a
# tile state, WRS K > 1 and more than 128 lights, flat or instanced; a
# pinned kernel tier does not serve NEE-AT with an environment light, nor
# alpha-tested geometry (opacity micromaps) without the tables'
# micromaps, nor nested priorities on bounce tables without their priority
# switch, which "auto" leaves to the general tier; the split channels are
# served on the fused and clustered tiers (their cases check that; the
# per-row route's refusal is tests/test_torch_cluster.py's)
UNSERVED = {
    "textures": ("cornell", "alpha_textures", dict(kernel_tier="fused"),
                 "alpha-tested textures"),
    "micromaps": ("cornell", dict(tri_opacity=object()),
                  dict(kernel_tier="fused"), "micromaps"),
    "priorities": ("cornell", dict(has_nested_priorities=True),
                   dict(kernel_tier="fused"), "priorities"),
    "split": ("cornell", {}, dict(split_channels=True), "split"),
    "realtime": ("cornell", {}, dict(mode=PTMode.BUILD_STABLE_PLANES),
                 "render mode"),
    "neeat_without_state": ("cornell", {}, dict(nee=NEEMode.NEEAT),
                            "NEE-AT without a tile state"),
    "neeat_environment_pinned": ("sky_cornell", {},
                                 dict(nee=NEEMode.NEEAT,
                                      kernel_tier="fused"),
                                 "NEE-AT with an environment"),
    "environment_without_table": ("sky_cornell", "no_table", {},
                                  "environment table"),
    "instanced_split": ("instanced", {}, dict(split_channels=True), "split"),
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", list(UNSERVED))
def test_resolve_refuses_unserved_features(cornell, small_city,
                                           instanced_city, sky_cornell, case,
                                           device):
    """An unserved feature raises with its name; nothing demotes."""
    which, scene_kw, cfg_kw, name = UNSERVED[case]
    scene = dict(cornell=cornell[1], city=small_city,
                 instanced=instanced_city, sky_cornell=sky_cornell)[which]
    state = None
    if case.startswith("neeat_environment"):
        state = _state(scene.lights.count)
    if scene_kw == "no_table":
        scene = scene.replace(bounce_tables=dataclasses.replace(
            scene.bounce_tables, env=None))
    elif scene_kw == "alpha_textures":
        scene = _alpha_textured(scene)
    else:
        scene = scene.replace(**scene_kw)
    if case in ("split", "instanced_split"):
        # served (tests/test_torch_split_fused.py, _clustered.py), and the
        # scene keeps its tier
        want = "clustered" if which == "instanced" else (
            "fused" if device == "cuda" else "torch")
        cfg = dispatch.resolve(scene, PathTracerConfig(**cfg_kw), device)
        assert cfg.kernel_tier == want and cfg.split_channels
        assert name == "split"
        return
    if case == "priorities":
        # served where the tables carry the priority switch (prepare sets
        # it, tests/test_torch_prio.py); "auto" leaves tables without it
        # to the general tier
        served = scene.replace(bounce_tables=dataclasses.replace(
            scene.bounce_tables, prio=True))
        assert dispatch.resolve(served, PathTracerConfig(**cfg_kw),
                                device).kernel_tier == "fused"
        assert dispatch.resolve(scene, PathTracerConfig(),
                                device).kernel_tier == "xla"
    with pytest.raises(NotImplementedError, match="does not serve") as err:
        dispatch.resolve(scene, PathTracerConfig(**cfg_kw), device, state)
    assert name in str(err.value)


def _alpha_textured(scene):
    """The scene with a texture and an alpha-tested material that binds it
    as base colour, and the classes of prepare's opacity bake, but tables
    without the micromaps: a pinned kernel tier refuses it (prepare builds
    the micromaps into the tables, tests/test_torch_omm.py), and so does
    the TLAS route of a two-level scene, which has no alpha test."""
    mats = scene.materials
    n = mats.alpha_cutoff.shape[0]
    return scene.replace(textures=object(), tri_opacity=object(),
                         materials=mats.replace(
                             alpha_cutoff=torch.full((n,), 0.5),
                             base_color_tex=torch.zeros((n,),
                                                        dtype=torch.int32)))


# cases that were refused before the environment slice and are served now:
# case -> (scene, scene change, config fields, the tier "auto" serves it on,
# CPU tensors; pinned to that tier it is served too)
SERVED = {
    "environment": ("sky_cornell", None, {}, "fused"),
    "neeat": ("city", None, dict(nee=NEEMode.NEEAT), "clustered"),
    "wrs": ("city", None, dict(nee_candidates=4), "clustered"),
    "lights": ("city", "lights", {}, "clustered"),
    "neeat_environment": ("sky_cornell", None, dict(nee=NEEMode.NEEAT),
                          "xla"),
    "instanced_neeat": ("instanced", None, dict(nee=NEEMode.NEEAT),
                        "clustered"),
    "instanced_wrs": ("instanced", None, dict(nee_candidates=4),
                      "clustered"),
    "instanced_lights": ("instanced", "lights", {}, "clustered"),
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", list(SERVED))
def test_resolve_serves_environment_and_clustered_external_nee(
        small_city, instanced_city, sky_cornell, case, device):
    """The environment on the fused tier (named "torch" on CPU tensors);
    NEE-AT, WRS K = 4 and more than 128 lights on the clustered tier with
    nee_external, flat and instanced; NEE-AT with an environment light on
    "xla" under "auto", as in the JAX package (a pinned kernel tier
    raises: UNSERVED["neeat_environment_pinned"])."""
    which, change, cfg_kw, tier = SERVED[case]
    scene = dict(city=small_city, instanced=instanced_city,
                 sky_cornell=sky_cornell)[which]
    if change == "lights":
        scene = _more_lights(scene)
    state = _state(scene.lights.count) if "neeat" in case else None
    cfg = PathTracerConfig(**cfg_kw)
    assert not dispatch.unsupported_features(scene, cfg, state, tier)
    want = "torch" if tier == "fused" and device == "cpu" else tier
    for asked in (cfg, dataclasses.replace(cfg, kernel_tier=tier)):
        out = dispatch.resolve(scene, asked, device, state)
        assert out.kernel_tier == (want if asked is cfg else tier)
        assert out.nee_external == (tier == "clustered")
    if case == "environment":
        assert scene.bounce_tables.env is not None
        assert scene.lights.env_light >= 0


@pytest.fixture(scope="module")
def rooms72():
    """144 light triangles: past the kernel's 128-column light table."""
    scene = prepare(TP.rooms_scene(72, subdiv=1), device="cpu")
    assert scene.bounce_tables.n_tris == 722
    assert scene.lights.count == 144 > bf.MAX_LIGHTS
    return scene


@pytest.mark.parametrize("device,tier", [("cuda", "fused"), ("cpu", "torch")])
@pytest.mark.parametrize("case", ["neeat", "wrs", "lights"])
def test_resolve_serves_external_nee_on_the_fused_tier(cornell, rooms72,
                                                       case, device, tier):
    """NEE-AT with a tile state, WRS K = 4 and rooms_scene(72, 1) resolve
    to the fused tier (named "torch" on CPU tensors) with nee_external."""
    scene, state = cornell[1], None
    cfg = PathTracerConfig()
    if case == "neeat":
        cfg, state = PathTracerConfig(nee=NEEMode.NEEAT), _state(2)
    elif case == "wrs":
        cfg = PathTracerConfig(nee_candidates=4)
    else:
        scene = rooms72
    for want, asked in ((tier, cfg),
                        ("fused", dataclasses.replace(cfg,
                                                      kernel_tier="fused"))):
        out = dispatch.resolve(scene, asked, device, state)
        assert out.kernel_tier == want and out.nee_external
    # the in-kernel route stays where it serves
    assert not dispatch.resolve(cornell[1], PathTracerConfig(), device
                                ).nee_external


@pytest.mark.parametrize("part", ["lights", "state"])
def test_resolve_refuses_parts_on_another_device(cornell, part):
    """A light list or NEE-AT state off the tables' device raises; it
    would otherwise meet the tables only inside a kernel."""
    _, scene = cornell
    cfg, state = PathTracerConfig(nee=NEEMode.NEEAT), _state(2)
    if part == "lights":
        scene = scene.replace(lights=types.SimpleNamespace(
            kind=scene.lights.kind.to("meta"), env_light=-1, count=2))
    else:
        state = _state(2, device="meta")
    with pytest.raises(ValueError, match="one device"):
        dispatch.resolve(scene, cfg, "cpu", state)


def test_config_matches_jax_package():
    """The port's config tree is the JAX package's, field for field."""
    jf = {f.name: f.default for f in dataclasses.fields(
        jconfig.PathTracerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(
        tconfig.PathTracerConfig)}
    assert list(jf) == list(tf)
    for name in jf:
        a, b = jf[name], tf[name]
        if hasattr(a, "value"):
            a, b = (a.name, a.value), (b.name, b.value)
        assert a == b, name
    jr = {f.name: f.default for f in dataclasses.fields(
        jconfig.RenderConfig)}
    tr = {f.name: f.default for f in dataclasses.fields(
        tconfig.RenderConfig)}
    assert list(jr) == list(tr)
    for name in jr:
        a, b = jr[name], tr[name]
        if hasattr(a, "value"):
            a, b = (a.name, a.value), (b.name, b.value)
        assert a == b, name
    for je, te in ((jconfig.NEEMode, tconfig.NEEMode),
                   (jconfig.PTMode, tconfig.PTMode),
                   (jconfig.DenoiserMode, tconfig.DenoiserMode)):
        assert [(m.name, m.value) for m in je] == \
            [(m.name, m.value) for m in te]
    # either package's config drives the port
    kc = bf.KernelConfig.from_cfg(jconfig.PathTracerConfig(
        nee=jconfig.NEEMode.UNIFORM, max_bounces=3))
    assert kc == bf.KernelConfig.from_cfg(tconfig.PathTracerConfig(
        nee=tconfig.NEEMode.UNIFORM, max_bounces=3))


# the general tier ("xla"): case -> (scene fields, config fields, trace
# arguments, the name the error gives); alpha-tested geometry is served on
# a flat scene (tests/test_torch_omm.py), refused on the TLAS route of a
# two-level scene; nested priorities are served (the false-hit retrace,
# tests/test_torch_prio.py), and so are the split channels and the aux
# buffers (tests/test_torch_split_general.py) and the real-time arguments
# first_hit, bounce_budget and first_direct=False
# (tests/test_torch_vbuffer.py, test_torch_stable_planes.py), so their
# cases check that
UNSERVED_XLA = {
    "textures": ("alpha_textures", {}, {}, "alpha-tested textures"),
    "micromaps": ("tri_opacity", {}, {}, "micromaps"),
    "priorities": (dict(has_nested_priorities=True), {}, {}, "priorities"),
    "split": ({}, dict(split_channels=True), {}, "split"),
    "want_aux": ({}, {}, {}, "aux buffers"),
    "first_hit": ({}, {}, dict(first_hit=object()), "first_hit"),
    "bounce_budget": ({}, {}, dict(bounce_budget=object()),
                      "bounce_budget"),
    "first_direct": ({}, {}, dict(first_direct=False), "first_direct"),
    "neeat_without_state": ({}, dict(nee=NEEMode.NEEAT), {},
                            "NEE-AT without a tile state"),
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", list(UNSERVED_XLA))
def test_general_tier_refuses_unserved_features(cornell, instanced_city,
                                                 case, device):
    """On the general tier an unserved feature raises with its name."""
    scene_kw, cfg_kw, call, name = UNSERVED_XLA[case]
    scene = cornell[1]
    if scene_kw == "tri_opacity":
        scene = instanced_city.replace(tri_opacity=object())
    elif scene_kw == "alpha_textures":
        scene = _alpha_textured(instanced_city)
    else:
        scene = scene.replace(**scene_kw)
    cfg = PathTracerConfig(kernel_tier="xla", **cfg_kw)
    if case in ("priorities", "split", "want_aux", "first_hit",
                "bounce_budget", "first_direct"):
        for s in (scene, instanced_city.replace(**scene_kw)):
            assert dispatch.resolve(s, cfg, device,
                                    **call).kernel_tier == "xla"
        if case == "want_aux" and device == "cpu":
            # no argument to refuse: the trace returns the buffers
            out = render_sample(scene, TP.default_camera(cornell[0], 4, 4),
                                cfg, 4, 4, 0, want_aux=True)
            assert name == "aux buffers" and {
                "albedo", "normal", "depth", "wpos", "emission"} <= set(out)
        return
    with pytest.raises(NotImplementedError,
                       match="xla tier does not serve") as err:
        dispatch.resolve(scene, cfg, device, **call)
    assert name in str(err.value)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", ["environment", "sphere_light"])
def test_general_tier_serves_environment_and_spheres(cornell, sky_cornell,
                                                     case, device):
    """The general tier serves the environment and sphere lights; a scene
    whose lights hold a sphere resolves to it under "auto" (the JAX
    package builds no kernel tables for it), and a pinned kernel tier
    raises, naming it."""
    xla = PathTracerConfig(kernel_tier="xla")
    if case == "environment":
        scene = sky_cornell
        assert dispatch.resolve(scene, xla, device).kernel_tier == "xla"
        return
    scene = cornell[1]
    kind = scene.lights.kind.clone()
    kind[-1] = KIND_SPHERE
    scene = scene.replace(lights=dataclasses.replace(scene.lights,
                                                     kind=kind))
    for cfg in (xla, PathTracerConfig()):
        assert dispatch.resolve(scene, cfg, device).kernel_tier == "xla"
    with pytest.raises(NotImplementedError, match="sphere"):
        dispatch.resolve(scene, PathTracerConfig(kernel_tier="fused"),
                         device)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_resolve_serves_the_general_tier(cornell, small_city, device):
    """kernel_tier="xla" keeps its name on both devices, for the prepared
    Cornell box and city alike; a scene with only a BVH resolves to it
    under "auto", and the prepared scenes keep their tiers."""
    _, scene = cornell
    xla = PathTracerConfig(kernel_tier="xla")
    for s in (scene, small_city):
        assert dispatch.resolve(s, xla, device).kernel_tier == "xla"
    bvh_only = scene.replace(bounce_tables=None)
    assert dispatch.resolve(bvh_only, PathTracerConfig(),
                            device).kernel_tier == "xla"
    auto = PathTracerConfig()
    assert dispatch.resolve(scene, auto, device).kernel_tier == (
        "fused" if device == "cuda" else "torch")
    assert dispatch.resolve(small_city, auto,
                            device).kernel_tier == "clustered"
    for tier in ("fused", "clustered"):
        with pytest.raises(ValueError, match="does not run"):
            dispatch.resolve(bvh_only, PathTracerConfig(kernel_tier=tier),
                             device)
    with pytest.raises(ValueError, match="needs the scene's BVH"):
        dispatch.resolve(scene.replace(bvh=None), xla, device)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_resolve_serves_instancing(instanced_city, device):
    """A two-level scene with instanced cluster tables resolves to the
    clustered tier under "auto" and to the TLAS walk with "xla"; without
    cluster tables (a small instanced scene) it resolves to "xla", as in
    the JAX package; nothing refuses the TLAS."""
    scene = instanced_city
    assert scene.tlas is not None and scene.cluster_tables.instanced
    auto = dispatch.resolve(scene, PathTracerConfig(), device)
    assert (auto.kernel_tier, auto.cluster_kslots, auto.cluster_pages) == \
        ("clustered", 32, 1)
    xla = dispatch.resolve(scene, PathTracerConfig(kernel_tier="xla"),
                           device)
    assert xla.kernel_tier == "xla"
    tlas_only = scene.replace(cluster_tables=None)
    assert dispatch.resolve(tlas_only, PathTracerConfig(),
                            device).kernel_tier == "xla"
    assert not dispatch.unsupported_features(tlas_only, PathTracerConfig())
    with pytest.raises(ValueError, match="does not run"):
        dispatch.resolve(tlas_only, PathTracerConfig(kernel_tier="clustered"),
                         device)


def test_prepare_builds_a_bvh_for_every_scene(cornell, small_city):
    """Both prepared scenes carry the LBVH and the packs; the small scene
    has brute tables, the city (3,512 triangles) too, and a BVH-only scene
    renders through the general tier on the CPU without launching a
    kernel."""
    host, scene = cornell
    for s, n_tris in ((scene, 36), (small_city, 3512)):
        assert s.bvh.num_triangles == n_tris == s.tri_pack.shape[0]
        assert s.bvh.num_nodes == 2 * n_tris - 1
        assert s.bvh.brute is not None and s.mat_pack.shape[1] == 18
    kernels.launches.clear()
    out = render_sample(scene.replace(bounce_tables=None),
                        TP.default_camera(host, 8, 8),
                        PathTracerConfig(max_bounces=2), 8, 8, 0)
    assert out["kernel_tier"] == "xla" and not kernels.launches
    assert torch.isfinite(out["L"]).all()

"""Package rules of rtxpt_tpu_torch: no JAX anywhere in the port, the
kernel layer imports without nvcc or a GPU, CPU tensors never count a
kernel launch, and the dispatch refuses what the kernel does not serve
instead of demoting it."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rtxpt_tpu.config as jconfig
from rtxpt_tpu_torch import config as tconfig
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig, PTMode
from rtxpt_tpu_torch.lighting.envmap import EnvMap
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
    "rtxpt_tpu_torch.scene.procedural", "rtxpt_tpu_torch.lighting.envmap",
    "rtxpt_tpu_torch.lighting.lights_baker", "rtxpt_tpu_torch.pt.bsdf",
    "rtxpt_tpu_torch.pt.wide", "rtxpt_tpu_torch.pt.bounce_fused",
    "rtxpt_tpu_torch.pt.dispatch", "rtxpt_tpu_torch.pt.integrator",
    "rtxpt_tpu_torch.render.postprocess", "rtxpt_tpu_torch.apps.cli",
    "rtxpt_tpu_torch.accel.cluster", "rtxpt_tpu_torch.accel.cull",
    "rtxpt_tpu_torch.ops.wavefront", "rtxpt_tpu_torch.pt.bounce_clustered",
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
    """prepare and scene_from_numpy run on the GPU unless the caller asks
    for the CPU; without a GPU they raise instead of quietly running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = TP.cornell_box()
    with pytest.raises(RuntimeError, match="is_available"):
        prepare(host)
    with pytest.raises(RuntimeError, match="is_available"):
        scene_from_numpy({})
    with pytest.raises(RuntimeError, match="is_available"):
        cluster_scene_from_numpy({})
    assert prepare(host, device="cpu").bounce_tables.device.type == "cpu"


@pytest.fixture(scope="module")
def cornell():
    host = TP.cornell_box()
    return host, prepare(host, device="cpu")


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


UNSERVED = {
    "environment": (dict(envmap=EnvMap(np.ones((4, 8, 3), np.float32), 1.0,
                                       0.0, np.ones(3, np.float32))), {}),
    "textures": (dict(textures=object()), {}),
    "micromaps": (dict(tri_opacity=object()), {}),
    "priorities": (dict(has_nested_priorities=True), {}),
    "split": ({}, dict(split_channels=True)),
    "neeat": ({}, dict(nee=NEEMode.NEEAT)),
    "wrs": ({}, dict(nee_candidates=4)),
    "realtime": ({}, dict(mode=PTMode.BUILD_STABLE_PLANES)),
    "lights": ("lights", {}),
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", list(UNSERVED))
def test_resolve_refuses_unserved_features(cornell, case, device):
    """An unserved feature raises with its name; nothing demotes."""
    _, scene = cornell
    scene_kw, cfg_kw = UNSERVED[case]
    if scene_kw == "lights":
        scene = scene.replace(bounce_tables=dataclasses.replace(
            scene.bounce_tables, n_lights=bf.MAX_LIGHTS + 1))
    else:
        scene = scene.replace(**scene_kw)
    with pytest.raises(NotImplementedError, match="does not serve"):
        dispatch.resolve(scene, PathTracerConfig(**cfg_kw), device)


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
    for je, te in ((jconfig.NEEMode, tconfig.NEEMode),
                   (jconfig.PTMode, tconfig.PTMode)):
        assert [(m.name, m.value) for m in je] == \
            [(m.name, m.value) for m in te]
    # either package's config drives the port
    kc = bf.KernelConfig.from_cfg(jconfig.PathTracerConfig(
        nee=jconfig.NEEMode.UNIFORM, max_bounces=3))
    assert kc == bf.KernelConfig.from_cfg(tconfig.PathTracerConfig(
        nee=tconfig.NEEMode.UNIFORM, max_bounces=3))

"""Scene side of the port against the JAX package: procedural host scenes,
camera rays, the lights bake, the fused bounce tables (entry by entry),
and scenes carried across from the JAX package's prepared tables."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtxpt_tpu.lighting.envmap import bake_envmap as j_bake_envmap
from rtxpt_tpu.lighting.lights_baker import bake_lights as j_bake_lights
from rtxpt_tpu.prepare import scene_radius as j_scene_radius
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.scene import camera as jcam
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.accel import cluster
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.lighting.envmap import bake_envmap as t_bake_envmap
from rtxpt_tpu_torch.lighting.lights_baker import bake_lights as t_bake_lights
from rtxpt_tpu_torch.prepare import prepare, scene_from_numpy
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render
from rtxpt_tpu_torch.scene import camera as tcam
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.scene.scene import LIGHT_SPHERE, Materials

SCENES = {
    "cornell": (JP.cornell_box, TP.cornell_box, {}),
    "cornell_specular": (JP.cornell_box, TP.cornell_box,
                         dict(sphere_specular=True)),
    "furnace": (JP.furnace_box, TP.furnace_box,
                dict(albedo=0.8, emission=0.5)),
    "triangle_point": (JP.single_triangle, TP.single_triangle,
                       dict(light_kind="point")),
    "triangle_directional": (JP.single_triangle, TP.single_triangle,
                             dict(light_kind="directional")),
    "triangle_sphere": (JP.single_triangle, TP.single_triangle,
                        dict(light_kind="sphere")),
}
KERNEL_SCENES = [k for k in SCENES if k != "triangle_sphere"]


def _hosts(name):
    jf, tf, kw = SCENES[name]
    return jf(**kw), tf(**kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_lights(jhost):
    sd = jhost.flatten()
    envmap = j_bake_envmap(None)
    lights = j_bake_lights(sd, envmap,
                           j_scene_radius(np.asarray(sd.geometry.positions)))
    return sd, lights


@pytest.mark.parametrize("name", list(SCENES))
def test_procedural_host_scene_identical(name):
    jh, th = _hosts(name)
    assert len(jh.instances) == len(th.instances)
    for ji, ti in zip(jh.instances, th.instances):
        for field in ("positions", "normals", "uvs", "indices", "material",
                      "transform"):
            np.testing.assert_array_equal(getattr(ji, field),
                                          getattr(ti, field), err_msg=field)
    for field in ("base_color", "metallic", "roughness", "ior",
                  "transmission", "diffuse_transmission", "emissive",
                  "specular_f0_scale", "thin", "alpha_cutoff",
                  "volume_absorption", "base_color_tex", "emissive_tex",
                  "metal_rough_tex", "normal_tex", "nested_priority",
                  "anisotropy"):
        np.testing.assert_array_equal(_np(getattr(jh.materials, field)),
                                      _np(getattr(th.materials, field)),
                                      err_msg=field)
    if jh.analytic_lights is not None:
        for field in ("kind", "position", "direction", "intensity",
                      "angular_size", "cos_inner", "cos_outer"):
            np.testing.assert_array_equal(
                _np(getattr(jh.analytic_lights, field)),
                _np(getattr(th.analytic_lights, field)), err_msg=field)
    assert jh.camera == th.camera
    jg, tg = jh.flatten().geometry, th.flatten().geometry
    for field in ("positions", "normals", "uvs", "indices", "tri_material",
                  "tri_subinstance"):
        np.testing.assert_array_equal(_np(getattr(jg, field)),
                                      _np(getattr(tg, field)), err_msg=field)


@pytest.mark.parametrize("size", [(32, 32), (48, 20)])
def test_camera_ray(size):
    w, h = size
    jh, th = _hosts("cornell")
    jc = JP.default_camera(jh, w, h)
    tc = TP.default_camera(th, w, h)
    g = np.random.default_rng(0)
    px = g.integers(0, w, 500).astype(np.int32)
    py = g.integers(0, h, 500).astype(np.int32)
    u1, u2 = g.uniform(0, 1, (2, 500)).astype(np.float32)
    jo, jd, js = jcam.camera_ray(jc, jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(u1), jnp.asarray(u2))
    to, td, ts = tcam.camera_ray(tc, torch.from_numpy(px),
                                 torch.from_numpy(py), torch.from_numpy(u1),
                                 torch.from_numpy(u2))
    for a, b in ((jo, to), (jd, td), (js, ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
def test_bake_lights(name):
    jh, th = _hosts(name)
    _, jl = _jax_lights(jh)
    sd = th.flatten()
    tl = t_bake_lights(sd, t_bake_envmap(None, device="cpu"),
                       j_scene_radius(sd.geometry.positions.numpy()),
                       device="cpu")
    for field in ("kind", "p0", "p1", "p2", "emission", "extra", "normal",
                  "power", "cdf", "tri_light"):
        np.testing.assert_allclose(_np(getattr(tl, field)),
                                   np.asarray(getattr(jl, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    assert tl.env_light == int(jl.env_light) == -1
    assert tl.num == int(jl.num)


@pytest.mark.parametrize("name", KERNEL_SCENES)
def test_build_bounce_tables(name):
    jh, th = _hosts(name)
    jsd, jl = _jax_lights(jh)
    g = jsd.geometry
    jt = bp.build_bounce_tables(
        np.asarray(g.positions), np.asarray(g.normals), np.asarray(g.indices),
        np.asarray(g.tri_material), jsd.materials, jl,
        uvs=np.asarray(g.uvs))
    tt = prepare(th, device="cpu").bounce_tables
    for field in ("tri_rows", "attr_rows", "mat_rows", "light_rows"):
        a = np.asarray(getattr(jt, field))
        b = getattr(tt, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=field)
    assert (tt.tc, tt.n_chunks, tt.n_lights, tt.n_tris) == \
        (jt.tc, jt.n_chunks, jt.n_lights, jt.n_tris)
    # the kernel's compact rows hold the same coefficients
    coef = tt.tri_coef.numpy()
    rows = tt.tri_rows.numpy().reshape(tt.n_chunks, 4, tt.tc, 128)
    flat = rows.transpose(1, 0, 2, 3).reshape(4, tt.tc * tt.n_chunks, 128)
    np.testing.assert_array_equal(coef[:, bf.TC_DET:bf.TC_DET + 3],
                                  flat[0, :, 0:3])
    np.testing.assert_array_equal(coef[:, bf.TC_U:bf.TC_U + 6],
                                  flat[1, :, 0:6])
    np.testing.assert_array_equal(coef[:, bf.TC_V:bf.TC_V + 6],
                                  flat[2, :, 0:6])
    np.testing.assert_array_equal(coef[:, bf.TC_T:bf.TC_T + 4],
                                  flat[3, :, 6:10])


def _jax_tables(jax_scene):
    jt = jax_scene.bounce_tables
    return dict(tri_rows=np.asarray(jt.tri_rows),
                attr_rows=np.asarray(jt.attr_rows),
                mat_rows=np.asarray(jt.mat_rows),
                light_rows=np.asarray(jt.light_rows), tc=jt.tc,
                n_chunks=jt.n_chunks, n_lights=jt.n_lights, n_tris=jt.n_tris,
                env_rows=jt.env_rows, tex_ct=jt.tex_ct, omm=jt.omm,
                prio=jt.prio)


def test_scene_from_numpy_renders_identically(cornell_scene):
    """The JAX package's prepared Cornell tables, carried across as numpy,
    render bit-identically to the port's own prepare."""
    jhost, jscene = cornell_scene
    th = TP.cornell_box()
    carried = scene_from_numpy(_jax_tables(jscene), device="cpu")
    own = prepare(th, device="cpu")
    cam = TP.default_camera(th, 16, 16)
    cfg = PathTracerConfig(max_bounces=3)
    a, _, ra = render(carried, cam, cfg, 16, 16, spp=2)
    b, _, rb = render(own, cam, cfg, 16, 16, spp=2)
    assert torch.equal(a, b) and ra == rb


def test_scene_from_numpy_refuses_unported_parts(cornell_scene):
    """The priority switch (prio) is carried across, as are the
    environment table (env_rows, tests/test_torch_env.py), the texture
    tables (tests/test_torch_textures.py) and the micromap row groups
    (tests/test_torch_omm.py), which omm tables must carry and without
    which they raise by name."""
    tables = _jax_tables(cornell_scene[1])
    assert not scene_from_numpy(tables, device="cpu").bounce_tables.prio
    tables["prio"] = True
    assert scene_from_numpy(tables, device="cpu").bounce_tables.prio
    tables = _jax_tables(cornell_scene[1])
    tables["omm"] = True
    with pytest.raises(ValueError, match="omm"):
        scene_from_numpy(tables, device="cpu")
    tables = _jax_tables(cornell_scene[1])
    tables["env_rows"] = np.zeros((bp.EV_ROWS, 128), np.float32)
    assert scene_from_numpy(tables, device="cpu").bounce_tables.env.shape \
        == (bf.ET_SIZE,)


@pytest.mark.parametrize("case", ["sphere_light", "env_image", "instancing"])
def test_prepare_serves_sphere_and_environment_lights(case):
    """Sphere lights get no kernel tables (the general tier samples them,
    as in the JAX package), also on a two-level scene above 2048 world
    triangles; an environment image is baked at the kernels' 64 x 128
    into the fused tables."""
    host = TP.single_triangle("sphere" if case == "sphere_light" else "point")
    if case == "instancing":
        host = TP.instanced_city(grid=2, subdiv=6)
        al = host.analytic_lights
        host.analytic_lights = dataclasses.replace(
            al, kind=torch.full_like(al.kind, LIGHT_SPHERE))
    elif case == "env_image":
        host.envmap_image = np.ones((8, 16, 3), np.float32)
    scene = prepare(host, device="cpu")
    if case == "env_image":
        assert scene.envmap.shape == (bf.ENV_H, bf.ENV_W)
        assert scene.bounce_tables.env is not None
        assert scene.lights.env_light >= 0
    else:
        assert scene.bounce_tables is None and scene.cluster_tables is None
        assert (scene.tlas if case == "instancing" else scene.bvh) is not None


@pytest.mark.parametrize("case", ["textures", "too_many_tris"])
def test_prepare_refuses_unported_features(case, monkeypatch):
    host = TP.single_triangle("point")
    kw = {}
    if case == "textures":
        # alpha-tested textures get opacity micromaps on a flat scene
        # (tests/test_torch_omm.py); a two-level scene cannot carry them,
        # so instancing="force" refuses them, as in the JAX package
        host.textures = [np.ones((4, 4, 4), np.float32)]
        n = host.materials.alpha_cutoff.shape[0]
        host.materials = host.materials.replace(
            alpha_cutoff=torch.full((n,), 0.5),
            base_color_tex=torch.zeros((n,), dtype=torch.int32))
        kw = dict(instancing="force")
    elif case == "too_many_tris":
        # above 2048 triangles the clustered tier takes the scene, up to
        # its device block budget (shrunk here so a small scene passes
        # it); past it the cluster builder returns None, as the JAX one,
        # and the general tier takes the scene: "auto" resolves to it and
        # a pinned clustered tier names the budget
        monkeypatch.setattr(cluster, "MAX_CLUSTERS", 0)
        inst = host.instances[0]
        inst.indices = np.tile(inst.indices, (bf.MAX_TRIS + 1, 1))
        inst.material = np.zeros(len(inst.indices), np.int32)
        _assert_general_tier(prepare(host, device="cpu"), "clustered",
                             "clusters")
        return
    with pytest.raises(ValueError, match="alpha-tested textures"):
        prepare(host, device="cpu", **kw)


def _assert_general_tier(scene, tier, feature):
    """No kernel tables: "auto" resolves to "xla", and `tier` pinned
    raises NotImplementedError naming `feature`."""
    assert scene.bounce_tables is None and scene.cluster_tables is None
    assert scene.bvh is not None
    assert dispatch.resolve(scene, PathTracerConfig(),
                            "cpu").kernel_tier == "xla"
    with pytest.raises(NotImplementedError,
                       match=f"{tier} tier does not serve: .*{feature}"):
        dispatch.resolve(scene, PathTracerConfig(kernel_tier=tier), "cpu")


def _with_materials(m, n):
    """Materials `m` padded to `n` with Materials.create's defaults."""
    extra = Materials.create(n - m.base_color.shape[0])
    return Materials(**{f.name: torch.cat([getattr(m, f.name),
                                           getattr(extra, f.name)])
                        for f in dataclasses.fields(m)})


@pytest.mark.parametrize("tier", ["fused", "clustered"])
@pytest.mark.parametrize("case", ["anisotropic", "materials"])
def test_prepare_leaves_unserved_scenes_to_the_general_tier(case, tier):
    """Anisotropic materials and more than 128 materials: the fused and
    cluster builders return None, as the JAX package's do
    (bounce_pallas.py:424-426, :442-443; accel/cluster.py:392-394,
    :402-403), prepare builds no kernel tables, "auto" takes the general
    tier and a pinned kernel tier raises naming the feature. The fused
    case is the Cornell box, the clustered one the small city."""
    host = (TP.cornell_box() if tier == "fused" else
            TP.city_scene(tri_budget=4000, seed=1, blocks=2))
    m = host.materials
    if case == "anisotropic":
        host.materials = m.replace(anisotropy=torch.where(
            torch.arange(len(m.anisotropy)) == 0, 0.5, m.anisotropy))
    else:
        host.materials = _with_materials(m, bf.MAX_MATERIALS + 2)
    if tier == "fused":
        jh = JP.cornell_box()
        jm = jh.materials
        jm = (jm.replace(anisotropy=jm.anisotropy.at[0].set(0.5))
              if case == "anisotropic" else
              jm.replace(**{f.name: jnp.asarray(getattr(host.materials,
                                                        f.name).numpy())
                            for f in dataclasses.fields(host.materials)}))
        jsd, jl = _jax_lights(jh)
        g = jsd.geometry
        assert bp.build_bounce_tables(
            np.asarray(g.positions), np.asarray(g.normals),
            np.asarray(g.indices), np.asarray(g.tri_material), jm, jl,
            uvs=np.asarray(g.uvs)) is None
    scene = prepare(host, device="cpu")
    assert (scene.geometry.num_triangles > bf.MAX_TRIS) == (
        tier == "clustered")
    _assert_general_tier(scene, tier, "anisotropic" if case == "anisotropic"
                         else f"{bf.MAX_MATERIALS + 2} materials")

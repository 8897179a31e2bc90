"""rtxpt_tpu_torch.pt.wide against rtxpt_tpu.pt.wide on the same random
numpy inputs: BSDF construction (with Kulla-Conty energy compensation),
eval, split eval, pdf and sample, and the light sample for every
non-environment light kind. Both sides run the same float32 elementwise
math, so they agree to rtol 1e-5, atol 1e-6. A sampled direction goes
through sin/cos, which the two libraries round differently in the last
ulp, and near the peak of a sharp GGX lobe the pdf turns such ulps into
relative errors of order 1/alpha^2. So sampled directions are held to
rtol 1e-4, atol 1e-5, and the weight and pdf at the sampled direction to
the same wherever alpha >= 0.1 (every Cornell material has alpha = 1)
and on delta lobes, whose weight needs no trig."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.pt import wide as JW
from rtxpt_tpu.pt.bsdf import bake_e_poly_np as j_bake_e_poly
from rtxpt_tpu_torch.pt import wide as TW
from rtxpt_tpu_torch.pt.bsdf import bake_e_poly_np as t_bake_e_poly

N = 2048
RTOL, ATOL = 1e-5, 1e-6
TRIG_RTOL, TRIG_ATOL = 1e-4, 1e-5


def _close(a, b, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _unit(g, n, upper=None):
    v = g.normal(size=(3, n))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    if upper is not None:
        v[2] = np.abs(v[2]) * upper
    return v.astype(np.float32)


def _inputs(seed, kind):
    """BSDF parameters for one material family ("diffuse", "metal",
    "glass", "mixed")."""
    g = np.random.default_rng(seed)
    f = lambda lo, hi: g.uniform(lo, hi, N).astype(np.float32)
    zero = np.zeros(N, np.float32)
    p = dict(base_color=g.uniform(0, 1, (3, N)).astype(np.float32),
             metallic=zero, roughness=f(0.3, 1.0), ior=f(1.0, 2.4),
             transmission=zero, diffuse_transmission=zero,
             specular_scale=f(0.0, 1.0), front=g.uniform(0, 1, N) < 0.7,
             cur_ior=np.where(g.uniform(0, 1, N) < 0.5, 1.0,
                              f(1.0, 1.8)).astype(np.float32),
             below_ior=f(1.0, 1.6))
    if kind == "metal":
        p["metallic"] = np.ones(N, np.float32)
        p["roughness"] = f(0.0, 0.6)
    elif kind == "glass":
        p["transmission"] = np.ones(N, np.float32)
        p["roughness"] = np.where(g.uniform(0, 1, N) < 0.3, 0.0,
                                  f(0.05, 0.8)).astype(np.float32)
    elif kind == "mixed":
        p["metallic"] = f(0, 1)
        p["transmission"] = f(0, 1)
        p["diffuse_transmission"] = f(0, 1)
        p["roughness"] = f(0.0, 1.0)
    return g, p


def _bsdfs(p, energy=True):
    alpha = np.clip(p["roughness"].astype(np.float64) ** 2, 0.0, 1.0)
    ej, aj = j_bake_e_poly(alpha)
    et, at = t_bake_e_poly(alpha)
    np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(aj, at)
    keys = ("base_color", "metallic", "roughness", "ior", "transmission",
            "diffuse_transmission", "specular_scale", "front", "cur_ior",
            "below_ior")
    jb = JW.make_bsdf_w(*(jnp.asarray(p[k]) for k in keys),
                        e_poly=jnp.asarray(ej) if energy else None,
                        e_avg=jnp.asarray(aj) if energy else None)
    tb = TW.make_bsdf_w(*(torch.from_numpy(np.asarray(p[k])) for k in keys),
                        e_poly=torch.from_numpy(et) if energy else None,
                        e_avg=torch.from_numpy(at) if energy else None)
    return jb, tb


KINDS = ["diffuse", "metal", "glass", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_make_bsdf_w(kind):
    _, p = _inputs(0, kind)
    jb, tb = _bsdfs(p)
    for field in ("diffuse", "specular_f0", "alpha", "transmission",
                  "diffuse_transmission", "eta", "transmission_color",
                  "e_poly", "e_avg"):
        _close(getattr(jb, field), getattr(tb, field).numpy(), field)


@pytest.mark.parametrize("energy", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_eval_pdf_split(kind, energy):
    g, p = _inputs(1, kind)
    jb, tb = _bsdfs(p, energy)
    wo = _unit(g, N, upper=1.0)
    wi = _unit(g, N)
    jwo, jwi = jnp.asarray(wo), jnp.asarray(wi)
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    _close(JW.bsdf_eval_w(jb, jwo, jwi), TW.bsdf_eval_w(tb, two, twi), "f")
    _close(JW.bsdf_pdf_w(jb, jwo, jwi), TW.bsdf_pdf_w(tb, two, twi), "pdf")
    for a, b, name in zip(JW.bsdf_eval_split_w(jb, jwo, jwi),
                          TW.bsdf_eval_split_w(tb, two, twi),
                          ("f_diffuse", "f_specular")):
        _close(a, b, name)


@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_sample(kind):
    g, p = _inputs(2, kind)
    jb, tb = _bsdfs(p)
    wo = _unit(g, N, upper=1.0)
    u = g.uniform(0, 1, (3, N)).astype(np.float32)
    js = JW.bsdf_sample_w(jb, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    ts = TW.bsdf_sample_w(tb, torch.from_numpy(wo),
                          *(torch.from_numpy(x) for x in u))
    for key in ("lobe", "is_delta", "valid"):
        np.testing.assert_array_equal(np.asarray(js[key]),
                                      ts[key].numpy(), err_msg=key)
    _close(js["wi"], ts["wi"], "wi", TRIG_RTOL, TRIG_ATOL)
    held = (np.asarray(jb.alpha) >= 0.1) | np.asarray(js["is_delta"])
    assert held.mean() > 0.5
    for key in ("weight", "pdf"):
        _close(np.asarray(js[key])[..., held], ts[key].numpy()[..., held],
               key, TRIG_RTOL, TRIG_ATOL)


def _light_fields(g, kind, n):
    f32 = lambda a: np.asarray(a, np.float32)
    p0 = f32(g.uniform(-1, 1, (3, n)) + np.asarray([[0], [2], [0]]))
    p1 = f32(g.uniform(-0.5, 0.5, (3, n)))
    p2 = f32(g.uniform(-0.5, 0.5, (3, n)))
    normal = -np.cross(p1.T, p2.T).T
    area = 0.5 * np.linalg.norm(normal, axis=0)
    normal = f32(normal / np.maximum(2 * area, 1e-12))
    extra = f32(np.stack([area, np.zeros(n), np.zeros(n), np.zeros(n)]))
    if kind == 3:          # spot: cos_inner, cos_outer
        extra[0] = g.uniform(0.8, 1.0, n)
        extra[1] = g.uniform(0.3, 0.8, n)
        p1 = f32(p1 / np.linalg.norm(p1, axis=0, keepdims=True))
    if kind == 2:          # directional: unit direction
        p1 = f32(p1 / np.linalg.norm(p1, axis=0, keepdims=True))
    return dict(kind=np.full(n, kind, np.int32), p0=p0, p1=p1, p2=p2,
                em=f32(g.uniform(0, 10, (3, n))), extra=extra,
                normal=normal, power=f32(g.uniform(0.01, 1.0, n)))


@pytest.mark.parametrize("kind", [0, 1, 2, 3],
                         ids=["triangle", "point", "directional", "spot"])
def test_sample_light_fields(kind):
    g = np.random.default_rng(10 + kind)
    lf = _light_fields(g, kind, N)
    pos = g.uniform(-1, 1, (3, N)).astype(np.float32)
    u1, u2 = g.uniform(0, 1, (2, N)).astype(np.float32)
    sel = lf["power"]
    jl = JW.LightFieldsW(**{k: jnp.asarray(v) for k, v in lf.items()})
    tl = TW.LightFieldsW(**{k: torch.from_numpy(v) for k, v in lf.items()})
    js = JW.sample_light_fields_w(jl, jnp.asarray(sel), jnp.asarray(pos),
                                  jnp.asarray(u1), jnp.asarray(u2))
    ts = TW.sample_light_fields_w(tl, torch.from_numpy(sel),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(u1), torch.from_numpy(u2))
    for key in ("is_delta", "valid"):
        np.testing.assert_array_equal(np.asarray(js[key]), ts[key].numpy(),
                                      err_msg=key)
    for key in ("wi", "dist", "Li", "pdf"):
        _close(js[key], ts[key], key)


def test_vec3_helpers():
    g = np.random.default_rng(20)
    a = _unit(g, N)
    b = g.normal(size=(3, N)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(JW.to_local3(jb, ja), TW.to_local3(tb, ta), "to_local3")
    _close(JW.to_world3(jb, ja), TW.to_world3(tb, ta), "to_world3")
    _close(JW.normalize3(jb), TW.normalize3(tb), "normalize3")
    _close(JW.power_heuristic(jb[0], jb[1]), TW.power_heuristic(tb[0], tb[1]),
           "power_heuristic")

"""BSDF (counterpart of rtxpt_tpu/pt/bsdf.py): the constants and
elementwise microfacet terms that pt/wide.py builds on, the host bake of
the per-material Kulla-Conty energy polynomial that the bounce tables
carry (MT_EPOLY / MT_EAVG), and `BSDFData` with `make_bsdf_data`,
`bsdf_eval`, `bsdf_pdf`, `bsdf_eval_split` and `bsdf_sample` over [N, 3]
vectors, which external NEE (pt/nee_external.py) and the general
wavefront (pt/integrator.py) evaluate as the JAX package does: with the
exact energy table, not the kernels' polynomial fit."""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rtxpt_tpu_torch.utils import math as m

DELTA_ALPHA = 1e-4          # alpha below which specular lobes go delta
MIN_COS = 1e-6

LOBE_DIFFUSE_REFL = 0
LOBE_SPECULAR_REFL = 1
LOBE_SPECULAR_TRANS = 2
LOBE_DIFFUSE_TRANS = 3


def ggx_ndf(alpha, hz):
    a2 = alpha * alpha
    den = hz * hz * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * den * den, min=1e-12)


def smith_lambda(alpha, wz):
    wz = torch.clamp(torch.abs(wz), MIN_COS, 1.0)
    a2 = alpha * alpha
    tan2 = (1.0 - wz * wz) / (wz * wz)
    return 0.5 * (torch.sqrt(1.0 + a2 * tan2) - 1.0)


def smith_g1(alpha, wz):
    return 1.0 / (1.0 + smith_lambda(alpha, wz))


def smith_g2(alpha, woz, wiz):
    return 1.0 / (1.0 + smith_lambda(alpha, woz) + smith_lambda(alpha, wiz))


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel; eta = n_i/n_t; cos_i >= 0."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    rp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f)


# ---------------------------------------------------------------------------
# Kulla-Conty energy table (host numpy, the JAX package's bake verbatim)
# ---------------------------------------------------------------------------

_E_RES = 32


@functools.cache
def _energy_tables():
    """(E [32,32], E_avg [32]) float32: directional albedo of the single-
    scatter GGX lobe over (alpha, mu), and its cosine-weighted average.
    Kept in memory only; nothing is written to disk."""
    def _ndf(a, hz):
        a2 = a * a
        den = hz * hz * (a2 - 1.0) + 1.0
        return a2 / np.maximum(np.pi * den * den, 1e-12)

    def _lam(a, wz):
        wz = np.clip(np.abs(wz), MIN_COS, 1.0)
        return 0.5 * (np.sqrt(1.0 + a * a * (1.0 - wz * wz)
                              / (wz * wz)) - 1.0)

    def _g2(a, woz, wiz):
        return 1.0 / (1.0 + _lam(a, woz) + _lam(a, wiz))

    def _g1(a, wz):
        return 1.0 / (1.0 + _lam(a, wz))

    def _vndf(wo, a, u1, u2):
        vh = wo * np.asarray([a, a, 1.0])
        vh = vh / np.linalg.norm(vh, axis=-1, keepdims=True)
        lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
        inv = 1.0 / np.sqrt(np.maximum(lensq, 1e-20))
        t1 = np.where((lensq > 1e-16)[:, None],
                      np.stack([-vh[:, 1] * inv, vh[:, 0] * inv,
                                np.zeros_like(inv)], -1),
                      np.asarray([[1.0, 0.0, 0.0]]))
        t2 = np.cross(vh, t1)
        r = np.sqrt(u1)
        phi = 2.0 * np.pi * u2
        p1 = r * np.cos(phi)
        p2 = r * np.sin(phi)
        sble = 0.5 * (1.0 + vh[:, 2])
        p2 = (1.0 - sble) * np.sqrt(np.maximum(0.0, 1.0 - p1 * p1)) \
            + sble * p2
        nh = (p1[:, None] * t1 + p2[:, None] * t2
              + np.sqrt(np.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[:, None]
              * vh)
        h = np.stack([a * nh[:, 0], a * nh[:, 1],
                      np.maximum(nh[:, 2], 0.0)], -1)
        return h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True),
                              1e-12)

    na = nm = _E_RES
    K = 64
    th = (np.arange(K) + 0.5) / K * (np.pi / 2)
    ph = (np.arange(K) + 0.5) / K * (2 * np.pi)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    wi = np.stack([np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH),
                   np.cos(TH)], -1).reshape(-1, 3)
    dw = (np.pi / 2 / K) * (2 * np.pi / K) * np.sin(TH).reshape(-1)
    g = 64
    gi = (np.arange(g) + 0.5) / g
    u1g = np.repeat(gi, g)
    u2g = np.tile(gi, g)
    mus = np.arange(nm) / (nm - 1.0)
    alphas = (np.arange(na) / (na - 1.0)) ** 2
    E = np.zeros((na, nm), np.float64)
    for ai, a in enumerate(alphas):
        for mi, mu in enumerate(mus):
            wo3 = np.asarray([np.sqrt(max(0.0, 1 - mu * mu)), 0.0, mu])
            if a >= 0.15:
                # wide lobes: exact-eval hemisphere quadrature
                h = wo3[None] + wi
                h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True),
                                   1e-12)
                num = (_ndf(a, h[:, 2]) * _g2(a, mu, wi[:, 2])
                       / max(4.0 * mu, 1e-9))
                ok = (wi[:, 2] > MIN_COS) & (mu > MIN_COS)
                E[ai, mi] = float((np.where(ok, num, 0.0) * dw).sum())
            else:
                # narrow lobes: VNDF-warped grid
                wo_ = np.tile(wo3[None], (g * g, 1))
                h = _vndf(wo_, max(a, 1e-4), u1g, u2g)
                wiv = 2.0 * (wo_ * h).sum(-1, keepdims=True) * h - wo_
                wiv = wiv / np.maximum(
                    np.linalg.norm(wiv, axis=-1, keepdims=True), 1e-12)
                w = np.where((wiv[:, 2] > MIN_COS) & (mu > MIN_COS),
                             _g2(a, mu, wiv[:, 2])
                             / np.maximum(_g1(a, mu), 1e-9), 0.0)
                E[ai, mi] = float(w.mean())
    E = np.clip(E, 0.0, 1.0)
    E_avg = 2.0 * np.trapezoid(E * mus[None, :], mus, axis=1)
    return E.astype(np.float32), E_avg.astype(np.float32)


def bake_e_rows_np(alphas):
    """E(alpha_m, mu_k) at the table's mu grid with bilinear alpha
    interpolation, + E_avg(alpha_m): (e_rows [32, M], e_avg [M])."""
    E, Ea = _energy_tables()
    alphas = np.asarray(alphas, np.float64)
    ai = np.clip(np.sqrt(np.clip(alphas, 0.0, 1.0)) * (_E_RES - 1.0),
                 0.0, _E_RES - 1.0)
    a0 = np.floor(ai).astype(np.int64)
    a1 = np.minimum(a0 + 1, _E_RES - 1)
    fa = (ai - a0).astype(np.float32)
    rows = (E[a0].T * (1.0 - fa) + E[a1].T * fa).astype(np.float32)
    eavg = (Ea[a0] * (1.0 - fa) + Ea[a1] * fa).astype(np.float32)
    return rows, eavg


def bake_e_poly_np(alphas):
    """Per-material degree-5 fit of E(mu) in the sqrt(mu) basis
    (cos-weighted, mu >= 0.02). Returns (coef [6, M], e_avg [M])."""
    rows, e_avg = bake_e_rows_np(alphas)
    nm = rows.shape[0]
    mus = np.arange(nm) / (nm - 1.0)
    sel = mus >= 0.02
    sm = np.sqrt(mus[sel])
    w = np.sqrt(mus[sel])
    A = np.stack([sm ** i for i in range(6)], -1) * w[:, None]
    coef, *_ = np.linalg.lstsq(A, rows[sel] * w[:, None], rcond=None)
    return coef.astype(np.float32), e_avg


# ---------------------------------------------------------------------------
# BSDFData over [N, 3] vectors (the JAX package's XLA-side BSDF)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BSDFData:
    """Per-shading-point BSDF parameters, SoA [N] (vectors [N, 3])."""

    diffuse: torch.Tensor
    specular_f0: torch.Tensor
    alpha: torch.Tensor
    transmission: torch.Tensor
    diffuse_transmission: torch.Tensor
    eta: torch.Tensor
    transmission_color: torch.Tensor
    alpha_x: Optional[torch.Tensor] = None
    alpha_y: Optional[torch.Tensor] = None

    @property
    def ax(self):
        return self.alpha if self.alpha_x is None else self.alpha_x

    @property
    def ay(self):
        return self.alpha if self.alpha_y is None else self.alpha_y


@functools.cache
def _energy_tensors(device):
    E, Ea = _energy_tables()
    return (torch.as_tensor(E, device=device),
            torch.as_tensor(Ea, device=device))


def _cell(x):
    """(x, floor(x), the next cell) of a table coordinate in
    [0, _E_RES - 1]. NaN coordinates (lanes without a surface) take cell 0
    and stay NaN in the weights: the JAX package's gathers clamp their
    indices the same way."""
    i0 = torch.floor(x).to(torch.int64)
    return (torch.clamp(i0, 0, _E_RES - 1),
            torch.clamp(i0 + 1, 0, _E_RES - 1),
            x - i0)


def _alpha_coord(alpha):
    return torch.clamp(torch.sqrt(torch.clamp(alpha, 0.0, 1.0))
                       * (_E_RES - 1.0), 0.0, _E_RES - 1.0)


def _E_lookup(alpha, mu):
    """Bilinear lookup of the directional albedo table E(alpha, mu)."""
    E, _ = _energy_tensors(alpha.device)
    a0, a1, fa = _cell(_alpha_coord(alpha))
    m0, m1, fm = _cell(torch.clamp(torch.clamp(mu, 0.0, 1.0)
                                   * (_E_RES - 1.0), 0.0, _E_RES - 1.0))
    return ((E[a0, m0] * (1 - fm) + E[a0, m1] * fm) * (1 - fa)
            + (E[a1, m0] * (1 - fm) + E[a1, m1] * fm) * fa)


def _E_avg_lookup(alpha):
    _, Ea = _energy_tensors(alpha.device)
    a0, a1, fa = _cell(_alpha_coord(alpha))
    return Ea[a0] * (1 - fa) + Ea[a1] * fa


def ggx_ndf_aniso(ax, ay, h):
    """Anisotropic GGX NDF (== ggx_ndf when ax == ay)."""
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    axs = torch.clamp(ax, min=1e-5)
    ays = torch.clamp(ay, min=1e-5)
    den = (hx * hx) / (axs * axs) + (hy * hy) / (ays * ays) + hz * hz
    return 1.0 / torch.clamp(math.pi * axs * ays * den * den, min=1e-12)


def smith_lambda_aniso(ax, ay, w):
    wz = torch.clamp(torch.abs(w[..., 2]), MIN_COS, 1.0)
    a2 = (ax * ax * w[..., 0] ** 2 + ay * ay * w[..., 1] ** 2) / (wz * wz)
    return 0.5 * (torch.sqrt(1.0 + a2) - 1.0)


def smith_g1_aniso(ax, ay, w):
    return 1.0 / (1.0 + smith_lambda_aniso(ax, ay, w))


def smith_g2_aniso(ax, ay, wo, wi):
    return 1.0 / (1.0 + smith_lambda_aniso(ax, ay, wo)
                  + smith_lambda_aniso(ax, ay, wi))


def fresnel_schlick(f0, cos_h):
    """Schlick Fresnel with the presence gate: F0 == 0 has no specular
    lobe, so the grazing boost vanishes too."""
    w = torch.pow(torch.clamp(1.0 - cos_h, 0.0, 1.0), 5.0)
    if f0.ndim > cos_h.ndim:
        present = (m.luminance(f0) > 1e-6).to(f0.dtype)
        return f0 + (1.0 - f0) * (w * present)[..., None]
    present = (f0 > 1e-6).to(w.dtype)
    return f0 + (1.0 - f0) * w * present


def sample_ggx_vndf(wo, ax, u1, u2, ay):
    """Visible-NDF GGX half-vector sampling (Heitz 2018). wo.z > 0."""
    vh = m.normalize(torch.stack([ax * wo[..., 0], ay * wo[..., 1],
                                  wo[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-16)[..., None],
                     torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], dim=-1),
                     vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape))
    t2 = m.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0)
                       )[..., None] * vh)
    return m.normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                    torch.clamp(nh[..., 2], min=0.0)],
                                   dim=-1))


def ggx_vndf_pdf(wo, h, ax, ay):
    """pdf of sampling half-vector h by VNDF from wo (both local)."""
    woz = torch.clamp(wo[..., 2], min=MIN_COS)
    doth = torch.clamp(m.dot(wo, h, False), min=0.0)
    return (smith_g1_aniso(ax, ay, wo) * ggx_ndf_aniso(ax, ay, h) * doth
            / woz)


def _ms_alpha(data):
    return 0.5 * (data.ax + data.ay)


def _ms_color(data):
    """Kulla-Conty multi-scatter Fresnel factor (per channel)."""
    e_avg = _E_avg_lookup(_ms_alpha(data))[..., None]
    f_avg = data.specular_f0 + (1.0 - data.specular_f0) / 21.0
    return f_avg * f_avg * e_avg / torch.clamp(
        1.0 - f_avg * (1.0 - e_avg), min=1e-4)


def _lobe_probs(data: BSDFData):
    f0_lum = m.luminance(data.specular_f0)
    f_avg = torch.where(f0_lum > 1e-6,
                        torch.clamp(f0_lum + 0.04, 0.0, 1.0), 0.0)
    pd = m.luminance(data.diffuse) * (1.0 - data.transmission) * \
        (1.0 - data.diffuse_transmission)
    pd = pd + torch.where(data.alpha >= DELTA_ALPHA,
                          m.luminance(_ms_color(data))
                          * (1.0 - _E_avg_lookup(_ms_alpha(data))), 0.0)
    pdt = data.diffuse_transmission * m.luminance(data.transmission_color)
    ps = f_avg
    pt = data.transmission * (1.0 - f_avg) * \
        m.luminance(data.transmission_color)
    total = pd + ps + pt + pdt
    safe = torch.clamp(total, min=1e-9)
    ok = total > 1e-9
    return (torch.where(ok, pd / safe, 1.0), torch.where(ok, ps / safe, 0.0),
            torch.where(ok, pt / safe, 0.0), torch.where(ok, pdt / safe, 0.0))


def _eval_diffuse(data, wo, wi):
    """Lambert diffuse reflection * cos, scaled by the Fresnel energy the
    specular lobe claimed (the JAX package's DIFFUSE_MODEL "lambert")."""
    woz, wiz = wo[..., 2], wi[..., 2]
    f0_lum = torch.clamp(m.luminance(data.specular_f0), 0.0, 1.0)
    fd = 1.0 - fresnel_schlick(f0_lum, torch.clamp(woz, 0.0, 1.0))
    f = data.diffuse / math.pi * (fd * torch.clamp(wiz, min=0.0))[..., None]
    valid = (woz > MIN_COS) & (wiz > MIN_COS)
    return torch.where(valid[..., None], f, 0.0)


def _eval_diffuse_trans(data, wo, wi):
    woz, wiz = wo[..., 2], wi[..., 2]
    f = (data.transmission_color * data.diffuse_transmission[..., None]
         / math.pi * torch.clamp(-wiz, min=0.0)[..., None])
    valid = (woz > MIN_COS) & (wiz < -MIN_COS)
    return torch.where(valid[..., None], f, 0.0)


def _eval_spec_ms(data, wo, wi):
    """Energy-compensation lobe * cos(wi)."""
    woz, wiz = wo[..., 2], wi[..., 2]
    a_ms = _ms_alpha(data)
    e_o = _E_lookup(a_ms, woz)
    e_i = _E_lookup(a_ms, wiz)
    e_avg = _E_avg_lookup(a_ms)
    f = ((1.0 - e_o) * (1.0 - e_i)
         / (math.pi * torch.clamp(1.0 - e_avg, min=1e-4)))
    f_cos = (f * torch.clamp(wiz, min=0.0))[..., None] * _ms_color(data)
    valid = (woz > MIN_COS) & (wiz > MIN_COS) & (data.alpha >= DELTA_ALPHA)
    return torch.where(valid[..., None], f_cos, 0.0)


def _eval_spec_refl(data, wo, wi):
    woz, wiz = wo[..., 2], wi[..., 2]
    h = m.normalize(wo + wi)
    doth = torch.clamp(m.dot(wo, h, False), min=0.0)
    D = ggx_ndf_aniso(data.ax, data.ay, h)
    G = smith_g2_aniso(data.ax, data.ay, wo, wi)
    F = fresnel_schlick(data.specular_f0, doth)
    spec = F * (D * G / torch.clamp(4.0 * woz, min=1e-9))[..., None]
    valid = (woz > MIN_COS) & (wiz > MIN_COS) & (data.alpha >= DELTA_ALPHA)
    return torch.where(valid[..., None], spec, 0.0)


def _eval_spec_trans(data, wo, wi):
    """GGX rough refraction * cos (Walter 2007)."""
    woz, wiz = wo[..., 2], wi[..., 2]
    eta = data.eta
    h = m.normalize(-(eta[..., None] * wo + wi))
    h = h * torch.where(h[..., 2:3] < 0.0, -1.0, 1.0)
    dot_oh = m.dot(wo, h, False)
    dot_ih = m.dot(wi, h, False)
    F = fresnel_dielectric(torch.abs(dot_oh), eta)
    D = ggx_ndf_aniso(data.ax, data.ay, h)
    G = smith_g2_aniso(data.ax, data.ay, wo,
                       torch.stack([wi[..., 0], wi[..., 1], torch.abs(wiz)],
                                   dim=-1))
    denom = dot_oh * eta + dot_ih
    jac = torch.abs(dot_ih) / torch.clamp(denom * denom, min=1e-9)
    f_cos = ((1.0 - F) * D * G * jac * torch.abs(dot_oh)
             / torch.clamp(torch.abs(woz), min=MIN_COS))
    valid = ((woz > MIN_COS) & (wiz < -MIN_COS)
             & (data.alpha >= DELTA_ALPHA)
             & (dot_oh > 0.0) & (dot_ih < 0.0))
    f = data.transmission_color * (data.transmission * f_cos)[..., None]
    return torch.where(valid[..., None], f, 0.0)


def bsdf_eval(data: BSDFData, wo, wi):
    """Sum of the non-delta lobes f(wo, wi) * |cos(wi)|, [N, 3]."""
    return (_eval_diffuse(data, wo, wi)
            * (1.0 - data.transmission)[..., None]
            * (1.0 - data.diffuse_transmission)[..., None]
            + _eval_diffuse_trans(data, wo, wi)
            + _eval_spec_refl(data, wo, wi)
            + _eval_spec_ms(data, wo, wi)
            + _eval_spec_trans(data, wo, wi))


def bsdf_eval_split(data: BSDFData, wo, wi):
    """bsdf_eval as (diffuse-ish, specular-ish) parts; f_d + f_s equals
    bsdf_eval."""
    f_d = (_eval_diffuse(data, wo, wi)
           * (1.0 - data.transmission)[..., None]
           * (1.0 - data.diffuse_transmission)[..., None]
           + _eval_diffuse_trans(data, wo, wi))
    f_s = (_eval_spec_refl(data, wo, wi) + _eval_spec_ms(data, wo, wi)
           + _eval_spec_trans(data, wo, wi))
    return f_d, f_s


def bsdf_pdf(data: BSDFData, wo, wi):
    """Solid-angle pdf of the BSDF sampler producing wi (non-delta
    lobes)."""
    pd, ps, pt, pdt = _lobe_probs(data)
    woz, wiz = wo[..., 2], wi[..., 2]
    smooth = data.alpha >= DELTA_ALPHA

    pdf_d = torch.clamp(wiz, min=0.0) / math.pi
    pdf_dt = torch.clamp(-wiz, min=0.0) / math.pi

    h_r = m.normalize(wo + wi)
    pdf_s = ggx_vndf_pdf(wo, h_r, data.ax, data.ay) / torch.clamp(
        4.0 * torch.abs(m.dot(wo, h_r, False)), min=1e-9)
    pdf_s = torch.where(smooth & (wiz > MIN_COS) & (woz > MIN_COS), pdf_s,
                        0.0)

    eta = data.eta
    h_t = m.normalize(-(eta[..., None] * wo + wi))
    h_t = h_t * torch.where(h_t[..., 2:3] < 0.0, -1.0, 1.0)
    dot_oh = m.dot(wo, h_t, False)
    dot_ih = m.dot(wi, h_t, False)
    denom = dot_oh * eta + dot_ih
    jac_t = torch.abs(dot_ih) / torch.clamp(denom * denom, min=1e-9)
    F = fresnel_dielectric(torch.abs(dot_oh), eta)
    pdf_t = ggx_vndf_pdf(wo, h_t, data.ax, data.ay) * jac_t * (1.0 - F)
    pdf_t = torch.where(smooth & (wiz < -MIN_COS) & (woz > MIN_COS)
                        & (dot_oh > 0.0) & (dot_ih < 0.0), pdf_t, 0.0)
    return pd * pdf_d + ps * pdf_s + pt * pdf_t + pdt * pdf_dt


def bsdf_sample(data: BSDFData, wo, u_lobe, u1, u2):
    """Sample wi from the full BSDF.

    Returns dict(wi [N,3], weight [N,3] = f*cos/pdf, pdf [N] (0 for delta),
    is_delta [N] bool, lobe [N] i32, valid [N] bool)."""
    pd, ps, pt, pdt = _lobe_probs(data)
    woz = wo[..., 2]
    smooth = data.alpha >= DELTA_ALPHA
    sel_d = u_lobe < pd
    sel_s = ~sel_d & (u_lobe < pd + ps)
    sel_t = ~sel_d & ~sel_s & (u_lobe < pd + ps + pt)
    lobe = torch.where(sel_d, LOBE_DIFFUSE_REFL, torch.where(
        sel_s, LOBE_SPECULAR_REFL, torch.where(
            sel_t, LOBE_SPECULAR_TRANS, LOBE_DIFFUSE_TRANS))).to(torch.int32)

    # candidate wi per lobe
    wi_cos, _ = m.sample_cosine_hemisphere(u1, u2)
    h = sample_ggx_vndf(wo, torch.clamp(data.ax, min=DELTA_ALPHA), u1, u2,
                        torch.clamp(data.ay, min=DELTA_ALPHA))
    h_eff = torch.where(smooth[..., None], h,
                        h.new_tensor([0.0, 0.0, 1.0]).expand(h.shape))
    wi_refl = m.normalize(2.0 * m.dot(wo, h_eff) * h_eff - wo)
    eta = data.eta
    cos_oh = torch.clamp(m.dot(wo, h_eff, False), 0.0, 1.0)
    sin2_t = eta * eta * (1.0 - cos_oh * cos_oh)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_refr = m.normalize((-eta[..., None]) * wo
                          + (eta * cos_oh - cos_t)[..., None] * h_eff)
    wi_dt = torch.stack([wi_cos[..., 0], wi_cos[..., 1], -wi_cos[..., 2]],
                        dim=-1)
    wi = torch.where(sel_d[..., None], wi_cos, torch.where(
        sel_s[..., None], wi_refl, torch.where(
            sel_t[..., None], torch.where(tir[..., None], wi_refl, wi_refr),
            wi_dt)))
    is_delta = ~smooth & (sel_s | sel_t)

    # smooth path: combined f and pdf for MIS-correct weights
    f = bsdf_eval(data, wo, wi)
    pdf = bsdf_pdf(data, wo, wi)
    w_smooth = f / torch.clamp(pdf, min=1e-12)[..., None]

    # delta path weights; at total internal reflection the whole
    # transmission budget reflects (Fd == 1 would zero it)
    cos_o = torch.clamp(woz, 0.0, 1.0)
    w_delta_s = fresnel_schlick(data.specular_f0, cos_o) \
        / torch.clamp(ps, min=1e-9)[..., None]
    fd = fresnel_dielectric(cos_o, eta)
    pt_safe = torch.clamp(pt, min=1e-9)[..., None]
    w_delta_t = torch.where(
        tir[..., None],
        data.transmission_color * data.transmission[..., None] / pt_safe,
        data.transmission_color * (data.transmission * (1.0 - fd))[..., None]
        / pt_safe)
    w_delta = torch.where(sel_s[..., None], w_delta_s, w_delta_t)
    weight = torch.where(is_delta[..., None], w_delta, w_smooth)
    lum = m.luminance(weight)
    valid = (woz > MIN_COS) & (lum >= 0.0) & torch.isfinite(lum)
    return dict(wi=wi, weight=torch.clamp(weight, min=0.0),
                pdf=torch.where(is_delta, 0.0, pdf), is_delta=is_delta,
                lobe=lobe, valid=valid)


def make_bsdf_data(base_color, metallic, roughness, ior, transmission,
                   diffuse_transmission, specular_scale, front,
                   cur_ior=None, below_ior=None, anisotropy=None) -> BSDFData:
    """BSDFData from material parameters. `front` [N] bool: the shading
    point is seen from outside (sets eta's orientation); `cur_ior` /
    `below_ior` come from the medium stack (air when None)."""
    f0_dielec = (0.08 * specular_scale)[..., None] \
        * torch.ones_like(base_color)
    specular_f0 = f0_dielec * (1.0 - metallic[..., None]) \
        + base_color * metallic[..., None]
    mat_ior = torch.clamp(ior, min=1.0 + 1e-4)
    if cur_ior is None:
        eta = torch.where(front, 1.0 / mat_ior, mat_ior)
    else:
        bi = below_ior if below_ior is not None else torch.ones_like(cur_ior)
        eta = torch.where(front, cur_ior / mat_ior,
                          cur_ior / torch.clamp(bi, min=1.0))
    alpha = torch.clamp(roughness * roughness, 0.0, 1.0)
    if anisotropy is None:
        ax = ay = alpha
    else:
        # Disney aspect remap (KHR_materials_anisotropy strength)
        aspect = torch.sqrt(1.0 - 0.9 * torch.clamp(anisotropy, 0.0, 1.0))
        ax = torch.clamp(alpha / torch.clamp(aspect, min=1e-3), 0.0, 1.0)
        ay = torch.clamp(alpha * aspect, 0.0, 1.0)
    return BSDFData(
        diffuse=base_color * (1.0 - metallic[..., None]),
        specular_f0=specular_f0, alpha=alpha,
        transmission=transmission * (1.0 - metallic),
        diffuse_transmission=diffuse_transmission * (1.0 - metallic),
        eta=eta, transmission_color=base_color * 0.0 + 1.0,
        alpha_x=ax, alpha_y=ay)

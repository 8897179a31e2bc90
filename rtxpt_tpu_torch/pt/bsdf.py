"""Scalar BSDF pieces (counterpart of rtxpt_tpu/pt/bsdf.py): the constants
and elementwise microfacet terms that pt/wide.py builds on, and the host
bake of the per-material Kulla-Conty energy polynomial that the bounce
tables carry (MT_EPOLY / MT_EAVG)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

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

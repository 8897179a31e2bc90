"""Image output and comparison metrics (counterpart of
rtxpt_tpu/utils/image.py): host numpy code."""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Save a [H,W,3] float image in [0,1] (display-ready) as PNG."""
    from PIL import Image

    Image.fromarray(to_uint8(img), mode="RGB").save(path)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    e = rmse(a, b)
    if e == 0:
        return float("inf")
    return float(20.0 * np.log10(peak / e))

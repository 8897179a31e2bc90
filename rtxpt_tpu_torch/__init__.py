"""rtxpt_tpu_torch -- the PyTorch / CUDA port of rtxpt_tpu for NVIDIA
Hopper GPUs.

The JAX package rtxpt_tpu is the reference; this package keeps its module
paths and table layouts, runs plain PyTorch around hand-written CUDA
kernels (rtxpt_tpu_torch/csrc), and never imports JAX. Reference-mode
rendering of small scenes (at most 2048 triangles) runs end to end:

    import rtxpt_tpu_torch as rt
    from rtxpt_tpu_torch.scene.procedural import cornell_box, default_camera
    host = cornell_box()
    scene = rt.prepare(host, device=rt.device("cuda"))
    cam = default_camera(host, 512, 512)
    hdr, _, rays = rt.render(scene, cam, rt.config.PathTracerConfig(),
                             512, 512, spp=16)

The public API loads lazily, so importing the package imports no torch.
"""

__version__ = "0.1.0"

_API = {
    "prepare": ("rtxpt_tpu_torch.prepare", "prepare"),
    "render": ("rtxpt_tpu_torch.pt.integrator", "render"),
    "render_sample": ("rtxpt_tpu_torch.pt.integrator", "render_sample"),
    "look_at": ("rtxpt_tpu_torch.scene.camera", "look_at"),
    "tonemap": ("rtxpt_tpu_torch.render.postprocess", "tonemap"),
    "config": ("rtxpt_tpu_torch.config", None),
}


def device(name: str = "cuda"):
    """torch.device(name), checked: asking for CUDA on a machine without a
    usable GPU raises instead of quietly running on the CPU."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           f"torch.cuda.is_available() is False")
    return dev


def __getattr__(name):
    import importlib

    if name in _API:
        mod, attr = _API[name]
        module = importlib.import_module(mod)
        return module if attr is None else getattr(module, attr)
    raise AttributeError(name)

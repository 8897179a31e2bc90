"""The probe kernels K10-K12: the JAX package's microbenchmarks of its
clustered-intersection designs (scripts/micro_*.py), ported with their
plain versions. Each module is named after its script and runs as

    python -m rtxpt_tpu_torch.probes.micro_cluster_kernel   # K10
    python -m rtxpt_tpu_torch.probes.micro_flat_kernel      # K11
    python -m rtxpt_tpu_torch.probes.micro_constructs [NAME ...]   # K12

on the card, or with `--device cpu` through the plain versions. Each has
`inputs` (the script's arrays, drawn with numpy in the script's order),
`run` (the kernel on CUDA tensors, the plain version on CPU tensors) and
`main` (what the script prints, checked against a stated limit). No
render path launches them.
"""


def one_device(where: str, **tensors):
    """The device of every tensor in `tensors`; raises when they lie on
    more than one (a CPU table with a CUDA operand is refused, not run)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        found = ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        raise ValueError(f"{where}: operands on different devices ({found})")
    return devices.pop()

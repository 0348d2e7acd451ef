"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

| kernel | wrapper                        | replaces (JAX package)                    |
|--------|--------------------------------|-------------------------------------------|
| K1     | brief.brief_descriptors        | ops/brief_pallas.py::brief_bitplanes      |
|        |                                | (with its consumer descriptors_from_planes) |
| K2     | gn.gn_burst_stereo             | ops/gn_pallas.py::gn_burst_stereo         |
| K3     | fast.fast_scores_kernel        | ops/fast_pallas.py::fast_scores_pallas    |

A wrapper given a CPU tensor computes its plain PyTorch version; given a
CUDA tensor it launches its kernel (building the library on first use) or
raises.  Each wrapper counts its launches in a plain integer, ``launches``,
on its module.
"""
from . import brief, fast, gn

KERNELS = {"fast": fast, "brief": brief, "gn_burst": gn}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}

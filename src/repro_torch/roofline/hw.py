"""Target-hardware constants of the roofline models — counterpart of
`repro/roofline/hw.py`.

`HwSpec`, `V5E` and `CHIPS_PER_POD` are the reference's, field for
field, so that a model run at `hw=V5E` gives the reference's numbers.
`H100` is the port's card.  The models read `peak_flops_bf16`, `hbm_bw`
and `ici_bw`; `target_hw` says which spec a call site passes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float   # FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link (one direction)
    ici_links: int           # links per chip (2D torus: 4)
    hbm_bytes: float         # HBM capacity per chip
    vmem_bytes: float        # VMEM per core


# the reference's target (its sources: 197 TFLOP/s bf16 per chip, 819 GB/s
# HBM, ~50 GB/s a link of ICI)
V5E = HwSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_links=4,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
)

# NVIDIA H100 SXM5 (NVIDIA's H100 data sheet and the Hopper architecture
# white paper; dense rates, no sparsity, at the 700 W limit)
H100 = HwSpec(
    name="nvidia-h100-sxm",
    # dense bf16 on the tensor cores; float32 outside them is 67e12
    peak_flops_bf16=989e12,
    # HBM3
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s bidirectional per GPU over 18 links, all to all
    # through NVSwitch.  One ring step to one peer gets one direction of
    # the whole NVLink budget, 450 GB/s, which is what the models' per-link
    # term charges; ici_links counts the physical links.
    ici_bw=450e9,
    ici_links=18,
    hbm_bytes=80e9,
    # shared memory per SM (of which a block may take 227 KB)
    vmem_bytes=228 * 2**10,
)

# Production meshes (launch/mesh.py): one pod = 16×16 chips, multi-pod = 2 pods.
CHIPS_PER_POD = 256


def target_hw(device) -> HwSpec:
    """The spec a call site of the port passes to the models: `H100` for a
    CUDA device, the port's only target; `V5E` on the CPU.  The CPU runs
    are the port's parity runs against the reference, whose models default
    to V5E, so on the CPU every "auto" choice equals the reference's and
    the parity tests hold end to end."""
    import torch

    return H100 if torch.device(device).type == "cuda" else V5E

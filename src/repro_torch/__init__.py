"""repro_torch — PyTorch/CUDA port of the Multi-Slice Clustering library.

Mirrors `repro` module for module (`repro_torch/core/msc.py` is the
counterpart of `repro/core/msc.py`).  The hot spots run in CUDA C++
kernels written for Hopper (`kernels/csrc/*.cu`); on the CPU every
kernel wrapper runs its plain PyTorch version instead.

Entry points (`core.msc.msc_sequential`, `core.parallel.build_msc_parallel`,
`launch/msc_run.py`) run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` where no card is present raises.
"""

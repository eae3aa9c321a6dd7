"""The benchmark's own CPU tests (`python -m pytest portbench/tests`).

They import the harness as `run.py` does: `portbench/` and `src/` on the
path.  Torch runs one thread: the shapes are small."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.join(os.path.dirname(BENCH), "src")]

import torch  # noqa: E402

torch.set_num_threads(1)

"""Build the CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its
own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<digest>.so csrc/<name>.cu

into `kernels/build/` (listed in .gitignore) at first use.  The file
name carries a digest of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  `build()` starts one
nvcc per missing source, all at once, and waits for them together.
Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("power_iter", "ring", "gram", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """One compiled library: its path, nvcc's wall time (0.0 when it was
    already built) and the `-Xptxas -v` report (registers, shared
    memory and spills per kernel)."""

    name: str
    path: Path
    seconds: float
    ptxas: str


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the CUDA kernels build only where the toolkit is")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library in `names` in parallel.

    Returns {name: Built}.  Raises with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = lib_path(name)
        log = path.with_suffix(".log")
        if path.exists():
            ptxas = log.read_text() if log.exists() else ""
            out[name] = Built(name, path, 0.0, ptxas)
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        path = lib_path(name)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n"
                          f"{text}")
            continue
        path.with_suffix(".log").write_text(text)
        os.replace(tmp, path)
        out[name] = Built(name, path, seconds, text)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


_LIBS: dict = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name].path))
    return _LIBS[name]

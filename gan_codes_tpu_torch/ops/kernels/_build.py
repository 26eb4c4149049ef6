"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every source in `gan_codes_tpu_torch/csrc/` goes into one shared library
with a plain C interface, for Hopper (`sm_90a`), in one nvcc call:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libgct_<hash>.so csrc/*.cu

The build happens at first use, never at import, into `gan_codes_tpu_torch/
_build/` (listed in `.gitignore`). The file name carries a hash of the
sources, the shared header and the flags, so an edited source rebuilds and
an unchanged tree reuses the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("fused_affine.cu", "fused_modconv.cu", "fused_resblock.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode() + (CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libgct_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing. nvcc writes to a private
    temporary name that is renamed into place, so concurrent builders never
    load a half-written library."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib

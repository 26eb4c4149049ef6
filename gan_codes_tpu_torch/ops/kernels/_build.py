"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every source in `gan_codes_tpu_torch/csrc/` goes into one shared library
with a plain C interface, for Hopper (`sm_90a`): one nvcc per source, all
started together, each compiling to an object, then one nvcc that links
them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o _build/<hash>/<source>.o csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libgct_<hash>.so _build/<hash>/*.o

The build happens at first use, never at import, into `gan_codes_tpu_torch/
_build/` (listed in `.gitignore`). The file name carries a hash of the
sources, the shared headers and the flags, so an edited source rebuilds and
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
HEADERS = ("common.cuh", "wgmma.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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


def _run(procs) -> None:
    """Wait for every nvcc of `procs` ([(cmd, Popen)]); raise on a failure
    with its output."""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the library if it is missing: the sources in parallel, then
    the link. nvcc writes to private temporary names and the library is
    renamed into place, so concurrent builders never load a half-written
    library."""
    path = library_path()
    if path.exists():
        return path
    tmp_dir = BUILD_DIR / f"{path.stem}.{os.getpid()}.objs"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = nvcc_path()
        objs = [tmp_dir / f"{Path(s).stem}.o" for s in SOURCES]
        compiles = []
        for src, obj in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                   str(CSRC_DIR / src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        _run(compiles)
        tmp = tmp_dir / path.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT))])
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib

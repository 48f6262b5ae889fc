"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled at first use with nvcc into a shared library with
a plain C interface, under canvas_tpu_torch/_build/, and loaded with
ctypes.  A build takes seconds; a failed build raises with nvcc's stderr.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills per kernel) of each
# source built by this process
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(cuda_home) / "bin" / "nvcc")


def build(name: str, src: Path | None = None) -> Path:
    """Compile csrc/<name>.cu (or `src`) into _build/lib<name>.so unless
    the library is newer than its source.  The library is written to a
    temporary name and renamed into place, so concurrent builds never load
    a partial file.  ptxas's report of a build goes to PTXAS_LOG[name]."""
    src = src or CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
        PTXAS_LOG[name] = res.stdout + res.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, signatures: dict[str, list],
         src: Path | None = None) -> ctypes.CDLL:
    """The ctypes library for csrc/<name>.cu (or `src`), built on first
    use.  Every entry point returns an int (a cudaError_t); `signatures`
    gives each one's argtypes."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, src)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(device: torch.device, entry, *args) -> int:
    """Call a kernel's C entry point with `device` made the current CUDA
    device, and the stream of `device` as its last argument.  The entry
    point launches on the current device, and its memsets and
    cudaFuncSetAttribute act on it too, so all of them belong to the
    device of the tensors, whichever device the caller had current.
    Returns the entry point's status."""
    with torch.cuda.device(device):
        return entry(*args, current_stream(device))


def require_cuda_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                        device: torch.device | None = None) -> None:
    """Raise unless x is a contiguous CUDA tensor of the given dtype (on
    `device` when one is given)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda_rows(name: str, x: torch.Tensor, dtype: torch.dtype,
                      device: torch.device | None = None) -> int:
    """Raise unless x is a 2-D CUDA tensor of the given dtype whose rows
    are contiguous and do not overlap (the first columns of wider rows
    pass); returns the row stride in elements."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
    ld = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    if (x.shape[1] > 1 and x.stride(1) != 1) or ld < x.shape[1]:
        raise ValueError(f"{name} must have contiguous rows")
    return ld


def ptr(x: torch.Tensor | None):
    """The data pointer of x, or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


"""Build and bind the port's hand-written CUDA kernels.

Each source under `repro_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface and loaded with
`ctypes`: every pointer and the stream travel as `c_void_p`, every size as
`c_int`. A source that includes no PyTorch header compiles in seconds, where
`torch.utils.cpp_extension` takes minutes. Libraries are built at first
use (or all at once, in parallel, by `build_all`) into `build/kernels/` at the
root of the checkout, named by a digest of the source, its headers and the
flags, so a changed source is never served a stale binary.

`CudaKernel` is the launcher a wrapper calls: it counts the launches it makes,
so a run can show that its path went through the kernel, and it raises when
the C entry point reports a CUDA error (a refused launch never runs, and a
later synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -split-compile=0 optimizes a source's kernels on all host threads, so the
# many template instances of the decode-attention sources do not serialize
# the build
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-split-compile=0")
SOURCES = ("bank_energy", "flash_attention", "gqa_decode", "int8_matmul",
           "paged_gqa_decode", "paged_gqa_verify")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path(stem: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one `nvcc` per source, all started
    together. Returns {stem: library path}; raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _library_path(s) for s in stems}
    procs = []
    for stem, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed: List[str] = []
    for stem, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built on first use."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([stem])[stem]))
        lib.trapti_error_string.argtypes = [ctypes.c_int]
        lib.trapti_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


class CudaKernel:
    """The ctypes entry point of one kernel, with its launch count.

    `launches` grows by one per successful call, and by a CUDA graph's
    captured calls at each replay (`add_launches`)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library(self.source).trapti_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count `times` runs of launches made outside the wrappers' calls: a
    CUDA graph's replay runs the launches its capture recorded (and
    -1 takes back those the capture's calls counted)."""
    for name, n in counts.items():
        KERNELS[name].launches += times * n


def stream_ptr(tensor) -> ctypes.c_void_p:
    """The current CUDA stream of `tensor`'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())

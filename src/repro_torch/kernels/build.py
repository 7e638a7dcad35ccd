"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``.cu`` under ``kernels/*/csrc/`` is a plain-C-interface shared library
(no PyTorch headers, so a build takes seconds).  The library is named after
the source and a hash of the flags and of its ``csrc/`` directory (the
source and the headers beside it), and lands in
``<repo>/build/kernels/`` (listed in ``.gitignore``): an unchanged source is
built once per checkout, an edited one is rebuilt.  :func:`build_all` starts
one ``nvcc`` per missing library, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

SOURCES: Dict[str, Path] = {
    "spmm_bcsr": _KERNELS / "spmm" / "csrc" / "spmm_bcsr.cu",
    "flash_attention": (_KERNELS / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "decode_attention": (_KERNELS / "flash_attention" / "csrc"
                         / "decode_attention.cu"),
    "stencil": _KERNELS / "stencil" / "csrc" / "stencil.cu",
    "spmspm_ell": _KERNELS / "spmspm" / "csrc" / "spmspm_ell.cu",
    "wkv": _KERNELS / "wkv" / "csrc" / "wkv.cu",
    "wkv_step": _KERNELS / "wkv" / "csrc" / "wkv_step.cu",
    "router": _KERNELS / "router" / "csrc" / "router.cu",
    "ssd_step": _KERNELS / "ssd" / "csrc" / "ssd_step.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise FileNotFoundError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); the port's CUDA "
        "kernels are built on the machine with the GPU")


def library_path(name: str) -> Path:
    """The library of source ``name``, named after a hash of the flags and
    of every file in the source's ``csrc/`` directory (the headers it
    includes live there), so that an edit to any of them rebuilds it."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SOURCES[name].parent.iterdir()):
        if f.is_file():
            digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every missing library among ``names`` (default: all sources),
    one ``nvcc`` process each, started together.  Returns, per name, the
    wall seconds of its build (0.0 when it was already built) and the
    compiler's resource report (``-Xptxas -v``, kept beside the library, so
    that a library built before is reported too: "" only where that file
    is gone).  Raises on any failure."""
    names = list(SOURCES) if names is None else list(names)
    out: Dict[str, dict] = {}
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        target = library_path(name)
        if target.is_file():
            report = target.with_suffix(".log")
            out[name] = {"seconds": 0.0, "log": report.read_text()
                         if report.is_file() else ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.monotonic())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        tmp.with_suffix(".log").write_text(log)
        os.replace(tmp.with_suffix(".log"), target.with_suffix(".log"))
        os.replace(tmp, target)   # atomic: concurrent builders never see half
        out[name] = {"seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise where grad mode is on and one of ``tensors`` requires grad: a
    kernel writes its output through a raw pointer, so that output has no
    ``grad_fn`` and the gradients behind it would be dropped without a
    word.  Called by every CUDA wrapper before its launch; a wrapper with a
    backward (R1, K7, K3 under ``impl="kernel_sharded"``) launches inside
    an autograd ``Function``'s forward, where grad mode is off."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward here; its inputs "
            "require grad (run it under torch.no_grad(), or through the "
            "entry point that carries its gradient)")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

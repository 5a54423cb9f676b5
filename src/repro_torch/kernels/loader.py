"""Build, load and select the port's CUDA kernels, and count their launches.

Every kernel source (``kernels/*/csrc/*.cu``) has a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/``
at the root of the checkout, named by a hash of the source, the headers
beside it (``csrc/*.cuh``) and the flags, and loaded with ``ctypes``;
later uses find the library already built.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>.log``. Nothing is built or loaded when a
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Union

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_KINDS = ("auto", "cuda", "ref")


def resolve_kernel(kind: str, device: Union[str, torch.device]) -> str:
    """Every kernel of the port follows one rule: ``auto`` is ``cuda`` for
    CUDA tensors and ``ref`` (the plain version) for CPU tensors; an
    explicit ``cuda`` on the CPU raises. ``ref`` runs anywhere."""
    if kind not in KERNEL_KINDS:
        raise ValueError(f"kernel must be one of {KERNEL_KINDS}, got {kind!r}")
    on_cuda = torch.device(device).type == "cuda"
    if kind == "auto":
        return "cuda" if on_cuda else "ref"
    if kind == "cuda" and not on_cuda:
        raise ValueError(f"kernel='cuda' needs CUDA tensors, got device {device}")
    return kind


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an op on these inputs: grad mode is
    on and a floating-point input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.is_floating_point() and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when autograd would need the gradient
    of a kernel that has no backward: its output, written through a raw
    pointer, would otherwise come back detached, and a loss would silently
    train around it."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel ({why}); run it under torch.no_grad() "
            "or with inputs that do not require grad")


class LaunchCounter:
    """Counts one kernel's launches; ``chip_smoke.py`` and the engine read
    it to show that the main path went through the kernel."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source at first use")


def library_path(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; returns ``{source: shared library}``. Raises with the
    compiler's output if any build fails."""
    libs = {src: library_path(src) for src in sources}
    todo = {src: lib for src, lib in libs.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
            continue
        libs[src].with_suffix(".log").write_text(out)
        os.replace(tmp, libs[src])    # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build_all([source])[source]))
    return _libs[source]

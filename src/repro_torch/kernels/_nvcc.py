"""Build-at-first-use for the port's CUDA sources (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``kernels/build/lib<name>-<hash>.so``, where the hash covers the source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads from the build directory.  A
build writes to a temporary name and renames it into place, so concurrent
processes never load a half-written library.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per
#: library built by this process.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named source whose library is missing, in parallel."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    try:
        for n, p in todo.items():
            tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
            os.replace(tmp, paths[n])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """A ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    return ctypes.CDLL(str(build(name)[name]))


class Library:
    """A CUDA source's library, built and bound at its first call.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every one returns a ``cudaError_t`` as int, and the library
    exports ``<error_fn>(int) -> const char*`` to name it."""

    def __init__(self, name: str, signatures: dict, error_fn: str):
        self.name, self.signatures, self.error_fn = name, signatures, error_fn
        self._lib = None

    def _handle(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, self.error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args):
        """Launch ``fn`` and raise if the launch was refused or failed."""
        code = getattr(self._handle(), fn)(*args)
        if code != 0:
            msg = getattr(self._handle(), self.error_fn)(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"({code})")


def on_card(what: str, *tensors) -> bool:
    """True for tensors on one CUDA device (launch the kernel), False for
    CPU tensors (the plain version); anything else, or a mix, is refused.
    On the card a kernel's output has no ``grad_fn``, so a call that
    autograd would need to differentiate is refused too
    (:func:`refuse_grad`); on the CPU the plain version is differentiable
    and runs."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        refuse_grad(what, *tensors)
        return True
    raise ValueError(f"{what} takes tensors on one CUDA device or on the "
                     f"CPU, got {sorted(str(t.device) for t in tensors)}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad is enabled and one of ``tensors``
    requires grad: the kernel ``what`` has no backward ported, and its
    output would silently carry no gradient.  An
    ``autograd.Function.forward`` runs with grad disabled, so a kernel
    wrapped in one with its backward passes."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: no backward of this kernel is ported yet, so on the "
            f"card it refuses inputs that require grad while grad is "
            f"enabled (run it under torch.no_grad(), or train on the CPU)")


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer, read
    without building a ``torch.cuda.Stream`` object (per-launch host
    work)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)

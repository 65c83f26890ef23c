"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``kernels/csrc/*.cu`` file becomes one shared library with a plain
C interface, compiled by ``nvcc`` for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

Outputs go to ``build/repro_torch_kernels/<name>-<hash>/`` at the repo
root, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  A file lock serialises builds
across processes and a thread lock across threads; each library is
written to a temporary name and moved into place, so a reader never loads
a half-written file.  All sources build in parallel, one ``nvcc`` each.
Nothing here runs at import time: the CPU tests import this module on
machines with no CUDA toolkit.

:class:`Library` binds one source's C entry points once and launches
them: the wrappers' lean path from a CUDA tensor to the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds the last build_all() spent compiling (0.0 when every library
#: was already built)
last_build_s = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "compiled at first use on a machine with the CUDA toolkit")
    return found


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _out_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cu*")):      # a header change rebuilds
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_ROOT / f"{src.stem}-{h.hexdigest()[:16]}" / f"lib{src.stem}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once, and
    return ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    global last_build_s
    srcs = _sources()
    outs = {name: _out_path(src) for name, src in srcs.items()}
    with _lock:
        todo = {n: p for n, p in outs.items() if not p.exists()}
        if not todo:
            last_build_s = 0.0
            return outs
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        with open(BUILD_ROOT / ".lock", "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                todo = {n: p for n, p in todo.items() if not p.exists()}
                t0 = time.perf_counter()
                nvcc = _nvcc()
                procs = {}
                for name, out in todo.items():
                    out.parent.mkdir(parents=True, exist_ok=True)
                    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                    procs[name] = (out, tmp, subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
                failed = []
                for name, (out, tmp, proc) in procs.items():
                    log, _ = proc.communicate()
                    (out.parent / "build.log").write_text(log)
                    if proc.returncode != 0:
                        failed.append(f"{name}:\n{log}")
                        continue
                    os.replace(tmp, out)
                last_build_s = time.perf_counter() - t0
                if failed:
                    raise RuntimeError("nvcc failed for " + "\n".join(failed))
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    return outs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) from the build of ``name``."""
    return (_out_path(_sources()[name]).parent / "build.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if
    needed); the caller declares its functions' argtypes."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib


class Library:
    """The C entry points of ``csrc/<source>.cu``, built, loaded and bound
    once at the first launch; and ``launches``, the kernel launches of
    each entry point since the last :meth:`reset` (one dict, mutated in
    place).

    ``signatures`` maps each entry point to the number of its arguments.
    Every entry point takes them packed: one pointer to that many 64-bit
    integers (pointers, ints and the stream, in order).  One conversion
    instead of one per argument is most of what a launch through ctypes
    costs the host."""

    def __init__(self, source: str, signatures: Dict[str, int]):
        self.source = source
        self.signatures = dict(signatures)
        self.launches = {name: 0 for name in self.signatures}
        self.packers = {name: struct.Struct(f"<{n}q")
                        for name, n in self.signatures.items()}
        self._fns: Dict[str, Callable[..., int]] = {}
        self._bind_lock = threading.Lock()
        self._count_lock = threading.Lock()

    def reset(self) -> None:
        with self._count_lock:
            for name in self.launches:
                self.launches[name] = 0

    def _bind(self) -> Dict[str, Callable[..., int]]:
        with self._bind_lock:
            if not self._fns:
                lib = load(self.source)
                fns = {}
                for name in self.signatures:
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.c_char_p]
                    fn.restype = ctypes.c_int
                    fns[name] = fn
                self._fns = fns
        return self._fns

    def launch(self, name: str, *args) -> None:
        """Call entry point ``name`` (one kernel launch), raise on the
        CUDA error it returns, and count the launch."""
        fn = (self._fns or self._bind())[name]
        rc = fn(self.packers[name].pack(*args))
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc} at launch")
        with self._count_lock:
            self.launches[name] += 1


def stream_handle(dev: torch.device) -> int:
    """The ``cudaStream_t`` of the current stream on ``dev``, as
    ``torch.cuda.current_stream(dev).cuda_stream`` gives it, without
    building a ``Stream`` object (PyTorch's own generated kernels launch
    through the same call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


_NO_GUARD = contextlib.nullcontext()


def on_device(dev: torch.device):
    """A context that makes ``dev`` the current CUDA device: nothing to do
    (and nothing paid) when it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return _NO_GUARD
    return torch.cuda.device(dev)

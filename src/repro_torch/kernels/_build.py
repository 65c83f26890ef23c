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
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

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

"""Build the port's CUDA sources with ``nvcc`` on first use and load them
with ``ctypes``.

Each kernel keeps its sources under ``<kernel>/csrc/`` and exports a plain
C interface (no PyTorch headers, so a build takes seconds).  The shared
library goes to ``kernels/build/`` (listed in .gitignore) under a name
that carries a digest of the sources and flags, so an edited source is
rebuilt and two processes never load a half-written file: the library is
compiled to a temporary name and renamed into place.  nvcc's output
(``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside the library as ``<name>.log``.

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source on first use and need the CUDA toolkit")


def library_path(name: str, sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources) -> Path:
    """Compile `sources` into one shared library (skipped when a library
    of the same sources and flags exists).  Returns its path."""
    return build_all({name: sources})[name]


def build_all(libraries: dict) -> dict:
    """Build several libraries ({name: sources}) at once: one nvcc process
    each, all started together, then waited for.  Returns {name: path};
    raises after every process has ended if any build failed."""
    outs, procs = {}, {}
    for name, sources in libraries.items():
        sources = [str(s) for s in sources]
        out = outs[name] = library_path(name, sources)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = outs[name]
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name} "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str, sources) -> ctypes.CDLL:
    """Build (once) and load the library; later calls return the same
    handle."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sources)))
        _loaded[name] = lib
    return lib


def build_log(name: str, sources) -> str:
    """nvcc's output from building `name` (empty if not built yet)."""
    log = library_path(name, [str(s) for s in sources]).with_suffix(".log")
    return log.read_text() if log.exists() else ""

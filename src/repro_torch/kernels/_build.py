"""Build the port's CUDA sources with ``nvcc`` on first use and load them
with ``ctypes``.

Each kernel keeps its sources under ``<kernel>/csrc/`` and exports a plain
C interface (no PyTorch headers, so a build takes seconds).  Every source
is compiled by its own nvcc process, all started together; the objects of
one library are then linked into a shared library.  It goes to
``kernels/build/`` (listed in .gitignore) under a name that carries a
digest of the sources and flags, so an edited source is rebuilt and two
processes never load a half-written file: the library is linked to a
temporary name and renamed into place.  nvcc's output (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the
library as ``<name>.log``.

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
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

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


def _run_all(cmds):
    """Start every command at once, wait for all; returns [(cmd, rc, log)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    done = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        done.append((cmd, proc.returncode, log))
    return done


def build_all(libraries: dict) -> dict:
    """Build several libraries ({name: sources}) at once: one nvcc process
    per source, all started together, then one link per library.  Returns
    {name: path}; raises after every process has ended if any build
    failed."""
    outs, objs, compiles = {}, {}, []
    for name, sources in libraries.items():
        sources = [str(s) for s in sources]
        out = outs[name] = library_path(name, sources)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        objs[name] = []
        for src in sources:
            obj = out.with_suffix(f".{Path(src).stem}.{os.getpid()}.o")
            objs[name].append(obj)
            compiles.append((name, [find_nvcc(), *NVCC_FLAGS, "-c", "-o",
                                    str(obj), src]))
    logs = {name: [] for name in objs}
    failed = set()
    for (name, _), (cmd, rc, log) in zip(
            compiles, _run_all([cmd for _, cmd in compiles])):
        logs[name].append(" ".join(cmd) + "\n" + log)
        if rc != 0:
            failed.add(name)
    tmps = {name: outs[name].with_suffix(f".{os.getpid()}.tmp")
            for name in objs}
    links = {name: [find_nvcc(), "-shared", "-o", str(tmps[name]),
                    *map(str, objs[name])]
             for name in objs if name not in failed}
    for name, (cmd, rc, log) in zip(links, _run_all(links.values())):
        logs[name].append(" ".join(cmd) + "\n" + log)
        if rc != 0:
            failed.add(name)
        else:
            os.replace(tmps[name], outs[name])
    for name in objs:
        outs[name].with_suffix(".log").write_text("".join(logs[name]))
        for f in (*objs[name], tmps[name]):
            f.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed to build {name}:\n" + "".join(logs[name])
            for name in sorted(failed)))
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

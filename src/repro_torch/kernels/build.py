"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/repro_torch_kernels/`` at the repository root,
named by a hash of all the sources, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is reused. All missing sources are compiled
together, one ``nvcc`` process each. ``ptxas``'s register and spill report
is kept beside each library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module, and this
machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("ecdp", "paged_attn", "paged_ecdp", "decode_attn",
           "grouped_ecdp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA kernels cannot be built")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def resources(name: str) -> dict[str, dict[str, int]]:
    """What ptxas reported for each kernel of library ``name`` (built):
    {mangled name: {registers, smem (static bytes per block), spill_stores,
    spill_loads}}, read from its build log."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in lib_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The nvcc command that builds ``src`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    {name: library path}. Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log").open("w")
        procs[name] = (subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp), stdout=log,
            stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(name)
            continue
        os.replace(tmp, paths[name])        # atomic: concurrent builders
    if failed:
        msgs = [f"--- {n} ---\n" + paths[n].with_suffix(".log").read_text()
                for n in failed]
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib

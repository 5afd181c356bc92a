"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Builds happen at first use,
from the repository's sources only, into ``build/kernels/`` at the
repository root, named by a digest of the source, the headers beside it
and the flags (a stale library is never reused). ``nvcc``'s ``-Xptxas
-v`` report (registers, shared memory, spills) is kept next to each
library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()  # matlint: disable=ML017 import-time guard of the kernel build cache, never held across a query
_LIBS: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit at first use on a GPU host")


def library_path(source: Path) -> Path:
    """The library of ``source``, named by a digest of its bytes, of every
    header beside it (``*.cuh``, which a source may include) and of the
    flags: editing a header renames every library."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose library is missing — one ``nvcc`` per
    source, all started together — and return the library paths."""
    sources = [Path(s) for s in sources]
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outs


def load(source_name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source_name>``, built if needed."""
    src = CSRC_DIR / source_name
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            (path,) = build([src])
            lib = ctypes.CDLL(str(path))
            _LIBS[src] = lib
        return lib

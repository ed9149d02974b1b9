"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/torch_kernels/`` under the checkout, named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Building happens at first use, never at import.
A missing ``nvcc`` or a failed build raises: there is no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: ``-Xptxas -v`` makes nvcc report each kernel's registers, shared
#: memory and spills; that report is kept in ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: name -> nvcc output of the last build of that source in this process
build_log: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _lib_path(name: str, flags: Iterable[str]) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` per source, all started together.
    Returns name -> library path. Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) \
        if names is None else list(names)
    flags = NVCC_FLAGS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = []
    for name in names:
        path = _lib_path(name, flags)
        out[name] = path
        if path.is_file():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate(timeout=600)
        build_log[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n"
                            f"{build_log[name]}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)  # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib

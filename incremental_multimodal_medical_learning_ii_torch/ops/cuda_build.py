"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  Libraries go into
``_build/`` beside this package (listed in ``.gitignore``), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.  Nothing is compiled or loaded at import: the
first call that needs a kernel builds it, and :func:`build` compiles
several sources in parallel (one ``nvcc`` each).

A launcher returns the CUDA error code of its launch (0 on success); the
wrappers raise on anything else.  :func:`launcher` binds a launcher's
``argtypes`` once and caches it, so a wrapper's call costs one dict lookup
on the host beside the launch itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

SOURCES = {
    "fused_cosine": "fused_cosine.cu",
    "fused_bottleneck": "fused_bottleneck.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[Tuple[str, str], Callable] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, every
    shared header in ``csrc/`` (an edited header rebuilds every kernel) and
    the flags."""
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; raises with the compiler's output on a
    failed build.  The ``ptxas -v`` report (registers, spills, shared
    memory) is kept beside each library as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[n]} (rc {proc.returncode}):\n{text}")
            continue
        Path(str(paths[n]) + ".log").write_text(text)
        os.replace(tmp, paths[n])  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's report for a built kernel ('' if none was kept)."""
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def launcher(name: str, symbol: str, argtypes: list) -> Callable:
    """A launcher of kernel ``name``, its ``argtypes`` bound and ``restype``
    set to ``c_int`` on the first call; later calls return the cached
    function without a lock or an attribute lookup."""
    fn = _launchers.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[(name, symbol)] = fn
    return fn


def current_stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card, as an int,
    without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())

"""Native (C++) runtime: the mmap embedding store and its prefetching
batcher (``embstore.cpp``), bound with ``ctypes``.

The library builds at first use with the host ``g++`` into the package's
``_build/`` directory, named by a hash of the source and the flags (an
edited source builds anew), through a per-process temporary file renamed
into place, so two processes racing the build never load a half-written
library.  Nothing builds at import.  Without a toolchain
:func:`load_library` returns ``None`` and :func:`native_build_error` says
why; ``data/native.py`` then keeps the store as ``.npz``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).parent / "embstore.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libembstore-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``subprocess.CalledProcessError`` (with the compiler's output) or
    ``FileNotFoundError`` (no ``g++``)."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64 = ctypes.c_uint64, ctypes.c_int64
    p = ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    up = ctypes.POINTER(ctypes.c_uint64)
    lib.embstore_write.argtypes = [ctypes.c_char_p, fp, fp, u64, u64, u64]
    lib.embstore_write.restype = ctypes.c_int
    lib.embstore_open.argtypes = [ctypes.c_char_p]
    lib.embstore_open.restype = p
    for fn in ("embstore_n", "embstore_emb_dim", "embstore_n_labels"):
        getattr(lib, fn).argtypes = [p]
        getattr(lib, fn).restype = u64
    lib.embstore_gather.argtypes = [p, up, u64, fp, fp]
    lib.embstore_gather.restype = None
    lib.embstore_close.argtypes = [p]
    lib.embstore_close.restype = None
    lib.batcher_create.argtypes = [p, i64, i64, ctypes.c_int, u64]
    lib.batcher_create.restype = p
    lib.batcher_start_epoch.argtypes = [p]
    lib.batcher_start_epoch.restype = None
    lib.batcher_next.argtypes = [p, fp, fp, fp]
    lib.batcher_next.restype = i64
    lib.batcher_destroy.argtypes = [p]
    lib.batcher_destroy.restype = None
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; ``None`` when it cannot be
    built or loaded (:func:`native_build_error` has the reason)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    try:
        _lib = _bind(ctypes.CDLL(str(build_library())))
    except subprocess.CalledProcessError as e:
        _build_error = f"g++ failed ({e.returncode}):\n{e.stderr}"
    except (FileNotFoundError, OSError) as e:
        # no g++, or a library that will not load on this host
        _build_error = f"{type(e).__name__}: {e}"
    return _lib


def native_build_error() -> Optional[str]:
    """Why the library is unavailable (``None`` if it loaded or was not
    tried yet)."""
    return _build_error

"""The KV page allocator (``pq_alloc.cpp``), built with ``g++`` and bound
with ``ctypes``.

Nothing happens at import. The first :class:`PageAllocator` builds
``_build/libpq_alloc_<hash>.so`` beside the package (the hash covers the
source and the flags, so an edited source rebuilds), loads it and checks its
``pq_abi_version``. A failed build or a wrong ABI raises: there is no Python
free list to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "pq_alloc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
ABI_VERSION = 2

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the allocator if the library for this source is missing;
    return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out = BUILD_DIR / f"libpq_alloc_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed to build the page allocator:\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)  # atomic: concurrent builds race safely
    return out


def lib() -> ctypes.CDLL:
    """The loaded allocator library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.pq_abi_version.restype = ctypes.c_int32
            handle.pq_abi_version.argtypes = []
            if handle.pq_abi_version() != ABI_VERSION:
                raise RuntimeError(f"page allocator ABI {handle.pq_abi_version()}, "
                                   f"want {ABI_VERSION}")
            i32, p_i32 = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
            handle.pq_alloc_create.restype = ctypes.c_void_p
            handle.pq_alloc_create.argtypes = [i32]
            handle.pq_alloc_destroy.argtypes = [ctypes.c_void_p]
            handle.pq_alloc_pages.restype = i32
            handle.pq_alloc_pages.argtypes = [ctypes.c_void_p, i32, p_i32]
            handle.pq_free_pages.argtypes = [ctypes.c_void_p, p_i32, i32]
            handle.pq_num_free.restype = i32
            handle.pq_num_free.argtypes = [ctypes.c_void_p]
            _lib = handle
    return _lib


class PageAllocator:
    """O(1) free list of ``num_pages`` KV page ids (native C++)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._lib = lib()
        self._h = self._lib.pq_alloc_create(num_pages)
        if not self._h:
            raise MemoryError(f"pq_alloc_create({num_pages}) failed")

    def alloc(self, n: int) -> list[int] | None:
        """All-or-nothing: n page ids, or None when fewer are free."""
        out = (ctypes.c_int32 * n)()
        got = self._lib.pq_alloc_pages(self._h, n, out)
        return list(out) if got == n else None

    def free(self, pages) -> None:
        """Return pages to the list; a page that is not allocated is ignored."""
        if pages:
            arr = (ctypes.c_int32 * len(pages))(*pages)
            self._lib.pq_free_pages(self._h, arr, len(pages))

    @property
    def num_free(self) -> int:
        return int(self._lib.pq_num_free(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pq_alloc_destroy(self._h)
            self._h = None


__all__ = ["PageAllocator", "build", "lib"]

"""Build and load the native host runtime (g++ -> shared library -> ctypes).

``llcomp_host.cpp`` is the port's own copy of the JAX package's threaded C++
runtime: the rev-2 codec one stream a thread, no dependencies.  It is
compiled on first use with the JAX package's flags (``-O3 -std=c++17
-shared -fPIC -DNDEBUG -pthread``) into ``llcomp_tpu_torch/_build/`` (listed
in ``.gitignore``), keyed by a hash of the source, and replaced atomically so
that concurrent builds never load half a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_SRC = pathlib.Path(__file__).resolve().parent / "llcomp_host.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-DNDEBUG", "-pthread"]
COMPILERS = ("$CXX", "g++", "clang++")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def compiler() -> str:
    """Path of the C++ compiler: $CXX, else g++, else clang++."""
    for cc in (os.environ.get("CXX"), "g++", "clang++"):
        if cc and shutil.which(cc):
            return cc
    raise NativeBuildError("no C++ compiler found (tried "
                           f"{', '.join(COMPILERS)}): the native runtime "
                           "needs one to build llcomp_host.cpp")


def build(force: bool = False) -> pathlib.Path:
    """Compile the runtime unless a build of this exact source and these
    flags exists (``force``: compile it all the same); -> the shared
    library's path."""
    key = _SRC.read_bytes() + " ".join(FLAGS).encode()
    out = BUILD_DIR / f"_llcomp_host_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR,
                                     delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    try:
        subprocess.run([cc, *FLAGS, "-o", str(tmp_path), str(_SRC)],
                       check=True, capture_output=True)
        tmp_path.replace(out)  # atomic within the directory
    except subprocess.CalledProcessError as e:
        tmp_path.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{cc} failed on {_SRC.name}:\n"
            f"{e.stderr.decode(errors='replace')}") from e
    for old in BUILD_DIR.glob("_llcomp_host_*.so"):
        if old != out:
            old.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """The runtime's library with every entry point's signature declared,
    built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    pp = ctypes.POINTER(vp)
    sigs = {
        "llct_out_cap": (sz, [i, i, i]),
        "llct_encode_stream": (sz, [vp, i, i, i, vp, sz, vp]),
        "llct_decode_stream": (i, [vp, sz, i, i, i, vp, vp]),
        "llct_expand_slots": (sz, [vp, vp, sz, vp, sz]),
        "llct_decode_batch": (i, [pp, ctypes.POINTER(sz), i, i, i, i, pp, i,
                                  vp]),
        "llct_encode_batch": (None, [pp, i, i, i, i, pp, sz,
                                     ctypes.POINTER(sz), i, vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib

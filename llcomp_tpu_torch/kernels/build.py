"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled on
first use for Hopper (``sm_90a``) into ``llcomp_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of its source, of the shared headers
(``csrc/*.cuh``), of the flags and of the build's ``-D`` defines (kernels 1,
2, 3 and 5 are built once a codec configuration: ``config.defines``), and
loaded with ctypes.  Builds of other defines stay beside it.  No
PyTorch headers are compiled, so a build takes seconds.  Sources are read
only from the package's ``csrc/`` directory.  Each build keeps the
compiler's ``-Xptxas -v`` report (registers and spills of every kernel)
beside its library: ``compiler_log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}  # (name, defines)
_lock = threading.Lock()


class KernelCompileError(RuntimeError):
    pass


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelCompileError("nvcc not found (set CUDA_HOME)")
    return found


def build(name: str, defines: tuple[str, ...] = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` with the ``-D`` flags ``defines`` unless a
    build of this exact source, these headers, these flags and these
    defines exists; the compiler's report goes to the library's path with
    suffix ``.log``."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = (src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
           + " ".join(defines).encode())
    out = BUILD_DIR / f"lib{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR,
                                     delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    try:
        r = subprocess.run([compiler, *NVCC_FLAGS, *defines, "-o",
                            str(tmp_path), str(src)], check=True,
                           capture_output=True)
        out.with_suffix(".log").write_bytes(r.stderr)
        tmp_path.replace(out)  # atomic within the directory
    except subprocess.CalledProcessError as e:
        tmp_path.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed on {src.name} {' '.join(defines)}:\n"
            f"{e.stderr.decode(errors='replace')}") from e
    return out


def compiler_log(name: str, defines: tuple[str, ...] = ()) -> str:
    """The compiler's report (``-Xptxas -v``) of the build of
    ``csrc/<name>.cu`` with ``defines``, built on first use."""
    return build(name, defines).with_suffix(".log").read_text()


def load(name: str, entry: str, argtypes: list,
         defines: tuple[str, ...] = ()):
    """The C entry point ``entry`` of ``csrc/<name>.cu`` built with
    ``defines``, built on first use.

    ``argtypes`` must name ``ctypes.c_void_p`` for every pointer and the
    stream (an undeclared int argument would cut a pointer to 32 bits).  The
    entry returns the launch's ``cudaGetLastError()``.
    """
    key = (name, tuple(defines))
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build(name, key[1])))
        fn = getattr(_libs[key], entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def constant(name: str, const: str) -> int:
    """The value of ``constexpr int <const> = N;`` in ``csrc/<name>.cu``
    (a kernel's compile-time shape: chunks, depth)."""
    src = (CSRC / f"{name}.cu").read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    if m is None:
        raise KernelCompileError(f"{name}.cu defines no {const}")
    return int(m[1])


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")

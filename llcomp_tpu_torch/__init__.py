"""llcomp_tpu_torch: the llcomp rev-2 codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``llcomp_tpu`` that gives the same bytes.  It imports torch and
numpy, never JAX.  Public API (lazy: importing the package builds nothing):
    compress(img, slices=..., device="cuda", backend="torch") -> bytes
    decompress(data, device="cuda", backend="torch")          -> np.ndarray
    compress_sliced(img) / decompress_sliced(data)            sliced aliases
    reencode_slice(data, index, stripe, device="cuda")        -> bytes
Beside it: ``corpus`` (many images in shared lane batches), ``host`` (the
native C++ runtime), ``rev0`` (the legacy bitstream) and the CLI,
``python -m llcomp_tpu_torch.cli``.
"""
from .core.config import EXT, EXT_SLICED, REV2, CodecConfig  # noqa: F401

__version__ = "0.1.0"

_API = ("compress", "decompress", "compress_sliced", "decompress_sliced",
        "reencode_slice")


def __getattr__(name):
    if name in _API:
        from . import api

        return getattr(api, name)
    raise AttributeError(name)

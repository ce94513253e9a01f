"""The native host runtime: the rev-2 codec in threaded C++ on the CPU."""
from .build import NativeBuildError, load_library  # noqa: F401

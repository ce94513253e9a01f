"""Image files for the CLI."""
from .images import load_image, save_image  # noqa: F401

"""decode_mps: megapixels of every call in the window over the window's
host seconds (first call's start to last call's end; the restore cells)."""


def read(run):
    return run.mps()

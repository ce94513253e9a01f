"""copy_ms.encode: device ms a call of host-to-device and device-to-host
copies in the trace of the window (the ingest cells)."""
from portbench import devtrace


def read(run):
    return devtrace.copy_ms(run)

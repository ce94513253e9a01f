"""idle_pct.decode: the share of the traced window in which no kernel,
copy or fill runs on the card, % (the restore cells)."""
from portbench import devtrace


def read(run):
    return devtrace.idle_pct(run)

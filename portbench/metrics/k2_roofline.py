"""k2_roofline: kernel 2 (``decode_kernel``) against its bound, %.

The bound of each call (``roofline.decode_bound``: the corpus's lanes and
symbols, its decisions counted from the reference's residuals, the bytes of
the streams the call read) summed over the window's calls, over the
kernel's device seconds in the trace of the window.
"""
from portbench import roofline

KERNEL = "decode_kernel"


def read(run):
    t = run.trace
    if t is None or not t.kernel_s.get(KERNEL):
        return None
    ms = 0.0
    for c in run.calls:
        if not c["ok"]:
            continue
        f = run.item_facts(c["item"])
        overhead = 24 * len(run.corpora[c["item"]]) + 8 * f["lanes"]
        ms += roofline.decode_bound(
            f["lanes"], f["symbols"], run.decisions(c["item"]),
            c["in_bytes"] - overhead)["bound_ms"]
    return 100.0 * ms / 1e3 / t.kernel_s[KERNEL]

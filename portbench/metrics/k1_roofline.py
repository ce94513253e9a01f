"""k1_roofline: kernel 1 (``encode_fused_kernel``) against its bound, %.

The bound of each call (``roofline.encode_bound``: the corpus's lanes and
symbols, its decisions counted from the reference's residuals, the bytes of
the streams the call returned) summed over the window's calls, over the
kernel's device seconds in the trace of the window.
"""
from portbench import roofline

KERNEL = "encode_fused_kernel"


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
        ms += roofline.encode_bound(
            f["lanes"], f["symbols"], run.decisions(c["item"]),
            c["out_bytes"] - overhead)["bound_ms"]
    return 100.0 * ms / 1e3 / t.kernel_s[KERNEL]

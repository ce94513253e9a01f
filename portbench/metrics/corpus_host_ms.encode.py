"""corpus_host_ms.encode: host ms a call of ``compress_corpus`` outside its
lane part: the benchmark's span around the call less the program's own
span of the lane batches (``CorpusStats.encode_s``): the argument checks,
the region plan, the policy and the container packing."""


def read(run):
    rest = [c["s"] - c["encode_s"] for c in run.calls
            if c["ok"] and "encode_s" in c]
    return sum(rest) / len(rest) * 1e3 if rest else None

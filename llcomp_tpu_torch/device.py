"""The port's device rule: explicit, and never a silent fall back to the CPU;
and how lanes are spread over devices and streams (``shard_plan``,
``pieces``, ``overlapped``), the one scheduler of every lane loop."""
from __future__ import annotations

import collections
import contextlib

import torch


def resolve(device) -> torch.device:
    """``device`` (a string or ``torch.device``) -> ``torch.device``.

    Raises when CUDA is asked for and there is none: a call made for the GPU
    never quietly runs the CPU versions instead.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def guard(dev: torch.device, stream=None) -> contextlib.ExitStack:
    """The context in which work for ``dev`` is queued: a CUDA ``dev`` made
    the current device (a kernel launches on the host thread's current
    device, whatever its tensors' device), and ``stream``, where given,
    made its current stream; nothing for the CPU."""
    ctx = contextlib.ExitStack()
    if dev.type == "cuda":
        ctx.enter_context(torch.cuda.device(dev))
        if stream is not None:
            ctx.enter_context(torch.cuda.stream(stream))
    return ctx


_SIDE: dict = {}     # device index -> its side streams


def side_streams(dev: torch.device, n: int) -> list:
    """``n`` side streams of ``dev``, the same ones on every call: the
    caching allocator keeps freed blocks per stream, so fresh streams would
    allocate the pieces' buffers anew on each call."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    have = _SIDE.setdefault(index, [])
    while len(have) < n:
        have.append(torch.cuda.Stream(index))
    return have[:n]


def shard_plan(S: int, n: int) -> list[tuple[int, int]]:
    """The lanes of each of ``n`` devices: device k takes the contiguous
    block ``[k*per, min((k+1)*per, S))``, per = ceil(S/n); blocks past the
    last lane are empty (3 lanes over 8 devices: 3 of one lane, 5 empty)."""
    if n < 1:
        raise ValueError(f"shard_plan needs n >= 1, got {n}")
    per = -(-S // n)
    return [(min(k * per, S), min((k + 1) * per, S)) for k in range(n)]


def pieces(S: int, devs: list, step: int) -> list[tuple]:
    """Lanes [0, S) over ``devs``: device k's block of ``shard_plan`` cut
    into pieces of at most ``step`` lanes, as (device, lo, hi), piece w of
    every block before piece w + 1 of any."""
    cut = [[(devs[k], c, min(c + step, b)) for c in range(a, b, step)]
           for k, (a, b) in enumerate(shard_plan(S, len(devs)))]
    depth = max(map(len, cut), default=0)
    return [p[w] for w in range(depth) for p in cut if w < len(p)]


def most_shards(devs: list) -> int:
    """The most entries of one device in the list ``devs``."""
    return max(collections.Counter(devs).values(), default=1)


def overlapped(work: list[tuple], launch, collect, limit: int) -> list:
    """Run ``work``, items (device, args), with their copies and kernels
    overlapped: ``launch(*args, device, stream)`` queues an item and
    returns what ``collect`` takes to bring it back.  A device holds at
    most ``limit`` items in flight: before an item launches, its device's
    oldest is collected while the device holds ``limit``.  Where a CUDA
    device may hold two or more at once, each takes a side stream of its
    own (``side_streams``); otherwise, and on the CPU, an item runs on the
    current stream.  -> each item's collected result, in ``work``'s
    order."""
    count = collections.Counter(dev for dev, _ in work)
    seen: collections.Counter = collections.Counter()
    inflight: dict = {}
    out: list = [None] * len(work)
    for i, (dev, args) in enumerate(work):
        n = min(limit, count[dev])
        stream = (side_streams(dev, n)[seen[dev] % n]
                  if dev.type == "cuda" and n > 1 else None)
        seen[dev] += 1
        queue = inflight.setdefault(dev, collections.deque())
        while len(queue) >= limit:
            j, item = queue.popleft()
            out[j] = collect(*item)
        queue.append((i, launch(*args, dev, stream)))
    for j, item in sorted((p for q in inflight.values() for p in q),
                          key=lambda p: p[0]):
        out[j] = collect(*item)
    return out

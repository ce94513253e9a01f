"""Sanitizers over llcomp_tpu_torch's native runtime, the port's
counterpart of ``tests/test_sanitizer.py``.

``native/llcomp_host.cpp`` is built with a small runner
(``tests/torch_sanitizer_runner.cpp``) into one executable under ASan +
UBSan and one under TSan, and run as a subprocess, so that no sanitized
library is loaded into Python.  Every buffer the runner hands the runtime
is a heap block of exactly the length in play: the image, the stream (a
cut stream's buffer ends at the cut), the ``llct_out_cap`` buffer that a
noisy stream passes.  The runtime must give ``llcomp_tpu.oracle``'s
bytes, decode corrupt streams as ``llcomp_tpu``'s native library does,
and draw no sanitizer report: the fuzz corpus of
``tests/test_torch_fuzz.py``, the inputs that pass the runtime's buffer,
cut and flipped streams, and the batch entry points on 4 threads.
"""
from __future__ import annotations

import importlib
import os
import pathlib
import struct
import subprocess

import numpy as np
import pytest

from llcomp_tpu import oracle
from llcomp_tpu.core import tables as jtables
from llcomp_tpu.native import load_library as jload_library
from llcomp_tpu_torch.native import build as native_build
from tests.test_native import _malicious_stream
from tests.test_torch_fuzz import fuzz_corpus

cs = importlib.import_module("chip_smoke")
HERE = pathlib.Path(__file__).resolve().parent
RUNNER = HERE / "torch_sanitizer_runner.cpp"
FLAGS = {"asan": ["-fsanitize=address,undefined"],
         "tsan": ["-fsanitize=thread"]}
COMMON = ["-O1", "-g", "-std=c++17", "-fno-omit-frame-pointer",
          "-fno-sanitize-recover=all", "-pthread"]
ENV = {"ASAN_OPTIONS": "halt_on_error=1:detect_leaks=1",
       "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
       "TSAN_OPTIONS": "halt_on_error=1"}
REPORTS = (b"AddressSanitizer", b"LeakSanitizer", b"runtime error",
           b"ThreadSanitizer")
BATCH_THREADS = 4


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """{'asan': path, 'tsan': path}: the runtime and its runner, built under
    each sanitizer; skips where the compiler cannot build one."""
    d = tmp_path_factory.mktemp("native_sanitizers")
    cc = native_build.compiler()
    exes = {}
    for name, flags in FLAGS.items():
        exe = d / f"runner_{name}"
        try:
            subprocess.run([cc, *COMMON, *flags, "-o", str(exe), str(RUNNER),
                            str(native_build._SRC)],
                           check=True, capture_output=True, timeout=300)
        except subprocess.CalledProcessError as e:
            pytest.skip(f"{cc} cannot build with {' '.join(flags)}: "
                        f"{e.stderr.decode(errors='replace')[:300]}")
        exes[name] = exe
    return exes


class Jobs:
    """Jobs for the runner and, after ``run``, a reader of its replies."""

    def __init__(self):
        self.parts: list[bytes] = []
        self.out = b""
        self.pos = 0

    def _job(self, header, *payloads, prior=None) -> None:
        flag = 0 if prior is None else 1
        self.parts.append(" ".join(map(str, (*header, flag))).encode() + b"\n")
        self.parts.extend(payloads)
        if prior is not None:
            self.parts.append(np.ascontiguousarray(prior, np.uint8).tobytes())

    def encode(self, img, prior=None) -> None:
        H, W, C = img.shape
        self._job(("E", W, H, C), img.tobytes(), prior=prior)

    def decode(self, stream: bytes, shape, prior=None) -> None:
        H, W, C = shape
        self._job(("D", W, H, C, len(stream)), stream, prior=prior)

    def encode_batch(self, lanes, cap: int, prior=None) -> None:
        S, H, W, C = lanes.shape
        self._job(("BE", S, W, H, C, cap, BATCH_THREADS), lanes.tobytes(),
                  prior=prior)

    def decode_batch(self, streams, shape, prior=None) -> None:
        H, W, C = shape
        self._job(("BD", len(streams), W, H, C, BATCH_THREADS),
                  *(struct.pack("<Q", len(s)) + s for s in streams),
                  prior=prior)

    def run(self, exe) -> "Jobs":
        """Runs every job in one process; fails on a sanitizer report."""
        r = subprocess.run([str(exe)], input=b"".join(self.parts),
                           capture_output=True, timeout=300,
                           env={**os.environ, **ENV})
        err = r.stderr.decode(errors="replace")
        assert r.returncode == 0, err[-2000:]
        assert not any(k in r.stderr for k in REPORTS), err[-2000:]
        self.out, self.pos = r.stdout, 0
        return self

    def take(self, n: int) -> bytes:
        got = self.out[self.pos : self.pos + n]
        assert len(got) == n, "short reply from the runner"
        self.pos += n
        return got

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def encoded(self) -> tuple[int, bytes]:
        """(length into llct_out_cap bytes, final stream)."""
        first, n = self.u64(), self.u64()
        return first, self.take(n)

    def decoded(self, shape) -> tuple[int, np.ndarray]:
        rc = self.i32()
        return rc, np.frombuffer(self.take(int(np.prod(shape))),
                                 np.uint8).reshape(shape)

    def done(self) -> None:
        assert self.pos == len(self.out), "trailing reply from the runner"


def out_cap(shape) -> int:
    H, W, C = shape
    return H * W * C * 3 // 2 + 64


def want(img, prior=None) -> bytes:
    return oracle.encode_planes(oracle.rct_forward(img), seed=prior)


def reference_decode(stream: bytes, shape, prior=None
                     ) -> tuple[int, np.ndarray]:
    """llcomp_tpu's native decoder into a zeroed image: (rc, pixels)."""
    H, W, C = shape
    buf = np.frombuffer(stream, np.uint8)
    out = np.zeros(shape, np.uint8)
    tab = None if prior is None else np.ascontiguousarray(prior, np.uint8)
    rc = jload_library().llct_decode_stream(
        buf.ctypes.data if buf.size else None, buf.size, W, H, C,
        out.ctypes.data, None if tab is None else tab.ctypes.data)
    return rc, out


def test_asan_fuzz_corpus_equals_the_oracle(runners):
    corpus = fuzz_corpus()
    jobs = Jobs()
    for img, primed in corpus:
        prior = jtables.PRIOR_TAB if primed else None
        jobs.encode(img, prior)
        jobs.decode(want(img, prior), img.shape, prior)
    jobs.run(runners["asan"])
    for img, primed in corpus:
        prior = jtables.PRIOR_TAB if primed else None
        first, stream = jobs.encoded()
        assert stream == want(img, prior), img.shape
        assert first == len(stream)
        rc, out = jobs.decoded(img.shape)
        assert rc == 0
        np.testing.assert_array_equal(out, img)
    jobs.done()


@pytest.mark.parametrize("name", ["noise 8x20x4", "noise 20x25x3"])
def test_asan_streams_past_the_buffer(runners, name):
    """Noise whose stream passes llct_out_cap (20x25x3: 2,344 bytes against
    a buffer of 2,314) is counted, encoded again and equals the oracle,
    unprimed and seeded."""
    img = cs.overflow_batches()[name][0]
    starts = (None, cs.OVERFLOW_SEED)
    jobs = Jobs()
    for prior in starts:
        jobs.encode(img, prior)
    jobs.run(runners["asan"])
    for prior in starts:
        first, stream = jobs.encoded()
        assert stream == want(img, prior)
        assert first == len(stream) > out_cap(img.shape)
    jobs.done()
    if name == "noise 20x25x3":
        assert out_cap(img.shape) == 2314 and len(want(img)) == 2344


def corrupt_streams(stream: bytes) -> list[bytes]:
    """Cuts (to nothing, one byte, half, all but one byte) and flipped
    bytes (first, middle, last) of ``stream``."""
    n = len(stream)
    cuts = [stream[:k] for k in sorted({0, 1, n // 2, max(n - 1, 0)})]
    flips = []
    for k in sorted({0, n // 2, n - 1}):
        b = bytearray(stream)
        b[k] ^= 0x5A
        flips.append(bytes(b))
    return cuts + flips


def test_asan_cut_and_flipped_streams(runners):
    """Corrupt streams, each in a buffer that ends where it ends, decode as
    llcomp_tpu's native library decodes them: the same error flag and
    pixels.  The fuzz corpus's cut and flipped streams decode to wrong
    pixels with no error; an unterminated exponent, whole and cut, sets
    the flag."""
    cases = []
    for img, primed in fuzz_corpus():
        prior = jtables.PRIOR_TAB if primed else None
        cases += [(s, img.shape, prior)
                  for s in corrupt_streams(want(img, prior))]
    bad = _malicious_stream()
    cases += [(s, shape, None) for s in (bad, bad[: len(bad) // 2])
              for shape in ((1, 1, 1), (4, 4, 3), (3, 5, 2))]
    jobs = Jobs()
    for stream, shape, prior in cases:
        jobs.decode(stream, shape, prior)
    jobs.run(runners["asan"])
    rcs = []
    for stream, shape, prior in cases:
        rc, out = jobs.decoded(shape)
        want_rc, want_out = reference_decode(stream, shape, prior)
        assert rc == want_rc, (shape, len(stream))
        np.testing.assert_array_equal(out, want_out)
        rcs.append(rc)
    jobs.done()
    assert 0 < sum(rcs) < len(rcs)


def test_tsan_batch_entry_points(runners):
    """llct_encode_batch and llct_decode_batch on 4 threads over 24 lanes
    of noise and photo stripes, about half of them past their buffer:
    the oracle's bytes, exact pixels, and on a batch with a cut and an
    unterminated stream the failures llcomp_tpu's native library counts."""
    lanes = cs.overflow_batches()[cs.MIXED][:24]
    shape = lanes.shape[1:]
    cap = out_cap(shape)
    streams = [want(lane) for lane in lanes]
    over = [k for k, s in enumerate(streams) if len(s) > cap]
    assert 0 < len(over) < len(lanes)
    long_cap = max(len(streams[k]) for k in over)
    bad = [streams[0][: len(streams[0]) // 2], _malicious_stream(),
           *streams[2:]]
    jobs = Jobs()
    jobs.encode_batch(lanes, cap)
    jobs.encode_batch(lanes[over], long_cap)
    jobs.decode_batch(streams, shape)
    jobs.decode_batch(bad, shape)
    jobs.run(runners["tsan"])
    lens = [jobs.u64() for _ in lanes]
    assert lens == [len(s) for s in streams]
    for k, s in enumerate(streams):
        assert jobs.take(min(lens[k], cap)) == s[:cap]
    again = [jobs.u64() for _ in over]
    assert again == [len(streams[k]) for k in over]
    for k in over:
        assert jobs.take(len(streams[k])) == streams[k]
    assert jobs.i32() == 0
    np.testing.assert_array_equal(
        np.frombuffer(jobs.take(lanes.nbytes), np.uint8).reshape(lanes.shape),
        lanes)
    failures = jobs.i32()
    jobs.take(lanes.nbytes)
    assert failures == sum(reference_decode(s, shape)[0] for s in bad) > 0
    jobs.done()


SANITIZER_OUTPUT = """\
========= COMPUTE-SANITIZER
========= Invalid __global__ read of size 16 bytes
=========     at decode_kernel<3>+0x1a0 in /r/_build/variant_decode.cu:85
=========     by thread (3,0,0) in block (0,0,0)
=========     Address 0x7f00 is out of bounds
=========
========= Invalid __global__ write of size 4 bytes
=========     at void at::native::elementwise_kernel<128, 2>(int)+0x2c0
=========     by thread (0,0,0) in block (0,0,0)
=========
{"tool": "memcheck"}
========= ERROR SUMMARY: 2 errors
"""


def test_sanitizer_reports_split_by_source():
    """Phase 11 fails on compute-sanitizer's reports in the port's
    kernels (their lines name a ``_build`` or ``csrc`` file) and prints
    the others."""
    ours, other, heads = cs._tool_reports(SANITIZER_OUTPUT)
    assert (ours, other) == (1, 1)
    assert heads == ["Invalid __global__ write of size 4 bytes"]
    assert cs._tool_reports("========= ERROR SUMMARY: 0 errors\n") == (
        0, 0, [])

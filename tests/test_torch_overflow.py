"""Streams longer than a lane's ``outcap`` row (raw * 1.5 + 64): small
high-entropy images, whose streams pass that size, on every encode path of
llcomp_tpu_torch, held against the JAX package's NumPy oracle
(``llcomp_tpu.oracle.encode``) or its native library called directly with a
buffer of ``encode.max_stream_bytes``.  Tolerance: exact bytes and pixels.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from llcomp_tpu import oracle
from llcomp_tpu.core import tables as jtables
from llcomp_tpu.native import load_library as jload_library
from llcomp_tpu_torch import api, container, encode, host
from llcomp_tpu_torch import seed as seedmod
from llcomp_tpu_torch.kernels import encode_fused as ef
from tests.conftest import make_photo

cs = importlib.import_module("chip_smoke")
BATCHES = cs.overflow_batches()
# the inputs of the fault's report: each stream passes its outcap
IMAGES = {name: BATCHES[name][0] for name in
          ("noise 8x20x4", "noise 8x55x3", "two-level 8x168x3")}
# passes the native runtime's buffer (raw * 1.5 + 64) but not outcap
NATIVE_ONLY = BATCHES["noise 20x25x3"][0]
SEED = cs.OVERFLOW_SEED


def noise(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def two_level(shape, seed: int) -> np.ndarray:
    """Noise of two levels: each sample 0-47 or 208-255."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, shape) * 208
            + rng.integers(0, 48, shape)).astype(np.uint8)


def reference(img: np.ndarray, init=None) -> bytes:
    """The JAX package's native encoder into a buffer of max_stream_bytes:
    the headerless stream, checked to fit that bound."""
    img = np.ascontiguousarray(img)
    H, W, C = img.shape
    cap = encode.max_stream_bytes(img.size)
    out = np.empty(cap, np.uint8)
    tab = None if init is None else np.ascontiguousarray(init, np.uint8)
    n = jload_library().llct_encode_stream(
        img.ctypes.data, W, H, C, out.ctypes.data, cap,
        None if tab is None else tab.ctypes.data)
    assert 0 < n <= cap
    return out[:n].tobytes()


def check_streams(streams, lanes, init=None) -> None:
    """Each stream equals the reference's and is at most max_stream_bytes."""
    assert len(streams) == len(lanes)
    for s, lane in zip(streams, lanes):
        assert len(s) <= encode.max_stream_bytes(lane.size)
        assert s == reference(lane, init)


def check_container(blob: bytes, img: np.ndarray) -> None:
    """Each stripe of a sliced container equals the reference's stream under
    the container's flags."""
    streams, W, H, C, slice_h, flags, seed_blob, tile_w = \
        container.unpack_sliced(blob)
    init = (seedmod.unpack_blob(seed_blob) if flags & container.FLAG_SEEDED
            else jtables.PRIOR_TAB if flags & container.FLAG_PRIMED else None)
    regions = container.tile_regions(W, H, slice_h, tile_w)
    check_streams(streams, [img[y0:y1, x0:x1] for y0, y1, x0, x1 in regions],
                  init)


def mixed_lanes() -> np.ndarray:
    """8x20x4 lanes, ordinary and overflowing ones mixed: noise seeds 0, 1
    and 6 take 1,035, 1,027 and 1,026 bytes unprimed, seed 2 exactly its
    1,024-byte row, photos far less."""
    return np.stack([make_photo(8, 20, 4, seed=1), noise((8, 20, 4), 0),
                     noise((8, 20, 4), 2), noise((8, 20, 4), 1),
                     make_photo(8, 20, 4, seed=2), noise((8, 20, 4), 6)])


def test_inputs_pass_outcap_and_stay_within_the_bound():
    """The fault's inputs need more than outcap, at most max_stream_bytes;
    and on noise of many shapes no stream passes max_stream_bytes."""
    for img in IMAGES.values():
        assert encode.outcap(img.size) < len(reference(img))
    assert (host.load_library().llct_out_cap(25, 20, 3)
            < len(reference(NATIVE_ONLY)) <= encode.outcap(NATIVE_ONLY.size))
    for seed, shape in enumerate([(1, 1, 1), (1, 2, 3), (3, 5, 1), (8, 8, 4),
                                  (16, 16, 3), (2, 300, 3)]):
        for init in (None, jtables.PRIOR_TAB, SEED):
            reference(noise(shape, seed), init)
            reference(two_level(shape, seed), init)


def test_chip_smoke_overflow_goldens():
    """chip_smoke.py's pinned bytes for its lanes past their row: the
    reference's streams, the oracle's .llcomp, and a slices='auto' .llct
    whose every stream is the reference's."""
    for name, lanes in BATCHES.items():
        want = cs.OVERFLOW_SHA[name]
        assert cs.sha(lanes) == want["lanes"], name
        for mode, init in (("unprimed", None), ("seeded", SEED)):
            streams = [reference(lane, init) for lane in lanes]
            assert cs.sha(b"".join(streams)) == want[mode], (name, mode)
        if len(lanes) == 1:
            assert cs.sha(oracle.encode(lanes[0])) == want["llcomp"]
            blob = api.compress(lanes[0], slices="auto", backend="native")
            check_container(blob, lanes[0])
            assert cs.sha(blob) == want["llct"], name
    cap = encode.outcap(8 * 55 * 3)
    mixed = [len(reference(lane)) > cap for lane in BATCHES[cs.MIXED]]
    assert 0 < sum(mixed) < 64


def test_plain_kernel_counts_a_stream_past_its_row():
    """Kernel 1's plain version on an overflowing lane: its length counted
    in full, its flag set, the bytes inside the row those of the stream."""
    img = IMAGES["noise 8x20x4"]
    want = reference(img)
    xs = encode._fused_input(torch.from_numpy(img[None]), encode.REV2)
    out, lens, ovf = ef.encode_fused_plain(xs, None, 1024)
    assert lens.tolist() == [len(want)] and ovf.tolist() == [True]
    assert out[0].numpy().tobytes() == want[:1024]


@pytest.mark.parametrize("slices", [None, "auto"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_compress_equals_the_oracle(name, slices):
    """api.compress on the device path (plain versions on the CPU), one
    stream and sliced: the oracle's stream, and the round trip exact; the
    smallest also decoded on the device path."""
    img = IMAGES[name]
    ref = oracle.encode(img)
    blob = api.compress(img, slices=slices, device="cpu")
    if slices is None:
        assert blob == ref
    else:
        streams, *_, slice_h, flags, _, tile_w = container.unpack_sliced(blob)
        assert (len(streams), slice_h, flags & container.FLAG_PRIMED,
                tile_w) == (1, img.shape[0], 0, 0)
        assert streams[0] == ref[6:]
    np.testing.assert_array_equal(api.decompress(blob, backend="native"), img)
    if img.size <= 640 and slices is None:
        np.testing.assert_array_equal(api.decompress(blob, device="cpu"), img)


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_native_and_auto_backends(backend):
    """backend='native' and 'auto' (the native runtime for one stream and
    for few stripes), one stream and sliced, on every input."""
    for img in [*IMAGES.values(), NATIVE_ONLY]:
        ref = oracle.encode(img)
        assert api.compress(img, backend=backend) == ref
        blob = api.compress(img, slices="auto", backend=backend)
        check_container(blob, img)
        np.testing.assert_array_equal(
            api.decompress(blob, backend=backend), img)


def test_host_encode_stream_and_images():
    """host.encode_stream and encode_images: each stream past the native
    buffer encoded again; unprimed, primed and seeded."""
    for img in [*IMAGES.values(), NATIVE_ONLY]:
        assert host.encode_stream(img) == reference(img)
        assert host.encode_stream(img, seed=SEED) == reference(img, SEED)
        assert (host.decode_stream(host.encode_stream(img), img.shape)
                == img).all()
    lanes = mixed_lanes()
    for init, kw in ((None, {}), (jtables.PRIOR_TAB, {"primed": True}),
                     (SEED, {"seed": SEED})):
        streams = host.encode_images(lanes, n_threads=2, **kw)
        check_streams(streams, lanes, init)
        np.testing.assert_array_equal(
            host.decode_streams(streams, lanes.shape[1:], **kw), lanes)


def test_fused_engine_puts_each_recoded_lane_in_its_place():
    """The fused engine on a batch of ordinary and overflowing lanes,
    unprimed and seeded (every noise lane overflows, and is coded again
    from the seed), each stream the reference's; fused_tensors (the graft
    entry's step) gives the same rows."""
    lanes = mixed_lanes()
    unprimed = encode.encode_lanes(lanes, device="cpu")
    check_streams(unprimed, lanes)
    check_streams(encode.encode_lanes(lanes, seed=SEED, device="cpu"), lanes,
                  SEED)
    out, lens = encode.fused_tensors(torch.from_numpy(lanes))
    assert out.shape[1] % 4 == 0
    assert [out[s, : lens[s]].numpy().tobytes()
            for s in range(len(lanes))] == unprimed
    np.testing.assert_array_equal(
        api._decode_native(unprimed, lanes.shape[1:], False, None)[0], lanes)


@pytest.mark.parametrize("variant", ["symbol", "decision"])
def test_sort_engine_expands_at_the_counted_length(variant):
    """engine='sort': the symbol variant seeded (every noise lane past its
    outcap), the decision variant unprimed."""
    lanes = mixed_lanes()
    init = SEED if variant == "symbol" else None
    streams = encode.encode_lanes(lanes, seed=init, device="cpu",
                                  engine="sort", variant=variant)
    check_streams(streams, lanes, init)


@pytest.mark.parametrize("variant", ["symbol", "decision"])
def test_sort_engine_raises_at_its_offset_limit(monkeypatch, variant):
    """A stream whose length reaches OUTCAP_LIMIT raises ValueError, never a
    wrapped offset: the limit lowered to between the lane's outcap (1,024,
    which the up-front check passes) and its 1,035 bytes."""
    monkeypatch.setattr(encode, "OUTCAP_LIMIT", 1030)
    with pytest.raises(ValueError, match="OUTCAP_LIMIT"):
        encode.encode_lanes(IMAGES["noise 8x20x4"][None], device="cpu",
                            engine="sort", variant=variant)


def test_reencode_slice_of_an_overflowing_stripe():
    """reencode_slice heals a seeded stripe whose stream passes outcap: the
    container built by the native runtime comes back byte for byte."""
    img = np.concatenate([make_photo(8, 20, 4, seed=3), noise((8, 20, 4), 0)])
    streams = api._encode_regions(img, container.tile_regions(20, 16, 8, 0),
                                  encode.REV2, False, None, seed=SEED,
                                  backend="native")
    assert len(streams[1]) > encode.outcap(640)
    assert streams[1] == reference(img[8:], SEED)

    def pack(streams):
        return container.pack_sliced(
            streams, 20, 16, 4, 8, encode.REV2,
            flags=container.FLAG_SEEDED | container.FLAG_CRC,
            seed_blob=seedmod.pack_blob(SEED))

    blob = pack(streams)
    broken = np.frombuffer(blob, np.uint8).copy()
    broken[len(blob) - len(streams[1]):] ^= 0xFF        # slice 1's payload
    broken = broken.tobytes()
    assert api.decompress(broken, backend="native", strict=False)[1] == [1]
    assert api.reencode_slice(broken, 1, img[8:], device="cpu") == blob
    np.testing.assert_array_equal(api.decompress(blob, backend="native"), img)

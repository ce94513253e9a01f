"""The sort engine under every codec configuration, in the port (CPU).

The configurations are ``chip_smoke.CFG_CASES``.  ``encode_lanes(engine=
"sort")`` in both variants (kernels 3-7's plain versions here) is held
against ``llcomp_tpu.oracle`` and the port's fused engine on the lanes of
``tools/torch_jax_cfg_faults.py``; against the JAX package's XLA engine at
e_lim 3 / r_lim 5 / sign_ctx 6 and its Pallas sort chain (interpret mode)
at the small model, whose contexts are rev 2's (the JAX sort chain
hard-codes rev 2's contexts and 8 substates, and gives other bytes under
other contexts: only two JAX compiles here); primed and seeded lanes at 8
substates against the oracle; kernel 5's plain version against the JAX
package's ``binarize``; the sharded path over two CPU devices.  Tolerance:
exact bytes.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from chip_smoke import CFG_CASES
from llcomp_tpu import encode as jenc
from llcomp_tpu import oracle
from llcomp_tpu.core import transform as jtransform
from llcomp_tpu.core.config import CodecConfig as JaxConfig
from llcomp_tpu_torch import encode, parallel
from llcomp_tpu_torch.core import tables
from llcomp_tpu_torch.core.config import CodecConfig
from llcomp_tpu_torch.kernels import encode_kernels as ek

NAMES = list(CFG_CASES)
EIGHT = [n for n in NAMES if CodecConfig(**CFG_CASES[n]).substates == 8]
LANES = (np.random.default_rng(0).integers(0, 40, (3, 8, 12, 3))
         + np.arange(12)[None, None, :, None] * 4).astype(np.uint8)
SEED = np.roll(tables.PRIOR_TAB, 7, axis=0)   # a stored seed unlike the prior
# residuals at every exponent (0 to 10), both signs, each on its own hash
DIFFS = np.array([0, 1, -1, 2, -3, 5, -7, 12, -15, 31, 40, -63, 100, -127,
                  255, -256, 511, -700, 1023, -1024, 1274, -1274])


def cfgs(name: str) -> tuple[CodecConfig, JaxConfig]:
    return CodecConfig(**CFG_CASES[name]), JaxConfig(**CFG_CASES[name])


@functools.lru_cache(maxsize=None)
def _oracle(name: str) -> list[bytes]:
    _, jc = cfgs(name)
    return [oracle.encode(lane, jc)[6:] for lane in LANES]


def _sort(lanes, cfg, **kw) -> list[bytes]:
    return encode.encode_lanes(lanes, cfg, device="cpu", engine="sort", **kw)


@functools.lru_cache(maxsize=None)
def _sort_lanes(name: str, variant: str) -> list[bytes]:
    """The sort engine's streams of LANES under the cfg ``name``, coded
    once in a process (the plain coders take ~1 s here)."""
    return _sort(LANES, cfgs(name)[0], variant=variant)


@pytest.mark.parametrize("variant", encode.VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_sort_engine_equals_oracle_and_fused(name, variant):
    cfg, _ = cfgs(name)
    got = _sort_lanes(name, variant)
    assert got == _oracle(name)
    if variant == "symbol":       # the decision variant's equal the oracle's
        assert got == encode.encode_lanes(LANES, cfg, device="cpu")


def test_sort_engine_equals_jax_xla_at_e3():
    """e_lim 3 / r_lim 5 / sign_ctx 6: the JAX package's XLA engine gives
    the oracle's bytes (its sort chain does not)."""
    _, jc = cfgs("e3 r5 s6")
    want = jenc.encode_lanes(LANES, jc, engine="xla")
    assert want == _oracle("e3 r5 s6")
    for variant in encode.VARIANTS:
        assert _sort_lanes("e3 r5 s6", variant) == want


def test_sort_engine_equals_jax_sort_chain_at_small_model():
    """The small model keeps rev 2's contexts: there the JAX package's
    sort chain (engine='pallas', interpret mode) gives the oracle's
    bytes, and the port's sort engine gives the same."""
    _, jc = cfgs("small model")
    want = jenc.encode_lanes(LANES, jc, engine="pallas")
    assert want == _oracle("small model")
    for variant in encode.VARIANTS:
        assert _sort_lanes("small model", variant) == want


@pytest.mark.parametrize("name", EIGHT)
def test_primed_and_seeded_sort_lanes_equal_oracle(name):
    """Kernel 3's plain version from the bucket rows (the static prior and
    a stored seed) at every cfg of 8 substates."""
    cfg, jc = cfgs(name)
    lanes = LANES[:2, :4]
    for start in ({"primed": True}, {"seed": SEED}):
        assert _sort(lanes, cfg, **start) == [
            oracle.encode_planes(oracle.rct_forward(lane), jc, **start)
            for lane in lanes]


@pytest.mark.parametrize("name", NAMES)
def test_build_stream_plain_equals_jax_binarize(name):
    """Slot k of symbol j: (hash*substates + ctx)*2 + bit of the JAX
    package's ``binarize`` under the cfg, -1 where it is not valid and on
    the padding symbols past n_sym (the last two)."""
    cfg, jc = cfgs(name)
    hashes = (np.arange(len(DIFFS)) * 389) % cfg.num_hashes
    K = cfg.max_bins_per_symbol
    ctx, bit, valid, _ = (np.asarray(a) for a in jtransform.binarize(
        DIFFS[None].astype(np.int32), jc))
    n_sym = len(DIFFS) - 2
    valid = valid & (np.arange(len(DIFFS)) < n_sym)[None, :, None]
    want = np.where(valid, (hashes[None, :, None] * cfg.substates + ctx) * 2
                    + bit, -1).reshape(1, -1)
    got = ek.build_stream_plain(torch.from_numpy(hashes[None]),
                                torch.from_numpy(DIFFS[None]), n_sym, K, cfg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_sort_engine_equals_one_call(name):
    """parallel.encode_lanes_sharded(engine='sort') over two CPU devices
    (2 lanes and 1, their first 2 rows) gives one call's streams, the
    call through encode_lanes_pipelined(engine='sort'), and they are the
    oracle's."""
    cfg, jc = cfgs(name)
    lanes = LANES[:, :2]
    one = encode.encode_lanes_pipelined([lanes], cfg, device="cpu",
                                        engine="sort")[0]
    assert one == [oracle.encode(lane, jc)[6:] for lane in lanes]
    assert parallel.encode_lanes_sharded(lanes, ["cpu", "cpu"], cfg,
                                         engine="sort") == one


@pytest.mark.parametrize("wrapper", ["walk_symbols", "build_stream"])
def test_wrapper_checks_the_cfg_before_it_dispatches(wrapper, monkeypatch):
    """A cfg that config.check refuses (sign context 8 at 8 substates)
    raises through the wrapper itself, naming sign_ctx, before a tensor
    reaches the plain version (or, on the card, the cfg's build)."""
    def dispatched(*args, **kwargs):
        raise AssertionError("the wrapper dispatched an invalid cfg")

    monkeypatch.setattr(ek, f"{wrapper}_plain", dispatched)
    bad = CodecConfig(sign_ctx=8)
    x = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="sign_ctx"):
        if wrapper == "walk_symbols":
            ek.walk_symbols(x, 8, None, bad)
        else:
            ek.build_stream(x, x, 8, 8, bad)


def test_decision_key_widths():
    """The decision variant's contexts hash*substates + ctx stay below 2^20
    (``encode.POS_LIMIT``), where a context would read as padding: 126,815
    at 16 substates, which the forward sort keeps; a cfg past it raises
    naming substates, and the symbol variant (keyed on the hash, below
    ``encode._DEAD_HASH``) codes it.  Hashes of both models sort before
    the symbol padding."""
    sub16, _ = cfgs("substates 16")
    assert sub16.num_states - 1 == 126_815 < encode.POS_LIMIT
    h = torch.tensor([[sub16.num_hashes - 1]], dtype=torch.int32)
    d = torch.tensor([[-5]], dtype=torch.int32)  # sign decision: ctx 15
    stream = ek.build_stream_plain(h, d, 1, 8, sub16)
    skey, _ = encode.stage_fwd_sort(stream, 7)   # its 7 decisions
    assert skey.max().item() == 126_815
    assert max(CodecConfig().num_hashes,
               CodecConfig(large_model=False).num_hashes) <= encode._DEAD_HASH
    wide = CodecConfig(substates=133)
    assert wide.num_states > encode.POS_LIMIT
    with pytest.raises(ValueError, match="substates"):
        _sort(LANES[:1, :2], wide, variant="decision")
    jc = JaxConfig(substates=133)
    assert _sort(LANES[:1, :2], wide) == [oracle.encode(LANES[0, :2],
                                                        jc)[6:]]

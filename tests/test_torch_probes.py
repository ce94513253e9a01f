"""The GPU probes (``llcomp_tpu_torch.probes``) against the TPU probes in
``tools/``, on the CPU: the plain versions against the Pallas kernels in
interpret mode, on the same numpy inputs, exactly (int32).

The TPU probes zero only part of their model planes; interpret mode is
given ``uninitialized_memory="zero"`` (the port's planes start at zero) or
``"nan"`` (int32 max), and the port's plane is filled to match.  The plane
is cut to ``ROWS`` rows so that a lane meets a row again within a few
steps and the outputs differ across lanes.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import (P11_LANES, P11_TAGS, PAIR_DEPTHS, PAIR_SHIPPED,
                        PG_TAGS, PG_WORDS, PROBE_ROWS, PROBE_TAGS, REPLACED,
                        ROW_SHIPPED,
                        STAGE_DEPTHS, STAGE_SHIPPED, VARIANTS, p7_hazard_cases,
                        p9_hazard_idx, p11_cases, p11_inputs, pF_hazard_cases,
                        pG_cases, reduce_cases, sass_chain)
from llcomp_tpu_torch import probes
from llcomp_tpu_torch.kernels import build
from llcomp_tpu_torch.probes import mosaic, mosaic2, mosaic3, reduce

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
LANES = 128
ROWS = 41
T = 6
INT32_MAX = 2**31 - 1
MODULES = (mosaic, mosaic2, mosaic3, reduce)


@functools.lru_cache(maxsize=None)
def _tpu_probes(name: str, fill: str):
    """``tools/<name>.py`` loaded afresh; its ``pallas_call`` runs in
    interpret mode with uninitialised memory ``fill`` (the reduce probe
    chooses interpret mode itself)."""
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}_{fill}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if name != "probe_reduce":
        patched = types.SimpleNamespace(
            **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
        patched.pallas_call = functools.partial(
            pl.pallas_call,
            interpret=pltpu.InterpretParams(uninitialized_memory=fill))
        mod.pl = patched
    return mod


def _ints(rng, high, shape):
    return rng.integers(0, high, shape, dtype=np.int32)


def _planes(fill, planes=0):
    """The port's plane as the TPU probe left it: zeros, or int32 max
    outside the rows 0:8 that the probe zeroes."""
    shape = (planes, ROWS, LANES) if planes else (ROWS, LANES)
    if fill == "zero":
        return {"model": torch.zeros(shape, dtype=torch.int32)}
    m = torch.full(shape, INT32_MAX, dtype=torch.int32)
    m[..., :8, :] = 0
    return {"model": m}


def _idx_src(rng, lo_rows=1, high=ROWS):
    return [_ints(rng, high, (lo_rows, LANES)),
            _ints(rng, 1 << 20, (ROWS, LANES))]


# case: (tools module, uninitialised memory, the TPU probe's fn from the
# loaded module, the port's function, inputs from a generator, the port's
# keyword arguments)
CASES = {
    "p0": ("probe_mosaic", "zero", lambda m: m.p0_scalar_store()[0],
           mosaic.p0_scalar_store, lambda r: [_ints(r, 1000, (8, LANES))],
           lambda: {}),
    "p1": ("probe_mosaic", "zero", lambda m: m.p1_scalar_load()[0],
           mosaic.p1_scalar_load, lambda r: _idx_src(r, 8), lambda: {}),
    "p2": ("probe_mosaic", "zero", lambda m: m.p2_row_load_blend()[0],
           mosaic.p2_row_load_blend, lambda r: _idx_src(r, 8), lambda: {}),
    "p3": ("probe_mosaic", "zero", lambda m: m.p3_row_rmw()[0],
           mosaic.p3_row_rmw,
           lambda r: [_ints(r, 1000, (8, LANES)),
                      _ints(r, 1 << 20, (1, LANES))],
           lambda: _planes("zero")),
    "p4": ("probe_mosaic", "zero", lambda m: m.p4_window_load()[0],
           mosaic.p4_window_load, lambda r: _idx_src(r, 8), lambda: {}),
    "p5": ("probe_mosaic", "zero", lambda m: m.p5_sublane_gather32()[0],
           mosaic.p5_sublane_gather32,
           lambda r: _idx_src(r, 8, 1000), lambda: {}),
    "p6": ("probe_mosaic", "zero", lambda m: m.p6_smem_staging()[0],
           mosaic.p6_smem_staging, lambda r: [_ints(r, 1000, (8, LANES))],
           lambda: {}),
    "p7": ("probe_mosaic", "zero",
           lambda m: m.p7_symbol_step_cost(T=T)[0],
           functools.partial(mosaic.p7_symbol_step_cost, T=T),
           lambda r: [_ints(r, ROWS - 2, (8, LANES))],
           lambda: _planes("zero", 2)),
    "p7 nan": ("probe_mosaic", "nan",
               lambda m: m.p7_symbol_step_cost(T=T)[0],
               functools.partial(mosaic.p7_symbol_step_cost, T=T),
               lambda r: [_ints(r, ROWS - 2, (8, LANES))],
               lambda: _planes("nan", 2)),
    "p8": ("probe_mosaic", "zero", lambda m: m.p8_stage_only_cost(T=T)[0],
           functools.partial(mosaic.p8_stage_only_cost, T=T),
           lambda r: [_ints(r, ROWS - 2, (8, LANES))],
           lambda: _planes("zero")),
    "p8 nan": ("probe_mosaic", "nan",
               lambda m: m.p8_stage_only_cost(T=T)[0],
               functools.partial(mosaic.p8_stage_only_cost, T=T),
               lambda r: [_ints(r, ROWS - 2, (8, LANES))],
               lambda: _planes("nan")),
    "p9": ("probe_mosaic", "zero",
           lambda m: m.p9_decision_only_cost(T=T)[0],
           functools.partial(mosaic.p9_decision_only_cost, T=T),
           lambda r: [_ints(r, 1000, (8, LANES))], lambda: {}),
    "p9 byte edges": ("probe_mosaic", "zero",
                      lambda m: m.p9_decision_only_cost(T=T)[0],
                      functools.partial(mosaic.p9_decision_only_cost, T=T),
                      lambda r: [p9_hazard_idx(LANES)], lambda: {}),
    "p10": ("probe_mosaic", "zero",
            lambda m: m.p10_decision_unrolled(T=T)[0],
            functools.partial(mosaic.p10_decision_unrolled, T=T),
            lambda r: [_ints(r, 1000, (8, LANES))], lambda: {}),
    "p11 nan": ("probe_mosaic", "nan", lambda m: m.p11_stage_few(T=T)[0],
                functools.partial(mosaic.p11_stage_few, T=T),
                lambda r: [_ints(r, ROWS - 2, (8, LANES))],
                lambda: _planes("nan")),
    "pA": ("probe_mosaic2", "zero", lambda m: m.pA_dma_bridge()[0],
           mosaic2.pA_dma_bridge, lambda r: [_ints(r, 1000, (1, LANES))],
           lambda: {}),
    "pB": ("probe_mosaic2", "zero", lambda m: m.pB_dyn_row_load()[0],
           mosaic2.pB_dyn_row_load, lambda r: _idx_src(r), lambda: {}),
    "pC": ("probe_mosaic2", "zero", lambda m: m.pC_dyn_row_rmw()[0],
           mosaic2.pC_dyn_row_rmw,
           lambda r: [_ints(r, 1000, (1, LANES)),
                      _ints(r, 1 << 20, (1, LANES))],
           lambda: _planes("zero")),
    "pD8": ("probe_mosaic2", "zero", lambda m: m.pD_window_load(8)[0],
            functools.partial(mosaic2.pD_window_load, win=8),
            lambda r: _idx_src(r), lambda: {}),
    "pD16": ("probe_mosaic2", "zero", lambda m: m.pD_window_load(16)[0],
             functools.partial(mosaic2.pD_window_load, win=16),
             lambda r: _idx_src(r), lambda: {}),
    "pE16": ("probe_mosaic2", "zero", lambda m: m.pE_taa(16)[0],
             functools.partial(mosaic2.pE_taa, rows=16),
             lambda r: _idx_src(r, 1, 1000), lambda: {}),
    "pE32": ("probe_mosaic2", "zero", lambda m: m.pE_taa(32)[0],
             functools.partial(mosaic2.pE_taa, rows=32),
             lambda r: _idx_src(r, 1, 1000), lambda: {}),
    "pF": ("probe_mosaic2", "zero", lambda m: m.pF_symbol_step(T=T)[0],
           functools.partial(mosaic2.pF_symbol_step, T=T),
           lambda r: [_ints(r, ROWS - 16, (1, LANES))],
           lambda: _planes("zero")),
    "pF nan": ("probe_mosaic2", "nan", lambda m: m.pF_symbol_step(T=T)[0],
               functools.partial(mosaic2.pF_symbol_step, T=T),
               lambda r: [_ints(r, ROWS - 16, (1, LANES))],
               lambda: _planes("nan")),
    "pG low": ("probe_mosaic3", "zero", lambda m: m.pG_scalar_gate()()[0],
               mosaic3.pG_scalar_gate, lambda r: [_ints(r, 101, (8, LANES))],
               lambda: {}),
    "pG high": ("probe_mosaic3", "zero", lambda m: m.pG_scalar_gate()()[0],
                mosaic3.pG_scalar_gate,
                lambda r: [_ints(r, 200, (8, LANES))], lambda: {}),
    "pH window": ("probe_mosaic3", "zero",
                  lambda m: m.pH_stage(T=T, window=True)()[0],
                  functools.partial(mosaic3.pH_stage, T=T, window=True),
                  lambda r: [_ints(r, ROWS - 16, (64, LANES)),
                             _ints(r, 1 << 20, (1024, LANES))],
                  lambda: _planes("zero")),
    "pH no window": ("probe_mosaic3", "zero",
                     lambda m: m.pH_stage(T=T, window=False)()[0],
                     functools.partial(mosaic3.pH_stage, T=T, window=False),
                     lambda r: [_ints(r, ROWS - 16, (64, LANES)),
                                _ints(r, 1 << 20, (1024, LANES))],
                     lambda: _planes("zero")),
    "reduce": ("probe_reduce", "zero", lambda m: m.run, reduce.run,
               lambda r: [_ints(r, 4, (64, LANES))], lambda: {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_tpu_probe(case, monkeypatch):
    source, fill, tpu_fn, port_fn, make, kw = CASES[case]
    mod = _tpu_probes(source, fill)
    monkeypatch.setattr(mod, "ROWS", ROWS, raising=False)
    args = make(np.random.default_rng(zlib.crc32(case.encode())))
    want = np.asarray(jax.jit(tpu_fn(mod))(*map(jnp.asarray, args)))
    wrapper = getattr(port_fn, "func", port_fn)
    before = wrapper.launches
    got = port_fn(*map(torch.from_numpy, args), **kw())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert wrapper.launches == before   # the CPU ran the plain version
    if case.startswith("pH"):   # one scalar carry, broadcast to every lane
        assert want.any() == (case == "pH window")
    else:
        assert (want != want[:, :1]).any(), "the same output in every lane"


@pytest.mark.parametrize("case, rows", [("7110 lanes", 15872),
                                        ("8 rows", 8), ("13 rows", 13),
                                        ("17 rows", 17)])
def test_p7_plain_equals_tpu_probe_where_rows_repeat(case, rows,
                                                     monkeypatch):
    """p7 where the CUDA kernel's row ring meets a row it holds pending:
    the full 15,872-row plane with lanes whose every step lands on row
    7110 (x = 7110 and 7110 + 15,871), and planes of 8-17 rows, where rows
    repeat within any ring depth; 10 steps, idx over the whole
    non-negative int32 range (x*(s+1) wraps)."""
    mod = _tpu_probes("probe_mosaic", "zero")
    monkeypatch.setattr(mod, "ROWS", rows)
    idx = np.random.default_rng(rows).integers(0, 2**31, (8, LANES),
                                               dtype=np.int32)
    if rows == 15872:
        idx[0, ::3], idx[0, 1::3] = 7110, 7110 + 15871
    want = np.asarray(jax.jit(mod.p7_symbol_step_cost(T=10)[0])(
        jnp.asarray(idx)))
    got = mosaic.p7_symbol_step_cost(
        torch.from_numpy(idx), 10,
        torch.zeros((2, rows, LANES), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != want[:, :1]).any(), "the same output in every lane"


def _rows_clipped(rows: int):
    """``jnp`` for a TPU probe on a plane of ``rows`` rows: the probes zero
    the plane's rows 0:8 with ``jnp.zeros((8, lanes))``, which on a plane
    of fewer rows becomes a zeroing of the whole plane (interpret mode's
    memory starts at zero either way)."""
    def zeros(shape, *a, **kw):
        if shape[0] == 8:
            shape = (min(8, rows), *shape[1:])
        return jnp.zeros(shape, *a, **kw)
    return types.SimpleNamespace(**{**vars(jnp), "zeros": zeros})


PF_CASES = {name: (idx, rows) for name, idx, rows, _ in pF_hazard_cases()
            if not name.startswith("T ")}


@pytest.mark.parametrize("case", list(PF_CASES))
def test_pF_plain_equals_tpu_probe_where_rows_repeat(case, monkeypatch):
    """pF where the CUDA kernel's pair ring meets a pair it holds pending
    (``chip_smoke.pF_hazard_cases``, their idx over the whole non-negative
    int32 range): the full 15,872-row plane with the lanes whose every
    step lands on pair 14,214, and planes of 4, 6 and 36 rows, where pairs
    repeat within any ring depth; 10 steps.  On 4 rows (m = 1) every lane
    steps pair 0 from the zeroed plane, so every lane gives the same
    output, and it is not the start's."""
    idx, rows = PF_CASES[case]
    mod = _tpu_probes("probe_mosaic2", "zero")
    monkeypatch.setattr(mod, "ROWS", rows)
    monkeypatch.setattr(mod, "jnp", _rows_clipped(rows))
    want = np.asarray(jax.jit(mod.pF_symbol_step(T=10)[0])(jnp.asarray(idx)))
    got = mosaic2.pF_symbol_step(
        torch.from_numpy(idx), 10,
        torch.zeros((rows, LANES), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    if rows == 4:
        assert (want == want[0, 0]).all() and want[0, 0] != 0
    else:
        assert (want != want[:, :1]).any(), "the same output in every lane"


@pytest.mark.parametrize("case, rows", [("7110 lanes", 15872),
                                        ("8 rows", 8), ("13 rows", 13),
                                        ("17 rows", 17)])
def test_p8_plain_equals_tpu_probe_where_rows_repeat(case, rows,
                                                     monkeypatch):
    """p8 where the CUDA kernel's row ring meets a row it holds pending:
    the full 15,872-row plane with the lanes whose every step lands on row
    7110, and planes of 8-17 rows, where rows repeat within any ring
    depth; 10 steps, idx over the whole non-negative int32 range."""
    mod = _tpu_probes("probe_mosaic", "zero")
    monkeypatch.setattr(mod, "ROWS", rows)
    idx = np.random.default_rng(rows).integers(0, 2**31, (8, LANES),
                                               dtype=np.int32)
    if rows == 15872:
        idx[0, ::3], idx[0, 1::3] = 7110, 7110 + 15871
    want = np.asarray(jax.jit(mod.p8_stage_only_cost(T=10)[0])(
        jnp.asarray(idx)))
    got = mosaic.p8_stage_only_cost(
        torch.from_numpy(idx), 10,
        torch.zeros((rows, LANES), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != want[:, :1]).any(), "the same output in every lane"


def test_p7_hazard_cases_hold_every_hazard():
    """``chip_smoke.p7_hazard_cases``, which the card's checks run: on the
    full plane the 7110 lanes stay on row 7110 for all their steps, the
    small planes repeat a row within 2 steps, and T runs around every
    ring depth."""
    cases = {name: (idx, rows, T) for name, idx, rows, T in p7_hazard_cases()}
    idx, rows, T = cases["7110 lanes"]
    x = torch.from_numpy(idx[0, :2]).long()
    assert rows == probes.ROWS and T > 8
    for s in range(T):
        assert probes.step_row(x, s, rows - 1).tolist() == [7110, 7110]
    for rows in (2, 3, 17):
        _, got_rows, T = cases[f"{rows} rows"]
        assert got_rows == rows and T > 8
    assert {name for name in cases if name.startswith("T ")} >= {
        f"T {d + e}" for d in (2, 4, 8) for e in (-1, 0, 1)} | {"T 0"}


def test_p8_hazard_cases_reach_every_stage_depth():
    """p8 takes p7's cases at its own ring depths: T around each of
    ``STAGE_DEPTHS`` (16 and 32 past p7's), the row cases p7's own."""
    cases = {name: (idx, rows, T)
             for name, idx, rows, T in p7_hazard_cases(STAGE_DEPTHS)}
    assert {name for name in cases if name.startswith("T ")} >= {
        f"T {d + e}" for d in STAGE_DEPTHS for e in (-1, 0, 1)} | {"T 0"}
    for name, idx, rows, T in p7_hazard_cases():
        got = cases[name]
        assert got[1:] == (rows, T) and np.array_equal(got[0], idx)


def test_pF_hazard_cases_hold_every_hazard():
    """``chip_smoke.pF_hazard_cases``, which the card's checks run: on the
    full plane the 7107 lanes stay on pair 14,214 for all their steps, the
    planes of 4 and 6 rows repeat a pair within 2 steps in every lane (36
    rows, m = 17, now and then), T runs around every ring depth, and idx
    reaches past 2^30, so that x*(s+1) wraps."""
    cases = {name: (idx, rows, T) for name, idx, rows, T in pF_hazard_cases()}
    idx, rows, T = cases["7107 lanes"]
    x = torch.from_numpy(idx[0, :2]).long()
    assert rows == probes.ROWS and T > 8
    for s in range(T):
        assert (2 * probes.step_row(x, s, rows // 2 - 1)).tolist() == [
            14214, 14214]
    for rows in (4, 6, 36):
        idx, got_rows, T = cases[f"{rows} rows"]
        assert got_rows == rows and T > 8
        x = torch.from_numpy(idx[0]).long()
        h = torch.stack([probes.step_row(x, s, rows // 2 - 1)
                         for s in range(T)])
        again = torch.stack([(h[s:s + 2] == h[s + 2]).any(0)
                             for s in range(T - 2)])
        assert again.all() if rows < 36 else again.any()
    assert {name for name in cases if name.startswith("T ")} >= {
        f"T {d + e}" for d in PAIR_DEPTHS for e in (-1, 0, 1)} | {"T 0"}
    assert max(int(idx.max()) for idx, _, _ in cases.values()) > 2**30


@pytest.mark.parametrize("key", [k for k in VARIANTS
                                 if k[0] in ("probe_mosaic", "probe_mosaic2")])
def test_probe_copies_apply_to_the_shipped_sources(key):
    """Every copy of the probe sources that the card builds
    (``chip_smoke.VARIANTS``): each edit's text found exactly once in the
    shipped source, or a whole source in ``tools/designs/`` that includes
    the serial decision; the shipped ring depths are ``chip_smoke``'s."""
    edits = VARIANTS[key]
    if isinstance(edits, pathlib.Path):
        assert "#include \"probe_serial_decide.cuh\"" in edits.read_text()
        return
    src = (build.CSRC / f"{key[0]}.cu").read_text()
    for old, new in edits if isinstance(edits, list) else [edits]:
        assert src.count(old) == 1 and old != new
    assert (build.constant("probe_mosaic", "kRowDepth"),
            build.constant("probe_mosaic", "kStageDepth"),
            build.constant("probe_mosaic2", "kPairDepth")) == (
        ROW_SHIPPED, STAGE_SHIPPED, PAIR_SHIPPED)
    assert {tag for src, tag in VARIANTS if src == key[0]} >= {
        tag for k, tags in PROBE_TAGS.items() for tag in tags
        if k in (mosaic.PROBES if key[0] == "probe_mosaic"
                 else mosaic2.PROBES)}


def _rows_added(x: np.ndarray, m: int, T: int) -> np.ndarray:
    """p8's rows as ``tools/designs/probe_p8_row_step.cuh`` steps them
    (``StepRowsAdd``), in 32-bit arithmetic: [T, lanes]."""
    u, m32 = np.uint64, np.uint64(M32)
    s32 = x.astype(np.int64)
    v = s32.astype(np.uint64) & m32
    dv = (v + u(40503)) & m32
    dv_s = np.where(dv >= 2**31, dv.astype(np.int64) - 2**32, dv)
    r = (s32 % m).astype(np.uint64)
    dm = (dv_s % m).astype(np.uint64)
    c = u((2**32 - m) % m)
    neg = dv_s < 0
    fix = np.where(neg, c, (u(m) - c) % u(m))
    out = []
    for _ in range(T):
        out.append(r.copy())
        t = r + dm
        t = np.minimum(t, (t - u(m)) & m32)
        v2 = (v + dv) & m32
        wrapped = (v2.astype(np.int64) - (v2 >= 2**31) * 2**32
                   < v.astype(np.int64) - (v >= 2**31) * 2**32) != neg
        v = v2
        t = (t + np.where(wrapped, fix, u(0))) & m32
        r = np.minimum(t, (t - u(m)) & m32)
    return np.stack(out).astype(np.int64)


@pytest.mark.parametrize("m", [1, 2, 16, 7935, 15871, 2**31 - 1])
def test_p8_row_step_equals_step_row(m):
    """The rows of p8's copy "p8 row step" (stepped by additions, the
    32-bit wraps of the step value handled) equal ``step_row``'s floor
    modulo at every step, for idx over the whole int32 range (negative,
    near both ends, where x + 40503 wraps) and divisors up to 2^31 - 1."""
    rng = np.random.default_rng(m)
    x = rng.integers(-2**31, 2**31, 4096, dtype=np.int64)
    x[:6] = [-2**31, 2**31 - 1, -40503, 2**31 - 40503, 0, -1]
    got = _rows_added(x, m, 40)
    want = torch.stack([probes.step_row(torch.from_numpy(x), s, m)
                        for s in range(40)]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body, chain, ops", [
    # ctx = t & 7, a byte permute, t' = 5t + raw: three on the chain
    (["LOP3.LUT R3, R2, 0x7, RZ, 0xc0, !PT", "PRMT R5, R6, R3, R7",
      "LEA R9, R2, R2, 0x2", "IADD3 R2, R9, R5, R8",
      "IADD3 R10, R10, 0x1, RZ", "ISETP.NE.AND P0, PT, R10, 0x18, PT",
      "@P0 BRA `(.L_x_1)"], 3.0, ["LOP3", "PRMT", "IADD3"]),
    # a predicated write reads what it overwrites; a store writes nothing
    (["ISETP.GE.AND P1, PT, R2, 0x4, PT", "@P1 IADD3 R2, R2, 0x1, RZ",
      "STG.E [R4.64], R2", "BRA `(.L_x_2)"], 2.0, ["ISETP", "IADD3"]),
    # two chains a pass, each carried alone: the longer one counts
    (["IADD3 R1, R1, 0x1, RZ", "IMAD R2, R2, R2, RZ", "IMAD R2, R2, R2, RZ",
      "BRA `(.L_x_3)"], 2.0, ["IMAD", "IMAD"]),
])
def test_sass_chain_counts_the_carried_chain(body, chain, ops):
    """``chip_smoke.sass_chain`` on loop bodies written out: dependent
    instructions a pass on the carried chain, and that chain's opcodes."""
    assert sass_chain(body) == (chain, ops)


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_main_runs_every_probe_on_the_cpu(module, capsys):
    assert module.main(["--device", "cpu", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS ") == len(module.PROBES) and "FAIL" not in out
    assert out.splitlines()[0].startswith("device: cpu")


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_cuda_request_without_cuda_raises(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--device", "cuda"])
    probe = next(iter(module.PROBES.values()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probes.run_probe(probe, "cuda")


@pytest.mark.parametrize("window", [True, False])
def test_pH_stages_two_words_a_lane_a_step(window):
    """pH's plane is not in its output: each step adds 1 to two words of
    each lane's column, at an even row and the one after it."""
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(_ints(rng, ROWS - 16, (64, LANES)))
    data = torch.from_numpy(_ints(rng, 1 << 20, (1024, LANES)))
    model = torch.zeros((ROWS, LANES), dtype=torch.int32)
    mosaic3.pH_stage(idx, data, T, window, model)
    assert (model.sum(0) == 2 * T).all()
    assert torch.equal(model[0::2][: ROWS // 2], model[1::2])


def _wrap(x: int) -> int:
    """x as a wrapped int32."""
    return (x + 2**31) % 2**32 - 2**31


def _pH_scalar(idx, data, model, T, window):
    """pH as the probe defines it, one step and one lane at a time in
    Python ints, sums wrapping as int32: (out, the model plane after)."""
    model = model.copy()
    (k, lanes), m = idx.shape, model.shape[0] - 16
    carry = 0
    for s in range(T):
        total = 0
        for lane in range(lanes):
            r = (_wrap(int(idx[s % k, lane]) + carry) % m) & ~1
            for row in (r, r + 1):
                model[row, lane] = _wrap(int(model[row, lane]) + 1)
            if window:
                b = r % 992
                total += sum(int(data[b + i, lane]) for i in range(8))
        carry = _wrap(carry + total) % 1009
    return np.full((8, lanes), carry, np.int32), model


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("lanes", [1, 33, 127, 129, 1024])
def test_pH_plain_equals_a_scalar_loop(lanes, window):
    """``pH_stage_plain`` against ``_pH_scalar`` at lane counts around the
    CUDA kernel's partitions of the lanes over a cluster (1, a warp and
    one, a block of 128 and one either side, the most): planes of random
    words, data over the whole int32 range (wrapping sums), idx rows that
    wrap (3 rows, T 7) and idx near the int32 maximum (idx + carry
    wraps negative)."""
    rng = np.random.default_rng(lanes)
    idx = rng.integers(0, 2**31, (3, lanes), dtype=np.int32)
    idx[:, ::3] = 2**31 - 1 - rng.integers(0, 1009, (3, -(-lanes // 3)))
    data = rng.integers(-2**31, 2**31, (1000, lanes), dtype=np.int32)
    model = rng.integers(-2**31, 2**31, (ROWS, lanes), dtype=np.int32)
    want, want_model = _pH_scalar(idx, data, model, 7, window)
    got_model = torch.from_numpy(model.copy())
    got = mosaic3.pH_stage_plain(torch.from_numpy(idx),
                                 torch.from_numpy(data), 7, window, got_model)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_model.numpy(), want_model)
    assert not np.array_equal(want_model, model)


def test_bad_arguments_raise():
    idx = torch.zeros((1, LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        mosaic.p1_scalar_load(idx.long(), torch.zeros((8, LANES)))
    with pytest.raises(ValueError, match="lanes"):
        mosaic.p1_scalar_load(idx, torch.zeros((8, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="planes"):
        mosaic.p7_symbol_step_cost(idx, 1, torch.zeros(
            (1, 8, LANES), dtype=torch.int32))
    with pytest.raises(ValueError, match="1024 lanes"):
        mosaic3.pH_stage(torch.zeros((64, 2048), dtype=torch.int32),
                         torch.zeros((1024, 2048), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="idx needs a row"):
        mosaic3.pH_stage(torch.zeros((0, LANES), dtype=torch.int32),
                         torch.zeros((1024, LANES), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="at least 32 rows"):
        reduce.run(torch.zeros((16, LANES), dtype=torch.int32))
    with pytest.raises(ValueError, match="pG takes 1 to 32768 words"):
        mosaic3.pG_scalar_gate(torch.zeros((257, LANES), dtype=torch.int32))


def test_run_probe_on_the_cpu_times_nothing():
    """A CPU run reports its outputs and the host time of its one call,
    and no device time."""
    r = probes.run_probe(mosaic.PROBES["p9"], "cpu", T=3)
    assert r["T"] == 3 and r["out"].shape == (1, LANES)
    assert r["host_s"] >= 0
    assert r["ms"] is r["ns_step"] is r["err"] is r["plain_ms"] is None
    assert r["telling"] is None
    torch.testing.assert_close(
        r["out"], mosaic.p9_decision_only_cost(
            mosaic.PROBES["p9"].make(0, LANES, probes.ROWS, "cpu")["idx"],
            T=3),
        rtol=0, atol=0)


@pytest.mark.parametrize("key, fill, tells", [
    ("p11", "zero", False), ("p11", "words", True), ("pHn", "zero", True)])
def test_a_check_tells_only_on_a_plane_that_moves_it(key, fill, tells):
    """At the full plane height, p11 from a zero plane gives 0 in every
    lane and writes nothing, so a kernel check on it tells nothing; from
    random words (the planes ``run_probe`` gives a kernel check) it does.
    pHn's output is 0 in every lane, but its plane changes."""
    p = {**mosaic.PROBES, **mosaic3.PROBES}[key]
    a = p.make(0, LANES, probes.ROWS, "cpu")
    if fill == "words":
        a["model"] = probes.words(0, a["model"].shape, "cpu")
    before = {"model": a["model"].clone()}
    out = p.plain(**a, T=T)
    assert probes.telling(out, before, {"model": a["model"]}) is tells


M32 = 0xFFFFFFFF


def _prmt(a, b, sel):
    """PTX ``prmt.b32`` on uint64 arrays of 32-bit words: byte i of the
    result is byte ``n & 7`` of {b:a}, n nibble i of ``sel``, or that
    byte's sign in all 8 bits where n's bit 3 is set."""
    src = (b << np.uint64(32)) | a
    out = np.zeros_like(a)
    for i in range(4):
        n = (sel >> np.uint64(4 * i)) & np.uint64(0xF)
        byte = (src >> (np.uint64(8) * (n & np.uint64(7)))) & np.uint64(0xFF)
        sign = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        byte = np.where(n & np.uint64(8), sign, byte)
        out |= byte << np.uint64(8 * i)
    return out


def _rotl(x, sh):
    """32-bit rotate left of uint64 arrays by ``sh`` mod 32 (the funnel
    shift of a word with itself)."""
    sh = sh & np.uint64(31)
    return ((x << sh) | (x >> ((np.uint64(32) - sh) & np.uint64(63)))) \
        & np.uint64(M32)


def _put_byte_sel(m):
    return (m & np.uint64(0x7654)) ^ np.uint64(0x3210)


def _decide24_perm(lo, hi, ctx, t):
    """``decide24_perm<true>`` of ``csrc/probe_common.cuh`` (p10's step) on
    uint64 arrays of 32-bit words, instruction for instruction: every sum
    and product wraps in 32 bits, the rotate takes its amount mod 32."""
    m32, u = np.uint64(M32), np.uint64
    for d in range(24):
        k = u((2 - 4 * d) & M32)
        raw = _prmt(lo, hi, ctx)
        sh = (ctx << u(2)) & m32
        ahead = (ctx * u(5) + k) & m32
        nxt = (raw + u(1)) & m32
        sel_lo = _put_byte_sel(_rotl(u(0xF), sh))
        sel_hi = _put_byte_sel(_rotl(u(0xF0000), sh))
        lo, hi = _prmt(lo, nxt, sel_lo), _prmt(hi, nxt, sel_hi)
        ctx = (raw + ahead) & m32 & u(7)
        t = (t * u(5) + (raw & u(0xFF)) + k) & m32
    return lo, hi, ctx, (t - u(24)) & m32


def _p10_perm(idx: np.ndarray, T: int) -> np.ndarray:
    """p10's kernel (``decisions_perm<true>``) on idx [1, lanes] int32, in
    32-bit arithmetic: out [1, lanes]."""
    lo = (idx[0].astype(np.uint64) & np.uint64(0xFF)) * np.uint64(0x01010101)
    hi, ctx, t = lo.copy(), np.zeros_like(lo), np.zeros_like(lo)
    for _ in range(T):
        lo, hi, ctx, t = _decide24_perm(lo, hi, ctx, t)
    return (t & np.uint64(0x7FFF)).astype(np.int32)[None]


def test_p10_step_equals_decide24_plain_on_random_rows():
    """One step of p10's decision (``decide24_perm<true>``) on random rows
    of 8 bytes (0xFF among them) and random acc: its row, its acc masked
    and its ctx (acc mod 8) equal ``decide24_plain``'s."""
    rng = np.random.default_rng(24)
    b = rng.integers(0, 256, (8, 4096))
    b[:, ::7] = 0xFF
    acc = rng.integers(0, 0x8000, 4096)
    want_b, want_acc = mosaic.decide24_plain(torch.from_numpy(b),
                                             torch.from_numpy(acc))
    lo, hi = probes.row_words(torch.from_numpy(b))
    u = (lo.numpy().astype(np.int64) & M32).astype(np.uint64)
    v = (hi.numpy().astype(np.int64) & M32).astype(np.uint64)
    a = acc.astype(np.uint64)
    lo, hi, ctx, t = _decide24_perm(u, v, a & np.uint64(7), a)
    got_b = probes.row_bytes(torch.from_numpy(lo.astype(np.int64)),
                             torch.from_numpy(hi.astype(np.int64)))
    assert torch.equal(got_b, want_b)
    np.testing.assert_array_equal(t & np.uint64(0x7FFF), want_acc.numpy())
    np.testing.assert_array_equal(ctx, want_acc.numpy() & 7)


@pytest.mark.parametrize("T", [0, 1, 2, 64])
def test_p10_step_equals_tpu_probe_at_the_byte_edges(T):
    """p10's kernel modelled in 32-bit arithmetic (``_p10_perm``) on
    ``chip_smoke.p9_hazard_idx`` (bytes 0xFF and 0x00, idx past 255)
    against the JAX ``p10_decision_unrolled`` in interpret mode and the
    plain version."""
    idx = p9_hazard_idx(LANES)
    mod = _tpu_probes("probe_mosaic", "zero")
    want = np.asarray(jax.jit(mod.p10_decision_unrolled(T=T)[0])(
        jnp.asarray(np.repeat(idx, 8, 0))))
    got = _p10_perm(idx, T)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mosaic.p10_decision_unrolled(torch.from_numpy(idx), T).numpy(), want)
    assert T == 0 or (want != want[:, :1]).any()


def _reduce_skip(x: np.ndarray):
    """The reduce probe with its kernel's skip rule: the maximum taken only
    where 4 or more slices have passed since the last flush.  -> (out
    [16, lanes] int32, the slices that flushed, the maxima taken)."""
    lanes = x.shape[1]
    fill = np.zeros((8, lanes), np.int64)
    flushed, acc = fill.copy(), fill.copy()
    since, flushes, maxima = 0, [], 0
    for c in range(x.shape[0] // 32):
        acc = np.zeros_like(fill)
        for j in range(4):
            v = x[c * 32 + j * 8: c * 32 + j * 8 + 8].astype(np.int64)
            fill += v & 1
            acc += v
            since += 1
            if since < 4:
                continue
            maxima += 1
            if fill.max() > 3:
                flushed += fill
                fill[:] = 0
                since = 0
                flushes.append(4 * c + j)
    out = np.concatenate([flushed, acc])
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32), flushes, maxima


REDUCE_CASES = dict(reduce_cases())


@pytest.mark.parametrize("case", list(REDUCE_CASES))
def test_reduce_skip_rule_equals_plain_and_tpu_probe(case, monkeypatch):
    """The skip rule (``_reduce_skip``) against ``run_plain`` and the JAX
    probe (``tools/probe_reduce.py`` ``run``, interpret mode, its lanes
    set to the case's) on ``chip_smoke.reduce_cases``."""
    x = REDUCE_CASES[case]
    mod = _tpu_probes("probe_reduce", "zero")
    monkeypatch.setattr(mod, "LANES", x.shape[1])
    want = np.asarray(mod.run(jnp.asarray(x)))
    got, _, _ = _reduce_skip(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reduce.run(torch.from_numpy(x)).numpy(),
                                  want)


def _gaps(flushes):
    return np.diff([-1, *flushes]).tolist()


def test_reduce_cases_flush_at_every_gap():
    """``reduce_cases`` make flushes at gaps of exactly 4 slices (the first
    at slice 3), at gaps of 5 and more, and no flush at all; at the probe's
    own shape (64 x 128, words 0-3) the skip rule takes 2 maxima where
    every slice would take 8."""
    gaps, never = set(), 0
    for name, x in reduce_cases():
        _, flushes, _ = _reduce_skip(x)
        gaps.update(_gaps(flushes))
        never += not flushes
        if name.startswith(("odd", "one odd")):
            assert _gaps(flushes) == [4] * (x.shape[0] // 32)
        if name.startswith("even"):
            assert not flushes
    assert 4 in gaps and max(gaps) >= 5 and never
    x = reduce.PROBES["reduce"].make(0, LANES, probes.ROWS, "cpu")["x"]
    _, flushes, maxima = _reduce_skip(x.numpy())
    assert (x.shape, flushes, maxima) == ((64, LANES), [3, 7], 2)


@pytest.mark.parametrize("nstage", [-1, 0, 1, 9])
def test_p11_stages_no_lane_at_or_below_zero(nstage, monkeypatch):
    """p11 at nstage -1, 0, 1 and 9 against the JAX ``p11_stage_few`` in
    interpret mode (its ``fori_loop(0, NSTAGE)`` stages no lane where
    NSTAGE <= 0): exactly equal, zeros in every lane where nstage <= 0."""
    mod = _tpu_probes("probe_mosaic", "nan")
    monkeypatch.setattr(mod, "ROWS", ROWS)
    idx = _ints(np.random.default_rng(11 + nstage), ROWS - 2, (8, LANES))
    want = np.asarray(jax.jit(mod.p11_stage_few(T=T, NSTAGE=nstage)[0])(
        jnp.asarray(idx)))
    got = mosaic.p11_stage_few(torch.from_numpy(idx), T, nstage,
                               **_planes("nan"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, max(nstage, 0):].any()
    assert (want != 0).any() == (nstage > 0)


@pytest.mark.parametrize("steps", [0, 1, 33])
def test_p11_plain_equals_tpu_probe_at_few_steps(steps, monkeypatch):
    """p11 at T 0, 1 and 33 (a warp's threads with no step, one, and a
    second pass in the CUDA kernel) against the JAX probe in interpret
    mode, exactly."""
    mod = _tpu_probes("probe_mosaic", "nan")
    monkeypatch.setattr(mod, "ROWS", ROWS)
    idx = _ints(np.random.default_rng(steps), ROWS - 2, (8, LANES))
    want = np.asarray(jax.jit(mod.p11_stage_few(T=steps)[0])(
        jnp.asarray(idx)))
    got = mosaic.p11_stage_few(torch.from_numpy(idx), steps,
                               **_planes("nan"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :8] != 0).any() == (steps > 0)


def _gate_input(case: str) -> np.ndarray:
    """pG's (8, 128) input at an edge: words below 100 and one of exactly
    100 or 101, or INT32_MAX (+1 wraps) or INT32_MIN with the maximum
    below 100 (-1 wraps)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x = rng.integers(-1000, 100, (8, LANES), dtype=np.int64)
    x[rng.integers(0, 8), rng.integers(0, LANES)] = {
        "max 100": 100, "max 101": 101, "INT32_MAX + 1": INT32_MAX,
        "INT32_MIN - 1": -2**31}[case]
    return x.astype(np.int32)


@pytest.mark.parametrize("case", ["max 100", "max 101", "INT32_MAX + 1",
                                  "INT32_MIN - 1"])
def test_pG_plain_equals_tpu_probe_at_the_edges(case):
    """pG where its branch turns (a maximum of exactly 100 and 101) and
    where x +- 1 wraps, against the JAX probe in interpret mode."""
    mod = _tpu_probes("probe_mosaic3", "zero")
    x = _gate_input(case)
    want = np.asarray(jax.jit(mod.pG_scalar_gate()()[0])(jnp.asarray(x)))
    got = mosaic3.pG_scalar_gate(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    d = 1 if case in ("max 101", "INT32_MAX + 1") else -1
    np.testing.assert_array_equal(
        want, ((x.astype(np.int64) + d + 2**31) % 2**32 - 2**31))


def _floor_mod(u: np.ndarray, m: int, magic: tuple) -> np.ndarray:
    """``FloorMod::of`` of ``csrc/probe_mosaic.cu`` on uint64 arrays of
    32-bit words u = v + 2^31, instruction for instruction, every sum
    and product wrapping in 32 bits."""
    mul, sh1, sh2, mc = (np.uint64(c) for c in magic)
    m32, m = np.uint64(M32), np.uint64(m)
    hi = (u * mul) >> np.uint64(32)
    q = ((hi + (((u - hi) & m32) >> sh1)) & m32) >> sh2
    r = (u - q * m + mc) & m32
    return np.minimum(r, (r - m) & m32).astype(np.int64)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7, 8, 9, 299, 2**15 - 1,
                               2**15 + 1, 2**16, probes.ROWS - 1, 2**30 - 1,
                               2**30 + 1, 2**31 - 1])
def test_floor_mod_magic_is_exact(m):
    """p11's row without a division (``floor_mod_magic`` and the kernel's
    ``FloorMod``) equals the floor modulo for v at both ends of int32,
    around 0 and around every multiple of m near them, and on random
    words: m of 1, 2, 3, powers of 2 and their neighbours, the probe's
    rows - 1 and 2^31 - 1."""
    ks = np.arange(-3, 4, dtype=np.int64)
    near = np.concatenate([k * m + ks for k in (
        0, 1, -1, (2**31 - 1) // m, -(2**31 // m), (2**31 - 1) // m - 1)])
    v = np.concatenate([
        near, [-2**31, -2**31 + 1, 2**31 - 2, 2**31 - 1, 0, -1, 1],
        np.random.default_rng(m).integers(-2**31, 2**31, 200_000)])
    v = v[(v >= -2**31) & (v < 2**31)]
    u = ((v + 2**31) % 2**32).astype(np.uint64)
    got = _floor_mod(u, m, probes.floor_mod_magic(m))
    np.testing.assert_array_equal(got, v % m)
    assert all(0 <= c < 2**32 for c in probes.floor_mod_magic(m))


def _p11_warps(idx: np.ndarray, plane: np.ndarray, T: int,
               nstage: int) -> np.ndarray:
    """p11's kernel (``stage_few``) in 32-bit arithmetic: staged lane l's
    warp, thread t stepping u = x + t*(x + 40503) + 2^31 by 32*(x +
    40503) through batches of ``kFewBatch`` predicated loads, the warp's
    wrapped sum masked; 0 in the other lanes.  -> out [1, lanes]."""
    lanes, (batch, warp) = idx.shape[1], (16, 32)
    magic = probes.floor_mod_magic(plane.shape[0] - 1)
    staged = max(0, min(nstage, lanes))
    x = idx[0, :staged].astype(np.int64) % 2**32
    dv = (x + 40503) % 2**32
    words = plane[:, :staged].astype(np.int64) % 2**32
    total = np.zeros(staged, np.int64)
    for t in range(warp):
        u = ((x + t * dv + 2**31) % 2**32).astype(np.uint64)
        for s0 in range(t, T, warp * batch):
            for j in range(batch):
                r = _floor_mod(u, plane.shape[0] - 1, magic)
                if s0 + j * warp < T:
                    total += words[r, np.arange(staged)]
                u = (u + np.uint64(warp) * dv.astype(np.uint64)) \
                    & np.uint64(M32)
    out = np.zeros(lanes, np.int32)
    out[:staged] = total % 2**32 & 0x7FFF
    return out[None]


P11_CASES = {name: case for name, *case in p11_cases()}


@pytest.mark.parametrize("case", [name for name, lanes, *_ in p11_cases()
                                  if lanes < 1024])
def test_p11_warp_sum_equals_plain(case):
    """p11's warp design modelled in 32-bit arithmetic (``_p11_warps``)
    against ``p11_stage_few_plain`` on ``chip_smoke.p11_cases`` (the card's
    checks; 1,024 lanes left to the card): the carry's sum split over a
    warp's threads equals the serial carry, every row of the division-free
    floor modulo equal to ``step_row``'s."""
    lanes, rows, steps, nstage = P11_CASES[case]
    idx, plane = p11_inputs(case, lanes, rows)
    want = mosaic.p11_stage_few_plain(torch.from_numpy(idx), steps, nstage,
                                      torch.from_numpy(plane.copy()))
    np.testing.assert_array_equal(_p11_warps(idx, plane, steps, nstage),
                                  want.numpy())
    assert want.any() == (nstage > 0 and steps > 0)


def test_p11_cases_reach_every_edge():
    """``chip_smoke.p11_cases`` stage no lane (nstage -1 and 0), a ragged
    block of warps (9, 33) and past the lanes; T 0, 1 and around a warp's
    32 steps and 512; planes of 2, 3 and 300 rows; at 100, 128 and 1,024
    lanes."""
    cases = p11_cases()
    got = {key: {c[i] for c in cases} for key, i in
           (("lanes", 1), ("rows", 2), ("T", 3), ("nstage", 4))}
    assert got["lanes"] == set(P11_LANES) == {100, 128, 1024}
    assert got["rows"] == {2, 3, 300}
    assert got["T"] >= {0, 1, 31, 32, 33, 512}
    assert got["nstage"] >= {-1, 0, 1, 8, 9, 33}
    assert all(any(n > lanes for _, lanes, _, _, n in cases
                   if lanes == want) for want in P11_LANES)


def _gate_parts(n: int, offset: int) -> tuple:
    """pG's entry point where x and out both start ``offset`` words past a
    16-byte boundary (the wrapper allocates out so): (head words, int4
    words, tail words)."""
    head = min((4 - offset) % 4, n)
    nv = (n - head) // 4
    return head, nv, n - head - 4 * nv


def test_pG_cases_reach_every_edge():
    """``chip_smoke.pG_cases``, which the card's checks run, put the
    maximum in the head words, in the int4 words and in the tail words of
    the kernel's split, at every size; their maxima are exactly 100 and
    101, and INT32_MAX and INT32_MIN wrap."""
    where, sizes = set(), set()
    for name, x, off in pG_cases():
        n = x.size
        sizes.add(n)
        flat = x.ravel().astype(np.int64)
        head, nv, tail = _gate_parts(n, off)
        if name.startswith("max last") or name.startswith("max first"):
            at = int(flat.argmax())
            where.add("head" if at < head else "tail" if at >= head + 4 * nv
                      else "int4")
        if name.startswith("max 10"):
            assert flat.max() == int(name[4:7])
        if name.startswith("INT32"):
            assert flat[0] == flat[-1] == (
                INT32_MAX if "MAX" in name else -2**31)
            assert (flat.max() > 100) == ("MAX" in name)
    assert where == {"head", "int4", "tail"}
    assert sizes == set(PG_WORDS) == {1, 3, 1024, 1027, 8192}


@pytest.mark.parametrize("tag", PG_TAGS)
def test_pG_copies_apply_to_the_shipped_source(tag):
    """pG's copies (``chip_smoke.VARIANTS``): the design it replaced whole
    in ``tools/designs/`` (one word a thread, ``block_max``), and the copy
    at 8 warps an edit found once in the shipped source."""
    edits = VARIANTS["probe_mosaic3", tag]
    if isinstance(edits, pathlib.Path):
        text = edits.read_text()
        assert "block_max(m, red)" in text and "llct_probe_pG" in text
        return
    old, new = edits
    assert (build.CSRC / "probe_mosaic3.cu").read_text().count(old) == 1
    assert old != new


def test_p11_copies_launch_their_designs():
    """p11's copies launch the kernels their ``tools/designs/`` headers
    define, in place of the shipped launch, or the shipped kernel at 8
    warps a block."""
    for tag, kernel in (("p11 serial", "stage_few_serial"),
                        ("p11 ring", "stage_few_ring")):
        (_, include), (_, launch) = VARIANTS["probe_mosaic", tag]
        design = include.split('"')[1]
        assert f"\n{kernel}(" in (TOOLS / "designs" / design).read_text()
        assert launch.startswith(f"  {kernel}<<<")
    old, new = VARIANTS["probe_mosaic", "p11 8 warps"]
    assert build.constant("probe_mosaic", "kFewWarps") == 1
    assert new == old.replace("= 1;", "= 8;")
    assert set(P11_TAGS) == {"p11 serial", "p11 ring", "p11 8 warps"}


def test_replaced_designs_are_kept_as_copies():
    """``chip_smoke.REPLACED``: the designs that p11 and pG replaced are
    rows of the kernels line, copies that phase 8 times beside them, and
    sources kept in ``tools/designs/``."""
    assert set(REPLACED) == {"p11", "pG"} <= set(PROBE_ROWS)
    for row, (tag, path) in REPLACED.items():
        assert tag in (P11_TAGS if row == "p11" else PG_TAGS)
        assert (TOOLS.parent / path).is_file()
        edits = VARIANTS[("probe_mosaic" if row == "p11" else "probe_mosaic3"),
                         tag]
        assert path.endswith(edits.name if isinstance(edits, pathlib.Path)
                             else edits[0][1].split('"')[1])

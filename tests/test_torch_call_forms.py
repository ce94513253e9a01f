"""The JAX package's call forms on the port: a call written for
``llcomp_tpu`` runs unchanged on ``llcomp_tpu_torch`` with ``device=``
added as a keyword, and gives the JAX package's bytes and pixels.

* Signatures: every public function of a ``llcomp_tpu`` module whose
  counterpart in the port has the same path (and the root
  ``__graft_entry__.py`` beside ``graft_entry.py``) begins with the JAX
  function's parameters, in order, under the same names, of the same kind
  and with the same defaults; the port's own parameters follow, keyword-only.
  The one difference allowed is ``backend``'s default, 'torch' where the JAX
  package says 'auto' or 'jax', so that an entry point runs on the card
  unless asked for the CPU.  The JAX signatures are read with ``ast``, so no
  JAX is imported for them.  ``pallas/`` has no counterpart by path: the
  port's kernel wrappers (``kernels/``) take lanes laid out for the GPU,
  not the TPU's [G, n, 8, 128] groups, so no call binds to both.
* Values: every name the JAX package takes for ``backend``, an encode
  ``engine`` and a decode ``engine`` runs the port's kernels (here their
  plain versions, ``device="cpu"``) and gives the keyword spelling's bytes;
  an unknown name raises ValueError listing every accepted one.

References: ``llcomp_tpu.oracle`` and ``llcomp_tpu.host`` (no XLA compile),
and one ``llcomp_tpu.encode.encode_lanes`` call.  Tolerance: exact.
"""
from __future__ import annotations

import ast
import importlib
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from llcomp_tpu import api as japi
from llcomp_tpu import cli as jcli
from llcomp_tpu import corpus as jcorpus
from llcomp_tpu import host as jhost
from llcomp_tpu import oracle
from llcomp_tpu import seed as jseed
from llcomp_tpu.core.config import REV2 as JREV2
from llcomp_tpu_torch import (api, cli, corpus, decode, encode, parallel,
                              seed)
from llcomp_tpu_torch.core.config import REV2, CodecConfig
from llcomp_tpu_torch.io import save_image
from tests.conftest import make_photo

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "llcomp_tpu", ROOT / "llcomp_tpu_torch"

# --- signatures --------------------------------------------------------------

_KINDS = {"posonlyargs": inspect.Parameter.POSITIONAL_ONLY,
          "args": inspect.Parameter.POSITIONAL_OR_KEYWORD,
          "kwonlyargs": inspect.Parameter.KEYWORD_ONLY}


def _module_pairs() -> list[tuple[pathlib.Path, pathlib.Path, str]]:
    """(JAX source, the port's source, the port's module name) for each
    module of the same path, and the root graft entry beside the port's."""
    pairs = []
    for src in sorted(JAX_PKG.rglob("*.py")):
        rel = src.relative_to(JAX_PKG)
        parts = [p for p in rel.with_suffix("").parts if p != "__init__"]
        if (PORT_PKG / rel).exists():
            pairs.append((src, PORT_PKG / rel,
                          ".".join(("llcomp_tpu_torch", *parts))))
    pairs.append((ROOT / "__graft_entry__.py", PORT_PKG / "graft_entry.py",
                  "llcomp_tpu_torch.graft_entry"))
    return pairs


def _public_functions(src: pathlib.Path) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in ast.parse(src.read_text()).body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def _jax_params(fn: ast.FunctionDef) -> list[tuple[str, object, str | None]]:
    """(name, kind, default's source or None) of each parameter, in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, _KINDS["posonlyargs" if p in a.posonlyargs else "args"], d)
           for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, inspect.Parameter.VAR_POSITIONAL, None))
    out += [(p.arg, inspect.Parameter.KEYWORD_ONLY, d)
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, inspect.Parameter.VAR_KEYWORD, None))
    return [(n, k, None if d is None else ast.unparse(d)) for n, k, d in out]


def _cases():
    cases, missing = [], {}
    for src, port_src, port_name in _module_pairs():
        ported = _public_functions(port_src)
        rel = src.relative_to(ROOT).as_posix()
        for name, fn in _public_functions(src).items():
            if name in ported:
                cases.append(pytest.param(fn, port_name, name,
                                          id=f"{rel}::{name}"))
            else:
                missing.setdefault(rel, set()).add(name)
    return cases, missing


CASES, MISSING = _cases()

# Public JAX functions without a counterpart: each belongs to an XLA engine,
# the sandwich sort, the cap ladder or the oracle (ROADMAP.md "Not to port").
NOT_TO_PORT = {
    "llcomp_tpu/coder.py": {"encoder_init", "put_step", "pack_slot",
                            "expand_markers", "expand_slots_batch",
                            "expand_kp_grouped", "finish_steps_grouped_off",
                            "expand_slots_on_device"},
    "llcomp_tpu/encode.py": {"fits_pallas_budget"},
    "llcomp_tpu/core/tables.py": {"quant11", "quant5", "pack121",
                                  "prior_full"},
    "llcomp_tpu/core/transform.py": {"count_bins"},
}


def test_the_cases_cover_the_public_surface():
    names = {c.values[2] for c in CASES}
    assert {"encode_lanes", "encode_lanes_pipelined", "decode_lanes",
            "compress", "decompress", "reencode_slice", "encode_stripes",
            "decode_stripes", "compress_corpus", "decompress_corpus",
            "finish_steps", "encode_lanes_sharded", "entry",
            "dryrun_multichip", "initialize", "main"} <= names
    assert MISSING == NOT_TO_PORT


@pytest.mark.parametrize("jfn, port_name, name", CASES)
def test_signature_begins_with_the_jax_packages(jfn, port_name, name):
    mod = importlib.import_module(port_name)
    got = list(inspect.signature(getattr(mod, name)).parameters.values())
    want = _jax_params(jfn)
    assert [(p.name, p.kind) for p in got[:len(want)]] == \
        [(n, k) for n, k, _ in want]
    for p, (n, _, src) in zip(got, want):
        if src is None:
            assert p.default is inspect.Parameter.empty, n
        elif n == "backend" and src in ("'auto'", "'jax'"):
            assert p.default == "torch"
        else:
            assert p.default == eval(src, dict(vars(mod))), n
    extra = [p.name for p in got[len(want):] if p.kind not in (
        inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.VAR_KEYWORD)]
    assert extra == [], f"port-only parameters not keyword-only: {extra}"


# --- the fault's call forms --------------------------------------------------

FAULT_LANES = np.random.default_rng(0).integers(0, 60, (2, 8, 16, 3),
                                                np.uint8)
PHOTO = make_photo(24, 16)
PHOTO_LANES = PHOTO.reshape(3, 8, 16, 3)
LANES = {"fault lanes": FAULT_LANES, "photo stripes": PHOTO_LANES}
# The aliases' inputs: small, since each call runs the plain versions.
SMALL = make_photo(8, 12, seed=3)
ALIAS_LANES = FAULT_LANES[:, :4, :8]


def _oracle_streams(lanes) -> list[bytes]:
    return [oracle.encode(lane)[6:] for lane in lanes]


def test_the_jax_package_codes_auto_unprimed():
    """The call that the port got wrong: the JAX package's
    ``encode_lanes(imgs, REV2, "auto")`` codes unprimed streams."""
    from llcomp_tpu import encode as jencode

    want = _oracle_streams(FAULT_LANES)
    assert [len(s) for s in want] == [475, 485]
    assert jencode.encode_lanes(FAULT_LANES, JREV2, "auto") == want


@pytest.mark.parametrize("which", LANES)
def test_positional_lane_calls(which):
    lanes = LANES[which]
    shape = lanes.shape[1:]
    want = _oracle_streams(lanes)
    got = encode.encode_lanes(lanes, REV2, "auto", device="cpu")
    assert got == want
    np.testing.assert_array_equal(
        decode.decode_lanes(got, shape, REV2, "auto", device="cpu"), lanes)


def test_positional_primed_and_seeded_lane_calls():
    """``primed`` 4th, ``seed`` 5th and ``errors`` 6th, as the JAX package
    places them."""
    lanes = PHOTO_LANES[:, :4]
    shape = lanes.shape[1:]
    tab = jseed.derive(PHOTO)
    for primed, tab_ in ((True, None), (True, tab)):
        streams = encode.encode_lanes(lanes, REV2, "auto", primed, tab_,
                                      device="cpu")
        assert streams == jhost.encode_images(lanes, primed=primed,
                                              seed=tab_)
        out, bad = decode.decode_lanes(streams, shape, REV2, "pallas",
                                       primed, "report", tab_, device="cpu")
        assert bad == []
        np.testing.assert_array_equal(out, lanes)


def test_positional_api_calls():
    """``compress(img, slices, cfg, backend)``, ``decompress(data, cfg,
    backend, strict)`` and the stripes' calls, positionally."""
    blob = api.compress(PHOTO, 1, REV2, "native")
    assert blob == oracle.encode(PHOTO)
    np.testing.assert_array_equal(api.decompress(blob, REV2, "native"), PHOTO)
    blob = api.compress(PHOTO, 3, REV2, "jax", 2, False, False, 0,
                        device="cpu")
    assert blob == japi.compress(PHOTO, 3, JREV2, "native", 2, False, False,
                                 0)
    out, bad = api.decompress(blob, REV2, "jax", False, device="cpu")
    assert bad == []
    np.testing.assert_array_equal(out, PHOTO)
    bounds = [(0, 8), (8, 16), (16, 24)]
    streams = api.encode_stripes(PHOTO, bounds, REV2, True, "jax", None,
                                 device="cpu")
    assert streams == japi.encode_stripes(PHOTO, bounds, JREV2, True,
                                          "native", None)
    np.testing.assert_array_equal(api.decode_stripes(
        streams, bounds, 16, 3, REV2, True, "jax", True, None, (),
        device="cpu"), PHOTO)
    tab = seed.derive(PHOTO, REV2, 2.0, device="cpu")
    np.testing.assert_array_equal(tab, jseed.derive(PHOTO, JREV2, 2.0))


# --- every alias --------------------------------------------------------------


def _spy(monkeypatch, mod, names, calls):
    for name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])


ENCODE_NAMES = encode.ENGINES + tuple(encode.ENGINE_ALIASES)


@pytest.mark.parametrize("engine", ENCODE_NAMES)
def test_encode_engine_names(engine, monkeypatch):
    """Each name gives the keyword spelling's bytes, through the engine
    that the alias table names: 'pallas' through the sort engine."""
    port = encode.ENGINE_ALIASES.get(engine, engine)
    want = encode.encode_lanes(ALIAS_LANES, device="cpu", engine=port)
    assert want == _oracle_streams(ALIAS_LANES)
    calls = []
    _spy(monkeypatch, encode, ("_encode_fused", "_encode_sort",
                               "_encode_decision"), calls)
    assert encode.encode_lanes(ALIAS_LANES, REV2, engine, device="cpu") == want
    assert calls == ["_encode_fused" if port == "fused" else "_encode_sort"]
    calls.clear()
    assert encode.encode_lanes_pipelined(
        [ALIAS_LANES, ALIAS_LANES[:1, :2]], REV2, False, None, engine,
        device="cpu") == [want, _oracle_streams(ALIAS_LANES[:1, :2])]
    assert set(calls) == {"_encode_fused" if port == "fused"
                          else "_encode_sort"}
    assert parallel.encode_lanes_sharded(ALIAS_LANES, ["cpu", "cpu"], REV2,
                                         False, None, engine) == want
    if port == "sort":
        assert encode.encode_lanes(ALIAS_LANES, REV2, engine, device="cpu",
                                   variant="decision") == want


@pytest.mark.parametrize("engine", decode.ENGINES)
def test_decode_engine_names(engine, monkeypatch):
    """Each of the JAX package's decode names runs kernel 2's loop (its
    plain version here) and gives the keyword spelling's pixels."""
    streams = _oracle_streams(ALIAS_LANES)
    calls = []
    _spy(monkeypatch, decode, ("_decode",), calls)
    out = decode.decode_lanes(streams, ALIAS_LANES.shape[1:], REV2, engine,
                              device="cpu")
    assert calls == ["_decode"]
    np.testing.assert_array_equal(out, ALIAS_LANES)
    np.testing.assert_array_equal(out, decode.decode_lanes(
        streams, ALIAS_LANES.shape[1:], device="cpu"))


def test_unknown_names_raise_listing_every_accepted_one():
    with pytest.raises(ValueError) as e:
        encode.encode_lanes(FAULT_LANES, REV2, "lockstep", device="cpu")
    assert all(repr(n) in str(e.value) for n in ENCODE_NAMES)
    with pytest.raises(ValueError, match="engine must be one of"):
        encode.encode_lanes_pipelined([FAULT_LANES], REV2, False, None, "",
                                      device="cpu")
    with pytest.raises(ValueError, match="engine must be one of"):
        parallel.encode_lanes_sharded(FAULT_LANES, ["cpu"], REV2, False,
                                      None, "sort_chain")
    with pytest.raises(ValueError) as e:
        decode.decode_lanes(_oracle_streams(FAULT_LANES), (8, 16, 3), REV2,
                            "fused", device="cpu")
    assert all(repr(n) in str(e.value) for n in decode.ENGINES)
    for call in (lambda: api.compress(SMALL, 3, REV2, "xla", device="cpu"),
                 lambda: api.decompress(oracle.encode(SMALL), REV2, "cuda"),
                 lambda: corpus.compress_corpus([SMALL], 8, REV2, 4096, None,
                                                None, "pallas")):
        with pytest.raises(ValueError) as e:
            call()
        assert all(repr(n) in str(e.value)
                   for n in api.BACKENDS + tuple(api.BACKEND_ALIASES))


BACKEND_NAMES = api.BACKENDS + tuple(api.BACKEND_ALIASES)


def _jax_backend(backend: str, slices) -> str:
    """The JAX package's backend for the reference call: the same name
    where it compiles no XLA (native; 'auto', native on a CPU host; 'oracle'
    on one stream), else 'native', which gives the same bytes."""
    if backend in ("native", "auto") or (backend == "oracle" and not slices):
        return backend
    return "native"


@pytest.mark.parametrize("slices", [None, 2], ids=["single", "sliced"])
@pytest.mark.parametrize("backend", BACKEND_NAMES)
def test_backend_names(backend, slices):
    """The JAX package's result kind for each backend, with and without
    slices: the same bytes, the same pixels, ``(img, bad)`` with
    strict=False, ValueError for a cfg that the native runtime refuses."""
    ref = _jax_backend(backend, slices)
    blob = api.compress(SMALL, slices, REV2, backend, device="cpu")
    assert blob == japi.compress(SMALL, slices, JREV2, ref)
    assert blob == api.compress(SMALL, slices=slices, device="cpu",
                                backend=api.BACKEND_ALIASES.get(backend,
                                                                backend))
    np.testing.assert_array_equal(
        api.decompress(blob, REV2, backend, device="cpu"), SMALL)
    out, bad = api.decompress(blob, REV2, backend, False, device="cpu")
    jout, jbad = japi.decompress(blob, JREV2, ref, False)
    assert bad == jbad == []
    np.testing.assert_array_equal(out, jout)
    if backend == "native":
        from llcomp_tpu.core.config import CodecConfig as JCodecConfig

        jcfg = JCodecConfig(e_lim=3, r_lim=5, sign_ctx=6)
        cfg = CodecConfig(e_lim=3, r_lim=5, sign_ctx=6)
        with pytest.raises(ValueError):
            japi.compress(SMALL, slices, jcfg, backend)
        with pytest.raises(ValueError):
            api.compress(SMALL, slices, cfg, backend, device="cpu")


@pytest.mark.parametrize("backend", BACKEND_NAMES)
def test_corpus_backend_names(backend):
    images = [SMALL, make_photo(4, 10, seed=5)]
    blobs, stats = corpus.compress_corpus(images, 8, REV2, 4096, None, None,
                                          backend, device="cpu")
    jblobs, _ = jcorpus.compress_corpus(images, 8, JREV2, 4096, None, None,
                                        "native")
    assert blobs == jblobs and stats.images == 2
    for out, img in zip(corpus.decompress_corpus(blobs, REV2, 4096, None,
                                                 backend, device="cpu"),
                        images):
        np.testing.assert_array_equal(out, img)


def test_cli_backend_jax(tmp_path):
    """``--backend jax`` on the port's CLI gives the bytes of ``--backend
    torch`` and of the JAX CLI's ``--backend native``; one run goes through
    ``python -m``."""
    src = tmp_path / "photo.ppm"
    save_image(src, SMALL)
    for slices in ((), ("--slices", "3")):
        outs = {}
        for tag in ("jax", "torch"):
            outs[tag] = tmp_path / f"{tag}{len(slices)}.out"
            assert cli.main(["compress", str(src), "-o", str(outs[tag]),
                             *slices, "--backend", tag, "--device",
                             "cpu"]) == 0
        ref = tmp_path / f"ref{len(slices)}.out"
        assert jcli.main(["compress", str(src), "-o", str(ref), *slices,
                          "--backend", "native"]) == 0
        assert outs["jax"].read_bytes() == outs["torch"].read_bytes() == \
            ref.read_bytes()
        back = tmp_path / f"back{len(slices)}.ppm"
        assert cli.main(["decompress", str(outs["jax"]), "-o", str(back),
                         "--backend", "jax", "--device", "cpu"]) == 0
        assert back.read_bytes() == src.read_bytes()
    run = subprocess.run(
        [sys.executable, "-m", "llcomp_tpu_torch.cli", "compress", str(src),
         "-o", str(tmp_path / "m.llct"), "--slices", "3", "--backend", "jax",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert (tmp_path / "m.llct").read_bytes() == ref.read_bytes()

"""The port's CLI (``python -m llcomp_tpu_torch.cli``) with ``--device cpu``
against ``llcomp_tpu.cli`` with ``--backend native``: the same output files
where the JAX CLI writes bytes, exact round trips through .png, .ppm and
.pgm, info, corpus and the self-test.  Tolerance: exact."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from llcomp_tpu import cli as jcli
from llcomp_tpu import oracle
from llcomp_tpu_torch import cli
from llcomp_tpu_torch.io import load_image, save_image
from tests.conftest import make_photo

CPU = ("--device", "cpu")


def _same_file(tmp_path, args, out_name):
    """Run ``args`` through both CLIs; -> the port's output bytes, equal to
    the JAX CLI's."""
    ours, theirs = tmp_path / out_name, tmp_path / ("ref-" + out_name)
    assert cli.main([*args, "-o", str(ours), *CPU]) == 0
    assert jcli.main([*args, "-o", str(theirs), "--backend", "native"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    return ours.read_bytes()


@pytest.fixture
def png(tmp_path):
    img = make_photo(12, 8)
    p = tmp_path / "img.png"
    save_image(p, img)
    return p, img


def test_compress_decompress_cycle(png, tmp_path, capsys):
    p, img = png
    assert cli.main(["compress", str(p), *CPU]) == 0
    out = pathlib.Path(str(p) + ".llcomp")
    assert "MP/s" in capsys.readouterr().out
    assert jcli.main(["compress", str(p), "-o", str(tmp_path / "ref"),
                      "--backend", "native"]) == 0
    assert out.read_bytes() == (tmp_path / "ref").read_bytes()
    assert cli.main(["decompress", str(out), *CPU]) == 0
    np.testing.assert_array_equal(load_image(str(out) + ".png"), img)


def test_compress_sliced_and_info(png, tmp_path, capsys):
    p, img = png
    _same_file(tmp_path, ["compress", str(p), "--slices", "4"], "x.llct")
    capsys.readouterr()
    assert cli.main(["info", str(tmp_path / "x.llct")]) == 0
    txt = capsys.readouterr().out
    assert "4 slices" in txt and "8x12x3" in txt and "crc" in txt
    assert jcli.main(["info", str(tmp_path / "x.llct")]) == 0
    assert capsys.readouterr().out == txt
    assert cli.main(["decompress", str(tmp_path / "x.llct"), "-o",
                     str(tmp_path / "o.png"), *CPU]) == 0
    np.testing.assert_array_equal(load_image(tmp_path / "o.png"), img)


def test_info_single_and_revision_0(png, tmp_path, capsys):
    p, img = png
    _same_file(tmp_path, ["compress", str(p)], "s.llcomp")
    blob = _same_file(tmp_path, ["compress", str(p), "--revision", "0"],
                      "r0.llcomp")
    assert blob[0] == 0x77
    capsys.readouterr()
    for name, want in (("s.llcomp", "reference-compatible"),
                       ("r0.llcomp", "legacy revision 0")):
        assert cli.main(["info", str(tmp_path / name)]) == 0
        assert want in capsys.readouterr().out
    assert cli.main(["decompress", str(tmp_path / "r0.llcomp"), "-o",
                     str(tmp_path / "r0.ppm")]) == 0    # no device needed
    np.testing.assert_array_equal(load_image(tmp_path / "r0.ppm"), img)


def test_ppm_and_pgm_round_trips(tmp_path):
    for name, img in (("img.ppm", make_photo(9, 7)),
                      ("img.pgm", make_photo(8, 6, c=1))):
        p = tmp_path / name
        save_image(p, img)
        np.testing.assert_array_equal(load_image(p), img)
        _same_file(tmp_path, ["compress", str(p), "--slices", "auto"],
                   name + ".llct")
        back = tmp_path / ("back-" + name)
        assert cli.main(["decompress", str(tmp_path / (name + ".llct")),
                         "-o", str(back), "--backend", "native"]) == 0
        np.testing.assert_array_equal(load_image(back), img)
        assert back.read_bytes() == p.read_bytes()


def test_error_paths(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.llcomp"
    bad.write_bytes(b"\x00" * 32)
    assert cli.main(["decompress", str(bad), *CPU]) == 1
    assert "error:" in capsys.readouterr().err
    assert cli.main(["info", str(bad)]) == 1
    with pytest.raises(SystemExit):
        cli.main(["compress", str(bad), "--backend", "xla"])
    # the default device is the GPU: without one the CLI says so
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "img.ppm"
    save_image(p, make_photo(4, 4))
    assert cli.main(["compress", str(p), "--slices", "auto"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_corpus_command(tmp_path, capsys):
    d, ref = tmp_path / "imgs", tmp_path / "ref"
    d.mkdir()
    for i in range(3):
        save_image(d / f"im{i}.ppm", make_photo(8, 6, seed=i))
    assert cli.main(["corpus", str(d), "--verify", *CPU]) == 0
    out = capsys.readouterr().out
    assert "verified 3 images bit-exact" in out and '"images": 3' in out
    assert jcli.main(["corpus", str(d), "-o", str(ref)]) == 0  # native here
    for i in range(3):
        name = f"im{i}.ppm.llct"
        assert (d / name).read_bytes() == (ref / name).read_bytes()


def test_corpus_empty_dir(tmp_path, capsys):
    d = tmp_path / "empty"
    d.mkdir()
    assert cli.main(["corpus", str(d), *CPU]) == 1
    assert "no images" in capsys.readouterr().err


def test_selftest(capsys):
    assert cli.main(["selftest", *CPU]) == 0
    out = capsys.readouterr().out
    assert "selftest: PASS" in out
    assert out.count("ok  ") == 6 and "native" in out


def test_selftest_vectors_are_the_references():
    probe = cli.probe_image()
    assert probe.shape == (12, 8, 3) and np.ptp(probe) > 60
    assert oracle.encode(probe) == bytes.fromhex(cli.PROBE_HEX)
    for img, want in cli.GOLDEN:
        assert oracle.encode(img) == want

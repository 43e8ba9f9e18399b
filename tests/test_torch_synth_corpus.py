"""The synthetic VG corpus (``sgg_torch.data.synthetic``,
``sgg_torch.cli.synth_corpus``) and the native JPEG encoder against
``sgg.data.synthetic`` and ``sgg.cli.synth_corpus`` on the CPU.

- ``spatial_predicate``, ``grounded_vg_entry``, ``render_grounded_image`` and
  ``render_synthetic_image`` bit for bit for the same seeds;
- both CLIs, ``--grounded`` and plain: ``relationships.json`` equal byte for
  byte, the same stats line (``seconds`` aside), and the JPEGs equal byte for
  byte: the port codes them with libjpeg here at PIL's default settings
  (baseline, 4:2:0, quality 75), the bytes the reference's PIL writes;
- the round trip: every JPEG the writer codes decodes (the port's loader, no
  prescale) within a mean |d| of 7.5 of the array it rendered (measured here
  over 256 images at seeds 0 and 5: 5.99-6.56 grounded, 5.95-7.16 plain; the
  ±12 noise the renderer adds is most of it). ``chip_smoke.py`` holds
  nvJPEG's route on the card to mean |d| <= 8 on the grounded corpus;
- ``encode_file`` refuses what it cannot code and raises where it cannot
  write.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import sgg.cli.synth_corpus as jax_cli
from sgg.data import synthetic as js
from sgg_torch import native
from sgg_torch.cli import synth_corpus
from sgg_torch.data import synthetic as ps

torch.set_num_threads(1)

OBJS = list(js._OBJECTS) + [f"obj_{i:03d}" for i in range(16, 200)]


def test_spatial_predicate_matches_reference():
    r = np.random.RandomState(0)
    boxes = [tuple(int(v) for v in (r.randint(0, 400), r.randint(0, 300), r.randint(5, 200),
                                    r.randint(5, 150))) for _ in range(60)]
    boxes += [(10, 10, 100, 100), (20, 20, 10, 10), (10, 10, 100, 100), (300, 10, 50, 50)]
    seen = set()
    for a in boxes:
        for b in boxes:
            got = ps.spatial_predicate(a, b)
            assert got == js.spatial_predicate(a, b)
            seen.add(got)
    assert seen == set(ps.GROUNDED_PREDICATES) == set(js.GROUNDED_PREDICATES)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_entries_and_renders_match_reference(seed):
    ents_ref, ents_port = np.random.RandomState(seed), np.random.RandomState(seed)
    img_ref, img_port = np.random.RandomState(seed + 1), np.random.RandomState(seed + 1)
    for i in range(4):
        want_e, want_b = js.grounded_vg_entry(1000 + i, ents_ref, OBJS)
        got_e, got_b = ps.grounded_vg_entry(1000 + i, ents_port, OBJS)
        assert json.dumps(got_e) == json.dumps(want_e) and got_b == want_b
        want = js.render_grounded_image(want_b, img_ref)
        got = ps.render_grounded_image(got_b, img_port)
        assert got.dtype == np.uint8 and got.shape == (375, 500, 3)
        np.testing.assert_array_equal(got, want)
        want = js.render_synthetic_image(want_e["relationships"], img_ref, width=320, height=240)
        got = ps.render_synthetic_image(got_e["relationships"], img_port, width=320, height=240)
        np.testing.assert_array_equal(got, want)
    assert ps._name_color("man") == js._name_color("man")


def _cli(main, out_dir, grounded):
    buf = io.StringIO()
    argv = ["--out-dir", str(out_dir), "--num-images", "6", "--seed", "3"]
    with contextlib.redirect_stdout(buf):
        assert main(argv + (["--grounded"] if grounded else [])) == 0
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[sgg.synth_corpus] {")]
    assert len(line) == 1
    return json.loads(line[0].split(" ", 1)[1]), buf.getvalue()


@pytest.mark.parametrize("grounded", [True, False])
def test_both_clis_write_the_same_corpus(tmp_path, grounded):
    want, _ = _cli(jax_cli.main, tmp_path / "ref", grounded)
    got, printed = _cli(synth_corpus.main, tmp_path / "port", grounded)
    assert f"[sgg.synth_corpus] JPEG encoder: {native.route()}" in printed
    for d in (want, got):
        d.pop("seconds")
        d["image_dir"] = os.path.relpath(d["image_dir"], tmp_path).split(os.sep, 1)[1]
        d["json"] = os.path.relpath(d["json"], tmp_path).split(os.sep, 1)[1]
    assert got == want and got["num_images"] == 6
    assert (tmp_path / "port" / "relationships.json").read_bytes() == \
        (tmp_path / "ref" / "relationships.json").read_bytes()
    names = sorted(os.listdir(tmp_path / "ref" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images")) and len(names) == 6
    assert native.route() == "libjpeg"
    for n in names:  # libjpeg at PIL's defaults: PIL's bytes
        assert (tmp_path / "port" / "images" / n).read_bytes() == \
            (tmp_path / "ref" / "images" / n).read_bytes(), n
    rels = json.loads((tmp_path / "port" / "relationships.json").read_text())
    assert all(("x" in r["subject"]) == grounded for e in rels for r in e["relationships"])


@pytest.mark.parametrize("grounded", [True, False])
def test_round_trip_within_bound(tmp_path, monkeypatch, grounded):
    seen = []
    encode = native.encode_file

    def recording(path, rgb, **kw):
        encode(path, rgb, **kw)
        seen.append((rgb, path))

    monkeypatch.setattr(native, "encode_file", recording)
    ps.write_synthetic_vg_corpus(str(tmp_path), 12, seed=5, grounded=grounded, log_every=0)
    assert len(seen) == 12
    for arr, path in seen:
        back = native.decode_raw(path, native.loader.FULL_SIZE)
        assert back.shape == arr.shape
        assert np.abs(back.astype(np.int32) - arr).mean() <= 7.5
        assert native.image_size(path) == (500, 375)


def test_encode_file_refusals(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        native.encode_file(str(tmp_path / "a.jpg"), np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        native.encode_file(str(tmp_path / "a.jpg"), np.zeros((4, 4), np.uint8))
    with pytest.raises(OSError, match="cannot write"):
        native.encode_file(str(tmp_path / "no" / "a.jpg"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(IOError, match="encode failed"):
        native.encode_file(str(tmp_path / "a.jpg"), np.zeros((4, 4, 3), np.uint8), quality=0)
    native.encode_file(str(tmp_path / "b.jpg"), np.full((9, 7, 3), 200, np.uint8), quality=90)
    assert native.decode_raw(str(tmp_path / "b.jpg"), 4).shape == (9, 7, 3)

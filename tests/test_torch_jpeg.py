"""The port's JPEG loader (``sgg_torch.native``) and image loaders
(``sgg_torch.data.extract``) against ``sgg.native`` and ``sgg.data.extract``
on the CPU: the loader builds here (g++ and libjpeg); on the reference test's
smooth images and on the committed VG-shaped fixture, ``decode_file`` and
``decode_batch`` give the reference's bytes exactly at 224, 128 and 99 px;
the resize equals its plain numpy version bit for bit; threads equal one
file at a time; missing and corrupt files raise. ``load_and_resize``,
``load_batch`` and ``resolve_image_paths`` equal the reference's (files the
loader rejects go to PIL in both), and a loader that cannot be built raises
instead of falling back.
"""

import os

import numpy as np
import pytest
import torch

from sgg import native as jax_native
from sgg.data import extract as jax_extract
from sgg_torch import native
from sgg_torch.data import extract
from sgg_torch.native import loader

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                       "vg_jpeg")
FIXTURE_JPEGS = sorted(os.path.join(FIXTURE, "images", f)
                       for f in os.listdir(os.path.join(FIXTURE, "images")))
SIZES = [224, 128, 99]


@pytest.fixture(scope="module", autouse=True)
def reference_native(tmp_path_factory):
    """``sgg.native``'s JPEG loader built into a library of this module's own.
    The reference builds ``libsggjpeg.so`` beside its source with no lock, so
    test processes that start together race to write one file, and a process
    that loads it half-written keeps the failure and decodes with PIL. Here
    its loader builds a private copy, and a build that fails fails the module
    with the compiler's message. Every test module that compares decoded
    pixels with ``sgg``'s imports this fixture."""
    from sgg.native import loader as ref_loader

    saved = ref_loader._SO, ref_loader._lib, ref_loader._error
    ref_loader._SO = str(tmp_path_factory.mktemp("sggjpeg") / "libsggjpeg.so")
    ref_loader._lib = ref_loader._error = None
    try:
        assert jax_native.native_available(), ref_loader._error
        yield
    finally:
        ref_loader._SO, ref_loader._lib, ref_loader._error = saved


@pytest.fixture(scope="module")
def smooth_jpegs(tmp_path_factory):
    """The reference test's smooth images (``tests/unit/test_native_loader.py``)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, (h, w) in enumerate([(480, 640), (224, 224), (1024, 768), (99, 173)]):
        base = np.zeros((h, w, 3), np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for c in range(3):
            base[..., c] = 127 + 100 * np.sin(xx / (20 + 10 * c)) * np.cos(yy / (25 + 5 * c))
        p = str(d / f"img{i}.jpg")
        Image.fromarray(base.clip(0, 255).astype(np.uint8)).save(p, quality=95)
        paths.append(p)
    return paths


def test_loader_builds_with_libjpeg():
    assert native.native_available()
    assert native.route() == "libjpeg"
    assert (loader.BUILD_DIR / loader.LIB_NAME).exists()


@pytest.mark.parametrize("size", SIZES)
def test_decode_equals_reference_bytes(smooth_jpegs, size):
    """Exact bytes: the same libjpeg, prescale and fixed-point resize."""
    paths = smooth_jpegs + FIXTURE_JPEGS[:6]
    for p in paths:
        np.testing.assert_array_equal(native.decode_file(p, size),
                                      jax_native.decode_file(p, size))
    np.testing.assert_array_equal(native.decode_batch(paths, size, n_threads=3),
                                  jax_native.decode_batch(paths, size, n_threads=2))


def test_fixture_decodes_to_committed_reference_bytes():
    ref = np.load(os.path.join(FIXTURE, "decoded_224.npz"))
    got = native.decode_batch([os.path.join(FIXTURE, "images", str(n)) for n in ref["names"]],
                              224)
    np.testing.assert_array_equal(got, ref["images"])


@pytest.mark.parametrize("size", [224, 64])
def test_resize_equals_plain_version(smooth_jpegs, size):
    """decode_file = resize_plain(decode_raw): the loader's resize bit for bit
    against its numpy version, prescaled decodes included."""
    for p in smooth_jpegs + FIXTURE_JPEGS[:4]:
        raw = native.decode_raw(p, size)
        np.testing.assert_array_equal(native.resize_plain(raw, size),
                                      native.decode_file(p, size))
    assert native.decode_raw(smooth_jpegs[2], 64).shape == (128, 96, 3)  # 1/8 prescale


def test_decode_batch_threaded_equals_single(smooth_jpegs):
    out = native.decode_batch(smooth_jpegs * 4, 128, n_threads=4)
    assert out.shape == (16, 128, 128, 3) and out.dtype == np.uint8
    for j, p in enumerate(smooth_jpegs * 4):
        np.testing.assert_array_equal(out[j], native.decode_file(p, 128))


def test_missing_and_corrupt_files_raise(smooth_jpegs, tmp_path):
    with pytest.raises(IOError):
        native.decode_file(str(tmp_path / "nope.jpg"), 64)
    with pytest.raises(IOError, match="failed for 1 files"):
        native.decode_batch([smooth_jpegs[0], str(tmp_path / "nope.jpg")], 64)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0garbagegarbage")
    with pytest.raises(IOError):
        native.decode_file(str(bad), 64)
    with pytest.raises(IOError):
        native.decode_raw(str(bad), 64)


def test_image_loaders_equal_reference(smooth_jpegs, tmp_path):
    from PIL import Image

    png, cmyk = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    r = np.random.RandomState(0)
    Image.fromarray(r.randint(0, 256, (50, 70, 3)).astype(np.uint8)).save(png)
    Image.fromarray(r.randint(0, 256, (40, 60, 4)).astype(np.uint8), "CMYK").save(cmyk)
    with pytest.raises(IOError):  # the loader rejects CMYK ...
        native.decode_file(cmyk, 32)
    for p in smooth_jpegs[:2] + [png, cmyk]:  # ... so both packages take PIL for it
        np.testing.assert_array_equal(extract.load_and_resize(p, 99),
                                      jax_extract.load_and_resize(p, 99))
    for paths in (smooth_jpegs, FIXTURE_JPEGS[:5], [smooth_jpegs[0], png, cmyk]):
        np.testing.assert_array_equal(extract.load_batch(paths, 64),
                                      jax_extract.load_batch(paths, 64))


def test_resolve_image_paths_equals_reference(tmp_path):
    d = os.path.join(FIXTURE, "images")
    ids = [1003, 1000, 1031, 1017]
    assert extract.resolve_image_paths(ids, d) == jax_extract.resolve_image_paths(ids, d)
    (tmp_path / "7.png").write_bytes(b"")
    assert extract.resolve_image_paths([7], str(tmp_path)) == \
        jax_extract.resolve_image_paths([7], str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jax_extract.resolve_image_paths(ids + [5, 6], d)
    with pytest.raises(FileNotFoundError) as got:
        extract.resolve_image_paths(ids + [5, 6], d)
    assert str(got.value) == str(want.value)


def test_unavailable_loader_raises_and_does_not_fall_back(smooth_jpegs, monkeypatch):
    def unavailable():
        raise native.NativeUnavailable("no JPEG decoder to build against (test)")

    monkeypatch.setattr(loader, "_load", unavailable)
    assert not native.native_available()
    with pytest.raises(native.NativeUnavailable):
        extract.load_batch(smooth_jpegs, 64)
    with pytest.raises(native.NativeUnavailable):
        extract.load_and_resize(smooth_jpegs[0], 64)


def test_rejected_file_without_pil_names_it(tmp_path, monkeypatch):
    from PIL import Image

    cmyk = str(tmp_path / "c.jpg")
    Image.new("CMYK", (20, 20)).save(cmyk)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(IOError, match="c.jpg.*PIL is not installed"):
        extract.load_batch([cmyk], 16)

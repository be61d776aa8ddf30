"""The port's image data sources (videovector_tpu_torch.data.generic: DATA's
DatumRecordSource, IMAGE_DATA's ImageDataSource), the factory's DATA and
IMAGE_DATA branches with the mean file, and the native JPEG decoder,
against the JAX package's on the CPU.

Stores, images and means are made with numpy from a seed. The same store
or list and seed give JAX's batches bit for bit (crops, mirrors, shuffles
and rand_skip draw from one np.random.RandomState each), through each
decoder both packages can use here: PIL (cv2 and the native decoder turned
off in both), cv2 where it imports, and the native libjpeg decoder where
the library was built against libjpeg (skipped otherwise).
"""

import sys

import numpy as np
import pytest
from PIL import Image

from videovector_tpu.config import parse as jparse
from videovector_tpu.data import generic as jgen
from videovector_tpu.data import native as jnative
from videovector_tpu.data.transformer import TransformConfig as JTransform
from videovector_tpu.graph import data_factory as jfac
from videovector_tpu_torch.config import parse as tparse
from videovector_tpu_torch.data import generic as tgen
from videovector_tpu_torch.data import native as tnative
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import wire as twire
from videovector_tpu_torch.data.transformer import TransformConfig as TTransform
from videovector_tpu_torch.graph import data_factory as tfac

C, H, W, CROP = 3, 20, 24, 16


@pytest.fixture(scope="module")
def datum_store(tmp_path_factory):
    """13 uint8 Datums of 3 x 20 x 24 with labels, a mean BlobProto."""
    tmp = tmp_path_factory.mktemp("datums")
    rs = np.random.RandomState(21)
    path = str(tmp / "images.vvr")
    with trec.RecordWriter(path) as w:
        for i in range(13):
            pix = rs.randint(0, 256, (C, H, W)).astype(np.uint8)
            w.append(f"{i:08d}", twire.Datum(
                channels=C, height=H, width=W, data=pix.tobytes(),
                label=int(rs.randint(5))).encode())
    mean = (rs.rand(1, C, H, W) * 255).astype(np.float32)
    mean_path = str(tmp / "mean.blob")
    with open(mean_path, "wb") as f:
        f.write(twire.BlobProto.from_array(mean).encode())
    return path, mean_path, mean[0]


@pytest.fixture(scope="module")
def image_list(tmp_path_factory):
    """7 JPEGs and 2 PNGs of assorted sizes, listed with labels (one line
    without a label)."""
    tmp = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(22)
    lines = []
    for i in range(9):
        h, w = rs.randint(18, 40), rs.randint(18, 40)
        img = Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        name = tmp / (f"im{i}.png" if i in (3, 7) else f"im{i}.jpg")
        img.save(name, quality=90)
        lines.append(f"{name} {i % 4}" if i != 5 else str(name))
    lst = tmp / "list.txt"
    lst.write_text("\n".join(lines) + "\n\n")
    return str(lst)


def _same_batches(jsrc, tsrc, n):
    for _ in range(n):
        jb, tb = jsrc.next_batch(), tsrc.next_batch()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("train,mirror,rand_skip", [
    (False, False, 0), (True, True, 0), (True, False, 7), (False, False, 13)])
def test_datum_record_source_matches_jax(datum_store, train, mirror,
                                         rand_skip):
    path, _, mean = datum_store
    kw = dict(mean=mean, train=train, rand_skip=rand_skip, seed=77)
    jsrc = jgen.DatumRecordSource(
        path, 5, transform=JTransform(crop_size=CROP, mirror=mirror,
                                      scale=0.5), **kw)
    tsrc = tgen.DatumRecordSource(
        path, 5, transform=TTransform(crop_size=CROP, mirror=mirror,
                                      scale=0.5), **kw)
    assert tsrc._cursor == jsrc._cursor
    _same_batches(jsrc, tsrc, 4)   # 20 items: wraps the 13-record store


def test_datum_source_without_crop_or_mean(datum_store):
    path = datum_store[0]
    tb = tgen.DatumRecordSource(path, 3).next_batch()
    jb = jgen.DatumRecordSource(path, 3).next_batch()
    assert tb["data"].shape == (3, C, H, W)
    np.testing.assert_array_equal(tb["data"], jb["data"])
    np.testing.assert_array_equal(tb["label"], jb["label"])


def test_rand_skip_beyond_the_dataset_raises(datum_store):
    with pytest.raises(ValueError, match="exceeds the dataset size 13"):
        tgen.DatumRecordSource(datum_store[0], 2, rand_skip=14)
    assert tgen._rand_skip_cursor(np.random.RandomState(1), 0, 5) == 0


def _image_sources(lst, *, shuffle, train, resize, mean=None):
    kw = dict(source=lst, batch_size=4, shuffle=shuffle, rand_skip=3,
              **({"new_height": 30, "new_width": 26} if resize else {}))
    crop = dict(crop_size=CROP, mirror=train)
    return (jgen.ImageDataSource(jgen.ImageDataConfig(**kw),
                                 transform=JTransform(**crop), mean=mean,
                                 train=train, seed=5),
            tgen.ImageDataSource(tgen.ImageDataConfig(**kw),
                                 transform=TTransform(**crop), mean=mean,
                                 train=train, seed=5))


@pytest.mark.parametrize("shuffle,train", [(False, False), (True, True)])
def test_image_data_source_with_pil_matches_jax(image_list, monkeypatch,
                                                shuffle, train):
    """PIL in both: the native decoder off, cv2 blocked."""
    monkeypatch.setenv("VVTPU_NATIVE_DECODE", "0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    jsrc, tsrc = _image_sources(image_list, shuffle=shuffle, train=train,
                                resize=True)
    assert tsrc.items == jsrc.items
    _same_batches(jsrc, tsrc, 5)   # 20 items: reshuffles at each wrap


def test_image_data_source_with_cv2_matches_jax(image_list, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.setenv("VVTPU_NATIVE_DECODE", "0")
    jsrc, tsrc = _image_sources(image_list, shuffle=True, train=True,
                                resize=True)
    _same_batches(jsrc, tsrc, 3)


@pytest.mark.parametrize("resize", [True, False])
def test_image_data_source_with_native_jpeg_matches_jax(image_list, resize):
    """Both packages' builds of native/vvdata.cpp decode the JPEGs; the
    PNGs go on to cv2 (or PIL) in both. Without a crop the batch needs
    images of one size, so that case resizes in the decoder only."""
    if not (tnative.jpeg_available() and jnative.jpeg_available()):
        pytest.skip("the native library was built without libjpeg here")
    jsrc, tsrc = _image_sources(image_list, shuffle=False, train=False,
                                resize=True)
    _same_batches(jsrc, tsrc, 3)
    payload = open(tsrc.items[0][0], "rb").read()
    got = tnative.decode_jpeg_bgr(payload, 26 if resize else 0,
                                  30 if resize else 0)
    ref = jnative.decode_jpeg_bgr(payload, 26 if resize else 0,
                                  30 if resize else 0)
    np.testing.assert_array_equal(got, ref)
    assert tnative.decode_jpeg_bgr(b"not a jpeg") is None


def _layer(txt, parse):
    return parse(txt).get_list("layers")[0]


def test_factory_data_layer_matches_jax(datum_store):
    path, mean_path, mean = datum_store
    txt = f"""layers {{ name: "data" type: DATA top: "data" top: "label"
      data_param {{ source: "{path}" batch_size: 4 rand_skip: 5 }}
      transform_param {{ crop_size: {CROP} mirror: true
                         mean_file: "{mean_path}" scale: 0.25 }} }}"""
    np.testing.assert_array_equal(tfac._load_mean(_layer(txt, tparse)), mean)
    for phase in ("TRAIN", "TEST"):
        jsrc = jfac.make_data_source(_layer(txt, jparse), phase=phase, seed=9)
        tsrc = tfac.make_data_source(_layer(txt, tparse), phase=phase, seed=9)
        _same_batches(jsrc, tsrc, 4)


def test_factory_image_data_layer_matches_jax(image_list, datum_store,
                                              monkeypatch):
    monkeypatch.setenv("VVTPU_NATIVE_DECODE", "0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    txt = f"""layers {{ name: "data" type: IMAGE_DATA top: "img" top: "lab"
      image_data_param {{ source: "{image_list}" batch_size: 3
                          new_height: {H} new_width: {W} shuffle: true }}
      transform_param {{ crop_size: {CROP}
                         mean_file: "{datum_store[1]}" }} }}"""
    jsrc = jfac.make_data_source(_layer(txt, jparse), phase="TEST", seed=4)
    tsrc = tfac.make_data_source(_layer(txt, tparse), phase="TEST", seed=4)
    assert sorted(tsrc.next_batch()) == ["img", "lab"]
    jsrc.next_batch()
    _same_batches(jsrc, tsrc, 4)


def test_factory_without_mean_file():
    layer = _layer('layers { name: "d" type: DATA top: "x" }', tparse)
    assert tfac._load_mean(layer) is None

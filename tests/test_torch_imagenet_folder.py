"""The port's streaming image folder (edge_enhancement_tpu_torch/data:
StreamingImageFolder, rrc_box_from_draws, _eval_center_box, the native
JPEG decoder of data/native.py) against the JAX package's: the same
boxes, the same batches bit for bit (the native decoders link the same
libjpeg here), the same PIL fallback, and the 29 ImageNet configs reading
a folder."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import glob
import os

import numpy as np
import pytest

import torch_port_helpers as helpers
from edge_enhancement_tpu.data import datasets as jds
from edge_enhancement_tpu.utils import config as jcfg
from edge_enhancement_tpu_torch.data import datasets as tds
from edge_enhancement_tpu_torch.data import native
from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.utils import config as tcfg

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "edge_enhancement_tpu", "configs")
IMAGENET_CONFIGS = sorted(
    os.path.relpath(p, CONFIGS) for sub in ("imagenet", "fast_imagenet", "free_imagenet")
    for p in glob.glob(os.path.join(CONFIGS, sub, "*.yml")))
# (h, w) of the folder's JPEGs: ImageNet's usual shapes and odd ones
SIZES = ((90, 120), (375, 500), (500, 333), (64, 64), (77, 131))


def _spy_native(monkeypatch) -> list:
    """[delivered, handed back] batches of the port's (0) and the JAX
    package's (1) native decoder."""
    return helpers.native_decode_spy(monkeypatch, native, jds.native)


def _write_folder(root, per_class=5, png=True, odd=None) -> str:
    """root/<class>/*: quality-92 JPEGs of SIZES (noise over a smooth ramp),
    one PNG in the first class; `odd` = (name, writer) adds one more file."""
    rng = np.random.default_rng(3)
    for c in range(2):
        d = os.path.join(root, f"n{c:08d}")
        os.makedirs(d)
        for k in range(per_class):
            h, w = SIZES[(k + c) % len(SIZES)]
            ramp = np.linspace(0, 200, w)[None, :, None]
            px = np.clip(ramp + rng.integers(0, 56, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(px).save(os.path.join(d, f"img_{k}.JPEG"), quality=92)
    if png:
        px = rng.integers(0, 256, (81, 99, 3), dtype=np.uint8)
        Image.fromarray(px).save(os.path.join(root, "n00000000", "img_png.png"))
    if odd is not None:
        name, write = odd
        write(os.path.join(root, "n00000001", name), rng)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(str(tmp_path_factory.mktemp("imagenet")))


def _batches(ds, **kw) -> list:
    return list(ds.batches(**kw))


def _assert_same(t, j, **kw):
    got, want = _batches(t, **kw), _batches(j, **kw)
    assert len(got) == len(want) > 0
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.dtype == xw.dtype and xg.shape == xw.shape
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    return got


def _pair(folder, **kw):
    return (tds.StreamingImageFolder(folder, **kw),
            jds.StreamingImageFolder(folder, **kw))


# --------------------------------------------------------------------------
# boxes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(90, 120), (375, 500), (500, 333), (64, 64),
                                (1, 1), (3, 700)])
def test_rrc_boxes_match(hw):
    h, w = hw
    draws = np.random.default_rng(11).random((2000, 40)).astype(np.float32)
    for row in draws:
        assert tds.rrc_box_from_draws(row, h, w) == jds.rrc_box_from_draws(row, h, w)


def test_rrc_box_falls_back_to_the_centre_square():
    """A 10 x 1000 image: every try's box is taller than the image, so the
    box is the centre square; the same in both packages."""
    draws = np.random.default_rng(0).random((200, 40)).astype(np.float32)
    draws[:, 0::4] = 1.0   # the whole area, whatever the ratio
    for row in draws:
        box = tds.rrc_box_from_draws(row, 10, 1000)
        assert box == jds.rrc_box_from_draws(row, 10, 1000) == (0, 495, 10, 10)


def test_boxes_round_half_away_from_zero():
    """Both box functions round as C++'s lround: 2.5 -> 3, where Python's
    round gives 2 (a centre side of 5 x 1 / 2)."""
    assert [tds._round_half_away(v) for v in (0.5, 1.5, 2.5, 2.4999)] == [1, 2, 3, 2]
    assert tds._eval_center_box(5, 5, 2, 1) == jds._eval_center_box(5, 5, 2, 1) == (1, 1, 3, 3)


@pytest.mark.parametrize("resize_crop", [(256, 224), (146, 128), (329, 288),
                                         (2, 1), (293, 256)])
def test_eval_center_boxes_match(resize_crop):
    resize, crop = resize_crop
    for h in (1, 5, 7, 64, 90, 333, 375, 500):
        for w in (1, 5, 7, 64, 120, 333, 500):
            want = jds._eval_center_box(h, w, resize, crop)
            assert tds._eval_center_box(h, w, resize, crop) == want


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["rrc", "hflip", "eval"])
def test_streaming_folder_matches(folder, monkeypatch, mode):
    """RRC train at 128 px, hflip train, and eval (146 -> 128 centre box)
    equal the JAX package's, uint8 and float32, over two epochs; the
    batches holding the PNG go through PIL on both sides, the others
    through libjpeg."""
    hits = _spy_native(monkeypatch)
    kw = (dict(image_size=128, train=True, train_mode=mode) if mode != "eval"
          else dict(image_size=128, train=False, eval_resize=146, eval_crop=128))
    t, j = _pair(folder, **kw)
    assert len(t) == len(j) == 11
    for epoch in (0, 3):
        for as_uint8 in (True, False):
            _assert_same(t, j, batch_size=4, shuffle=True, seed=5, epoch=epoch,
                         drop_last=False, as_uint8=as_uint8)
    assert hits[0] == hits[1] and hits[0][0] > 0 and hits[0][1] > 0, hits


def test_streaming_folder_shards_and_drop_last(folder):
    """2 processes: each process's share of the rows, as many batches
    each, drop_last and the epoch's seed as in the JAX package."""
    t, j = _pair(folder, image_size=64, train=True)
    for p in range(2):
        for drop_last in (True, False):
            for epoch in (0, 1):
                got = _assert_same(t, j, batch_size=2, shuffle=True, seed=9,
                                   epoch=epoch, drop_last=drop_last,
                                   process_index=p, process_count=2, as_uint8=True)
                # 11 images: 10 shared out, 5 a process
                assert len(got) == (2 if drop_last else 3)
    a, b = _batches(t, batch_size=4, shuffle=True, seed=9, epoch=0, as_uint8=True), \
        _batches(t, batch_size=4, shuffle=True, seed=9, epoch=1, as_uint8=True)
    assert not np.array_equal(a[0][0], b[0][0])


def test_pil_fallback_matches(folder, monkeypatch):
    """With the native decoder refusing every batch on both sides, the
    port's PIL path equals the JAX package's PIL path bit for bit."""
    for mod in (native, jds.native):
        monkeypatch.setattr(mod, "stream_decode_files", lambda *a, **k: None)
    for kw in (dict(image_size=128, train=True),
               dict(image_size=96, train=True, train_mode="hflip"),
               dict(image_size=128, train=False, eval_resize=146, eval_crop=128),
               dict(image_size=64, train=False)):
        t, j = _pair(folder, **kw)
        for as_uint8 in (True, False):
            _assert_same(t, j, batch_size=4, shuffle=True, seed=2, drop_last=False,
                         as_uint8=as_uint8)


def _cmyk_jpeg(path, rng):
    px = rng.integers(0, 256, (70, 90, 4), dtype=np.uint8)
    Image.fromarray(px, "CMYK").save(path, "JPEG", quality=92)


def _png_named_jpeg(path, rng):
    px = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    Image.fromarray(px).save(path, "PNG")


@pytest.mark.parametrize("odd", [("img_cmyk.JPEG", _cmyk_jpeg),
                                 ("img_png.JPEG", _png_named_jpeg)],
                         ids=["cmyk", "png_named_jpeg"])
def test_a_file_libjpeg_refuses_sends_its_batch_to_pil(tmp_path, monkeypatch, odd):
    """A CMYK JPEG (libjpeg will not convert it to RGB) or a PNG named
    .JPEG, both in ImageNet: libjpeg fails on it, so its whole batch goes
    through PIL, on both sides, and the batches stay equal."""
    root = _write_folder(str(tmp_path), per_class=4, png=False, odd=odd)
    hits = _spy_native(monkeypatch)
    t, j = _pair(root, image_size=64, train=True)
    got = _assert_same(t, j, batch_size=3, shuffle=False, seed=0, drop_last=False,
                       as_uint8=True)
    assert len(got) == 3
    # the odd file is the last one: the first two batches native, the last PIL
    assert hits[0] == hits[1] == [2, 1], hits


def _garbage(path, rng):
    with open(path, "wb") as f:
        f.write(b"not an image")


def test_a_producer_error_is_raised_in_the_consumer(tmp_path):
    """A file neither decoder reads: the lookahead thread's exception is
    raised where the batches are consumed, on both sides."""
    root = _write_folder(str(tmp_path), per_class=2, png=False,
                         odd=("img_bad.JPEG", _garbage))
    for ds in _pair(root, image_size=32, train=True):
        with pytest.raises(PIL.UnidentifiedImageError):
            _batches(ds, batch_size=2, shuffle=False, seed=0, drop_last=False)
    # the batches before the bad one are delivered first
    it = tds.StreamingImageFolder(root, image_size=32, train=True).batches(
        batch_size=2, shuffle=False, seed=0, drop_last=False)
    assert next(it)[0].shape == (2, 32, 32, 3)
    with pytest.raises(PIL.UnidentifiedImageError):
        list(it)


def test_decode_path(monkeypatch):
    """libjpeg here; PIL where the decoder has no libjpeg; an error naming
    both where neither is present."""
    assert native.decode_path() == "libjpeg"
    monkeypatch.setattr(native, "has_jpeg", lambda: False)
    assert native.decode_path() == "pil"
    monkeypatch.setattr(native, "_have_pil", lambda: False)
    with pytest.raises(RuntimeError, match="libjpeg.*PIL"):
        native.decode_path()


# --------------------------------------------------------------------------
# the 29 ImageNet configs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet_root"))
    for split in ("train", "val"):
        _write_folder(os.path.join(root, split), per_class=2, png=False)
    return root


def test_imagenet_configs_are_29():
    assert len(IMAGENET_CONFIGS) == 29


@pytest.mark.parametrize("config", IMAGENET_CONFIGS)
def test_imagenet_config_reads_a_folder(imagenet_root, config):
    """The driver's datasets of each ImageNet config from a folder: the
    train split RandomResizedCrop, the validation split the centre box, at
    the config's size (its cize), each first batch equal to the JAX
    package's get_dataset at the same size."""
    path = os.path.join(CONFIGS, config)
    cfg = tcfg.load_config(path, dict(data=imagenet_root))
    assert dict(cfg) == dict(jcfg.load_config(path, dict(data=imagenet_root)))
    train_ds, val_ds, spec = driver.load_datasets(cfg)
    size = int(cfg.get("cize") or cfg.get("crop_size") or 224)
    assert spec.image_size == size and spec.num_classes == 1000
    for ds, train in ((train_ds, True), (val_ds, False)):
        assert isinstance(ds, tds.StreamingImageFolder) and ds.train == train
        assert len(ds) == 4
        want, _ = jds.get_dataset("imagenet", imagenet_root, train=train,
                                  image_size=size)
        (x, y), = _batches(ds, batch_size=4, shuffle=train, seed=1, as_uint8=True)
        (xw, yw), = _batches(want, batch_size=4, shuffle=train, seed=1, as_uint8=True)
        assert x.shape == (4, size, size, 3)
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(y, yw)

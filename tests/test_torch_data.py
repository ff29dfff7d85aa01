"""The port's own copies of the JAX package's data, config, schedule and
meter modules (edge_enhancement_tpu_torch/data, utils, train/schedules)
against the JAX modules: the same batches in the same order, the same
learning rates, the same log strings, the same config."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os

import numpy as np
import pytest

import torch_port_helpers as helpers
from edge_enhancement_tpu.data import datasets as jds
from edge_enhancement_tpu.train import schedules as jsched
from edge_enhancement_tpu.utils import config as jcfg
from edge_enhancement_tpu.utils import meters as jmeters
from edge_enhancement_tpu_torch.data import datasets as tds
from edge_enhancement_tpu_torch.train import schedules as tsched
from edge_enhancement_tpu_torch.utils import config as tcfg
from edge_enhancement_tpu_torch.utils import meters as tmeters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")


def _same_batches(a, b, exact=False, **kw):
    got = list(a.batches(**kw))
    want = list(b.batches(**kw))
    assert len(got) == len(want) > 0
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.dtype == xw.dtype and xg.shape == xw.shape
        if exact or xg.dtype == np.uint8:
            np.testing.assert_array_equal(xg, xw)
        else:
            # the port divides by 255 (as the trainer's to_float_pixels and
            # the JAX package's numpy path do); the JAX native gather
            # multiplies by 1/255f: one ulp apart at most
            np.testing.assert_allclose(xg, xw, atol=6e-8, rtol=0)
        np.testing.assert_array_equal(yg, yw)


@pytest.mark.parametrize("root", ["synthetic", "synthetic-hard"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_batches_match(root, train):
    t, tspec = tds.get_dataset("tiny_imagenet", root, train=train, synthetic_size=24,
                               image_size=32)
    j, jspec = jds.get_dataset("tiny_imagenet", root, train=train, synthetic_size=24,
                               image_size=32)
    assert tspec == tds.DatasetSpec(**vars(jspec))
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    for epoch in (0, 3):
        _same_batches(t, j, batch_size=5, shuffle=True, seed=1, epoch=epoch,
                      as_uint8=True)
    _same_batches(t, j, batch_size=7, shuffle=False, seed=0, as_uint8=True)
    _same_batches(t, j, batch_size=8, shuffle=True, seed=2, as_uint8=False)
    (xf, _), = t.batches(batch_size=24, shuffle=False, seed=0)
    np.testing.assert_array_equal(xf, t.images.astype(np.float32) / 255.0)


def _image(rng, size: int, kind: str) -> np.ndarray:
    """(size, size, 3) uint8: uniform noise, or smooth gradients (a ramp a
    channel with a random phase)."""
    if kind == "noise":
        return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size] / size
    phase = rng.random(3)
    return np.stack([127.5 + 127.5 * np.sin(2 * np.pi * (yy * (c + 1) + xx + phase[c]))
                     for c in range(3)], axis=-1).astype(np.uint8)


def _write_tiny_imagenet(root, rng, n_classes=3, per_class=5, n_val=7,
                         fmt="png", kind="noise"):
    """The Tiny-ImageNet layout: train/<wnid>/images/* and the raw
    val/images + val_annotations.txt, some train images not 64 x 64; PNG
    files, or JPEGs at quality 92 (Tiny-ImageNet ships JPEGs)."""
    from PIL import Image
    ext = {"png": "png", "jpeg": "JPEG"}[fmt]
    save = lambda px, path: Image.fromarray(px).save(path, quality=92)
    wnids = [f"n{1000 + i:08d}" for i in range(n_classes)]
    for w in wnids:
        d = os.path.join(root, "train", w, "images")
        os.makedirs(d)
        for k in range(per_class):
            size = 64 if k % 2 == 0 else 48
            save(_image(rng, size, kind), os.path.join(d, f"{w}_{k}.{ext}"))
    vdir = os.path.join(root, "val", "images")
    os.makedirs(vdir)
    with open(os.path.join(root, "val", "val_annotations.txt"), "w") as f:
        for k in range(n_val):
            save(_image(rng, 64, kind), os.path.join(vdir, f"val_{k}.{ext}"))
            f.write(f"val_{k}.{ext}\t{wnids[k % n_classes]}\t0\t0\t63\t63\n")


def _check_tiny_imagenet_folders(root, monkeypatch, fmt, kind):
    _write_tiny_imagenet(root, np.random.default_rng(0), fmt=fmt, kind=kind)
    hits = helpers.native_decode_spy(monkeypatch, tds.native, jds.native)
    t, _ = tds.get_dataset("tiny_imagenet", root, train=True)
    j, _ = jds.get_dataset("tiny_imagenet", root, train=True)
    assert len(t) == len(j) == 15
    np.testing.assert_array_equal(t.labels, j.labels)
    for as_uint8 in (True, False):
        _same_batches(t, j, exact=True, batch_size=4, shuffle=True, seed=1,
                      epoch=2, as_uint8=as_uint8)
    # some image was flipped: the train batches differ from unflipped loads
    flips = list(t.batches(batch_size=15, shuffle=False, seed=0, as_uint8=True))
    plain = tds.StreamingImageFolder(os.path.join(root, "train"), 64, train=False)
    assert not np.array_equal(flips[0][0],
                              next(plain.batches(batch_size=15, shuffle=False,
                                                 seed=0, as_uint8=True))[0])
    tv, _ = tds.get_dataset("tiny_imagenet", root, train=False)
    jv, _ = jds.get_dataset("tiny_imagenet", root, train=False)
    assert len(tv) == len(jv) == 7
    _same_batches(tv, jv, exact=True, batch_size=3, shuffle=False, seed=0,
                  drop_last=False, as_uint8=True)
    # the val split is an ArrayDataset: its float32 conversion differs by an
    # ulp at most (see _same_batches), whatever decoded it
    _same_batches(tv, jv, batch_size=3, shuffle=False, seed=0, drop_last=False,
                  as_uint8=False)
    # JPEGs: both sides took libjpeg (train batches and the val chunk); PNGs:
    # both fell back to PIL
    delivered = [h[0] for h in hits]
    if fmt == "jpeg":
        assert min(delivered) >= 7, hits
    else:
        assert delivered == [0, 0], hits


def test_tiny_imagenet_folders_match(tmp_path, monkeypatch):
    """Tiny-ImageNet folders, train (hflip; uint8 and float32) and the raw
    val split (uint8), equal the JAX package's bit for bit: PNGs through PIL on both
    sides, and quality-92 JPEGs of smooth gradients and of noise through
    both packages' libjpeg decoders (PIL's own libjpeg rounds elsewhere:
    65-74% of values a grey level or more apart)."""
    pytest.importorskip("PIL")
    for fmt, kind in (("png", "noise"), ("jpeg", "smooth"), ("jpeg", "noise")):
        with monkeypatch.context() as mp:
            _check_tiny_imagenet_folders(str(tmp_path / f"{fmt}_{kind}"), mp, fmt, kind)


def test_unported_loaders_raise(tmp_path):
    """ImageNet folders are ported: get_dataset routes them to
    StreamingImageFolder (train RandomResizedCrop, eval the centre box of
    Resize(round(S 256 / 224)) + CenterCrop(S)), as the JAX package; an
    unknown dataset name raises, as in the JAX package."""
    from PIL import Image
    for split in ("train", "val"):
        d = tmp_path / split / "n001"
        d.mkdir(parents=True)
        Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(d / "a.JPEG")
    for size in (None, 128, 288):
        for train in (True, False):
            t, tspec = tds.get_dataset("imagenet", str(tmp_path), train=train,
                                       image_size=size)
            j, jspec = jds.get_dataset("imagenet", str(tmp_path), train=train,
                                       image_size=size)
            assert isinstance(t, tds.StreamingImageFolder)
            assert tspec == tds.DatasetSpec(**vars(jspec))
            for key in ("image_size", "train", "train_mode", "eval_resize",
                        "eval_crop", "class_to_idx"):
                assert getattr(t, key) == getattr(j, key), key
            np.testing.assert_array_equal(t.paths, j.paths)
    assert t.eval_resize == 329 and t.eval_crop == 288
    for get in (tds.get_dataset, jds.get_dataset):
        with pytest.raises(KeyError):
            get("svhn", str(tmp_path), train=True)


@pytest.mark.parametrize("epoch", [0, 24, 25, 26, 37, 38, 49])
def test_schedules_match(epoch):
    assert tsched.piecewise_50_75(0.1, epoch, 50) == jsched.piecewise_50_75(0.1, epoch, 50)
    assert tsched.step30(0.1, epoch) == jsched.step30(0.1, epoch)
    assert (tsched.multistep(0.1, epoch, (25, 38))
            == jsched.multistep(0.1, epoch, (25, 38)))


def test_meter_strings_match():
    meters = []
    for mod in (tmeters, jmeters):
        ms = [mod.AverageMeter() for _ in range(5)]
        for i, m in enumerate(ms):
            m.update(0.5 + i, 3)
            m.update(1.25 * i, 2)
        meters.append(ms)
    (tm, jm) = meters
    assert (tmeters.train_line(2, 7, 100, *tm)
            == jmeters.train_line(2, 7, 100, *jm))
    assert tmeters.clean_summary(tm[3], tm[4]) == jmeters.clean_summary(jm[3], jm[4])
    assert tmeters.adv_summary(tm[3], tm[4]) == jmeters.adv_summary(jm[3], jm[4])


def test_load_config_matches():
    over = dict(data="synthetic", batch_size=4, lr=None, epochs=2, gf=True)
    t = tcfg.load_config(CONFIG, over)
    j = jcfg.load_config(CONFIG, over)
    assert dict(t) == dict(j)
    assert t.batch_size == 4 and t.lr == 0.1 and t.gf is True
    assert t.num_classes == 200 and t.lr_schedule == "piecewise_50_75"
    args = tcfg.base_parser("port").parse_args(
        ["--config", CONFIG, "--batch-size", "8", "--limit-batches", "2"])
    jargs = jcfg.base_parser().parse_args(
        ["--config", CONFIG, "--batch-size", "8", "--limit-batches", "2"])
    for k, v in vars(args).items():
        assert getattr(jargs, k) == v, k

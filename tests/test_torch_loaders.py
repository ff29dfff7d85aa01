"""The port's MNIST and CIFAR-100 loaders and the CIFAR augmentation
(data/datasets.py) against the JAX package's: idx files (plain and .gz)
and a CIFAR pickle that the test writes, read by both; the batches of an
augmented epoch; cifar_augment on the same numpy stream."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import gzip
import pickle
import struct

import numpy as np
import pytest

from edge_enhancement_tpu.data import datasets as jdata
from edge_enhancement_tpu.data import native
from edge_enhancement_tpu_torch.data import datasets as tdata


def _write_idx(path, arr, gz):
    payload = struct.pack(">HBB", 0, 8, arr.ndim)
    payload += struct.pack(">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


def _assert_same_batches(a, b, **kw):
    got, want = list(a.batches(**kw)), list(b.batches(**kw))
    assert len(got) == len(want) > 0
    for (x, y), (xj, yj) in zip(got, want):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("layout", ["plain", "gz", "MNIST/raw"])
def test_mnist_idx_files(tmp_path, layout):
    rng = np.random.default_rng(0)
    root = tmp_path
    base = root / "MNIST" / "raw" if layout == "MNIST/raw" else root
    base.mkdir(parents=True, exist_ok=True)
    suffix = ".gz" if layout == "gz" else ""
    for split, n in (("train", 12), ("t10k", 6)):
        _write_idx(str(base / f"{split}-images-idx3-ubyte{suffix}"),
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), layout == "gz")
        _write_idx(str(base / f"{split}-labels-idx1-ubyte{suffix}"),
                   rng.integers(0, 10, n, dtype=np.uint8), layout == "gz")
    for train in (True, False):
        ds, spec = tdata.get_dataset("mnist", str(root), train=train)
        ds_j, _ = jdata.get_dataset("mnist", str(root), train=train)
        assert spec.channels == 1 and ds.images.shape == ((12 if train else 6), 28, 28, 1)
        assert ds.augment is None
        _assert_same_batches(ds, ds_j, batch_size=4, shuffle=train, seed=1, epoch=2,
                             as_uint8=True)
    with pytest.raises(FileNotFoundError):
        tdata.load_mnist(str(tmp_path / "absent"), True)


def test_cifar100_pickle_and_augmented_epoch(tmp_path):
    """The pickled train/test batches (fine labels, NCHW rows -> NHWC);
    the train split's epoch with cifar_augment equals JAX's batch for
    batch, the test split's is not augmented."""
    rng = np.random.default_rng(1)
    root = tmp_path / "cifar-100-python"
    root.mkdir()
    for split, n in (("train", 20), ("test", 8)):
        d = {b"data": rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
             b"fine_labels": list(rng.integers(0, 100, n)),
             b"coarse_labels": list(rng.integers(0, 20, n))}
        with open(root / split, "wb") as f:
            pickle.dump(d, f)
    for train in (True, False):
        ds, spec = tdata.get_dataset("cifar100", str(tmp_path), train=train)
        ds_j, _ = jdata.get_dataset("cifar100", str(tmp_path), train=train)
        if train:
            ds_train, ds_train_j = ds, ds_j
        assert spec.num_classes == 100 and (ds.augment is not None) == train
        np.testing.assert_array_equal(ds.images, ds_j.images)
        _assert_same_batches(ds, ds_j, batch_size=8, shuffle=True, seed=3, epoch=1,
                             as_uint8=True)
    # float batches of the augmented split: both divide the uint8 pixels by
    # 255 (JAX's unaugmented float path is a native reciprocal product)
    _assert_same_batches(ds_train, ds_train_j, batch_size=8, shuffle=True, seed=3, epoch=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_cifar_augment_matches_jax(seed):
    """The same draws in JAX's order (crop offsets, flips, angles) and the
    rotation in the native runtime's float32 arithmetic with FMA
    contraction: measured exact on 256 images of each seed (and 1 pixel
    in 6.1 million on a larger set, where the native code sums in another
    order). Limit: 1e-5 of the pixels, by one grey level."""
    if native._load() is None:
        pytest.fail("the JAX package's native runtime (runtime/libeedata.so) did not build")
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (256, 32, 32, 3), dtype=np.uint8)
    # half the images piecewise constant: bilinear taps of equal values
    imgs[:128] = np.repeat(np.repeat(rng.integers(0, 256, (128, 8, 8, 3), dtype=np.uint8),
                                     4, 1), 4, 2)
    got = tdata.cifar_augment(imgs.copy(), np.random.default_rng(seed + 10))
    want = jdata.cifar_augment(imgs.copy(), np.random.default_rng(seed + 10))
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5, (diff.max(), (diff > 0).mean())
    # each step alone: the crop and the flip exactly
    oy, ox = rng.integers(0, 9, 256), rng.integers(0, 9, 256)
    np.testing.assert_array_equal(tdata.pad_crop(imgs, 4, oy, ox),
                                  native.pad_crop(imgs, 4, oy, ox))
    # a zero angle returns the image, the corners of a rotated one are zero
    np.testing.assert_array_equal(tdata.rotate(imgs[:4], np.zeros(4, np.float32)), imgs[:4])
    assert not tdata.rotate(imgs[:4], np.full(4, 15.0, np.float32))[:, 0, 0].any()

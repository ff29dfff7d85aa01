"""Datasets the port's driver reads, as edge_enhancement_tpu/data/datasets.py:
the synthetic sets, and Tiny-ImageNet image folders decoded with PIL.

Batches are NHWC, uint8 or float32 in [0, 1] (no normalisation), in the
same order and with the same augmentation draws as the JAX package for a
given (seed, epoch): both consume one numpy stream the same way. Tiny-
ImageNet trains with hflip only and reads its validation split either as
class folders or in the raw val/images + val_annotations.txt layout.
MNIST, CIFAR-100 and ImageNet folders are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    name: str
    image_size: int
    channels: int
    num_classes: int
    train_size: int
    eval_size: int


SPECS = {
    "mnist": DatasetSpec("mnist", 28, 1, 10, 60000, 10000),
    "cifar100": DatasetSpec("cifar100", 32, 3, 100, 50000, 10000),
    "tiny_imagenet": DatasetSpec("tiny_imagenet", 64, 3, 200, 100000, 10000),
    "imagenet": DatasetSpec("imagenet", 224, 3, 1000, 1281167, 50000),
}

_IMAGE_EXTS = (".jpeg", ".jpg", ".png")


def _index_order(n: int, shuffle: bool, seed: int, epoch: int):
    """The (rng, index order) of one epoch, the JAX package's stream."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng, (rng.permutation(n) if shuffle else np.arange(n))


def _batch_starts(n: int, batch_size: int, drop_last: bool) -> range:
    stop = (n // batch_size) * batch_size if drop_last else n
    return range(0, stop, batch_size)


def _hflip(imgs: np.ndarray, flags: np.ndarray) -> np.ndarray:
    sel = flags.astype(bool)
    imgs[sel] = imgs[sel, :, ::-1]
    return imgs


class ArrayDataset:
    """Images (N, H, W, C) uint8 and labels (N,) int32 in memory."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be (N, H, W, C) uint8, got "
                             f"{images.dtype} {images.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size: int, *, shuffle: bool, seed: int,
                epoch: int = 0, drop_last: bool = True,
                as_uint8: bool = False
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield NHWC batches: float32 in [0, 1], or the raw uint8 pixels."""
        _, idx = _index_order(len(self), shuffle, seed, epoch)
        for s in _batch_starts(len(idx), batch_size, drop_last):
            take = idx[s:s + batch_size].astype(np.int64)
            imgs = self.images[take]
            if not as_uint8:
                imgs = imgs.astype(np.float32) / 255.0
            yield imgs, self.labels[take]


# --------------------------------------------------------------------------
# Tiny-ImageNet folders
# --------------------------------------------------------------------------

def _load_rgb(path: str, size: int) -> np.ndarray:
    """One image file as (size, size, 3) uint8, bilinear-resized when it is
    not already that size (Tiny-ImageNet ships at 64 x 64)."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _class_index(root: str) -> dict:
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    return {c: i for i, c in enumerate(classes)}


class ImageFolder:
    """root/<class>/**/*.{JPEG,jpg,png}, decoded batch by batch from disk.
    Train mode flips each image with probability 0.5, the draws taken from
    a numpy generator per batch, seeded (seed, epoch, 17, batch start) as
    the JAX package does."""

    def __init__(self, root: str, image_size: int, train: bool):
        self.image_size = int(image_size)
        self.train = train
        class_to_idx = _class_index(root)
        paths, labels = [], []
        for c in sorted(class_to_idx):
            for dirpath, _, files in os.walk(os.path.join(root, c)):
                for fn in sorted(files):
                    if fn.lower().endswith(_IMAGE_EXTS):
                        paths.append(os.path.join(dirpath, fn))
                        labels.append(class_to_idx[c])
        self.paths = np.asarray(paths)
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.paths)

    def batches(self, batch_size: int, *, shuffle: bool, seed: int,
                epoch: int = 0, drop_last: bool = True,
                as_uint8: bool = False
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        _, idx = _index_order(len(self), shuffle, seed, epoch)
        for s in _batch_starts(len(idx), batch_size, drop_last):
            take = idx[s:s + batch_size].astype(np.int64)
            imgs = np.stack([_load_rgb(p, self.image_size)
                             for p in self.paths[take]])
            if self.train:
                rng = np.random.default_rng(
                    np.random.SeedSequence([seed, epoch, 17, s]))
                imgs = _hflip(imgs, rng.random(len(take)) < 0.5)
            if not as_uint8:
                imgs = imgs.astype(np.float32) / 255.0
            yield imgs, self.labels[take]


def load_tiny_imagenet_val(root: str, image_size: int) -> ArrayDataset:
    """The raw val split: val/images/* labelled by val_annotations.txt
    (tab-separated filename, wnid, ...), indexed by the train split's
    classes."""
    class_to_idx = _class_index(os.path.join(root, "train"))
    val_dir = os.path.join(root, "val")
    ann = {}
    with open(os.path.join(val_dir, "val_annotations.txt")) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                ann[parts[0]] = class_to_idx[parts[1]]
    img_dir = os.path.join(val_dir, "images")
    names = [fn for fn in sorted(os.listdir(img_dir)) if fn in ann]
    images = np.empty((len(names), image_size, image_size, 3), np.uint8)
    for i, fn in enumerate(names):
        images[i] = _load_rgb(os.path.join(img_dir, fn), image_size)
    return ArrayDataset(images, np.asarray([ann[fn] for fn in names]))


# --------------------------------------------------------------------------
# Synthetic data
# --------------------------------------------------------------------------

def synthetic_dataset(spec: DatasetSpec, n: int, seed: int = 0) -> ArrayDataset:
    """Class-conditional structured images (a blob placed by label over
    noise), so that training reduces the loss and the edge ops see
    structure."""
    rng = np.random.default_rng(seed)
    h = spec.image_size
    imgs = np.zeros((n, h, h, spec.channels), np.uint8)
    labels = rng.integers(0, spec.num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:h]
    for i in range(n):
        lab = labels[i]
        cy = (lab * 7919 % (h - 8)) + 4
        cx = (lab * 104729 % (h - 8)) + 4
        r = 3 + lab % 5
        blob = ((np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)).astype(np.float32)
        noise = rng.random((h, h)) * 0.3
        img = np.clip(blob * 0.7 + noise, 0, 1)
        for c in range(spec.channels):
            imgs[i, :, :, c] = (img * 255).astype(np.uint8)
    return ArrayDataset(imgs, labels)


def synthetic_hard_images(n: int, seed: int, h: int = 64
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The non-saturating synthetic Tiny-ImageNet task: 10 of the labels
    carry a colour block whose contrast a ~ U(0.05, 0.50) is added over
    background noise U(0, 0.45), with +-6 px jitter and the class colour
    mixed 65/35 with a random other class's colour."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 10, n).astype(np.int64)
    g = h // 64 or 1
    centers = [((14 + 18 * (c // 4)) * h // 64, (12 + 13 * (c % 4)) * h // 64)
               for c in range(10)]
    colors = np.asarray(
        [(1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.3, 0.3, 1.0),
         (1.0, 1.0, 0.3), (1.0, 0.3, 1.0), (0.3, 1.0, 1.0),
         (1.0, 0.7, 0.3), (0.7, 0.3, 1.0), (0.3, 0.7, 0.7),
         (0.9, 0.9, 0.9)], np.float32)
    blk = 24 * h // 64
    xs = rng.uniform(0.0, 0.45, (n, h, h, 3)).astype(np.float32)
    for i in range(n):
        c = int(ys[i])
        cy, cx = centers[c]
        cy += rng.integers(-6, 7) * g
        cx += rng.integers(-6, 7) * g
        y0, x0 = max(cy - blk // 2, 0), max(cx - blk // 2, 0)
        a = rng.uniform(0.05, 0.50)
        col = (0.65 * colors[c]
               + 0.35 * colors[(c + 1 + rng.integers(0, 9)) % 10])
        bh = min(h - y0, blk)
        bw = min(h - x0, blk)
        xs[i, y0:y0 + bh, x0:x0 + bw] = np.clip(
            xs[i, y0:y0 + bh, x0:x0 + bw] + a * col, 0.0, 1.0)
    return (xs * 255).astype(np.uint8), ys.astype(np.int32)


def synthetic_hard_dataset(spec: DatasetSpec, n: int, seed: int = 0
                           ) -> ArrayDataset:
    if spec.channels != 3 or spec.num_classes < 10:
        raise ValueError("synthetic-hard is an RGB task of at least 10 classes")
    return ArrayDataset(*synthetic_hard_images(n, seed, h=spec.image_size))


def get_dataset(name: str, root: Optional[str], train: bool,
                synthetic_size: Optional[int] = None,
                image_size: Optional[int] = None):
    """(dataset, spec); `image_size` overrides the dataset's native size."""
    spec = SPECS[name]
    if image_size and image_size != spec.image_size:
        spec = dataclasses.replace(spec, image_size=int(image_size))
    if root in (None, "synthetic"):
        n = synthetic_size or (512 if train else 256)
        return synthetic_dataset(spec, n, seed=0 if train else 1), spec
    if root == "synthetic-hard":
        n = synthetic_size or (100000 if train else 10000)
        return synthetic_hard_dataset(spec, n, seed=0 if train else 1), spec
    if name != "tiny_imagenet":
        raise NotImplementedError(f"the {name} loader is not ported yet")
    sub = os.path.join(root, "train" if train else "val")
    if not train and os.path.exists(os.path.join(sub, "val_annotations.txt")):
        return load_tiny_imagenet_val(root, spec.image_size), spec
    return ImageFolder(sub, spec.image_size, train=train), spec

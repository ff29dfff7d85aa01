"""Datasets the port's driver reads, as edge_enhancement_tpu/data/datasets.py:
the synthetic sets, MNIST's idx files (plain or .gz), CIFAR-100's pickle
batches, and the Tiny-ImageNet and ImageNet image folders.

Batches are NHWC, uint8 or float32 in [0, 1] (no normalisation), in the
same order and with the same augmentation draws as the JAX package for a
given (seed, epoch): both consume one numpy stream the same way. MNIST
trains without augmentation; CIFAR-100 with the pad-4 random crop, hflip
and a random rotation of up to 15 degrees (`cifar_augment`, in numpy, in
the arithmetic of the JAX package's native runtime). The image folders
stream from disk (`StreamingImageFolder`), their JPEGs decoded by the
port's copy of that runtime's decoder (data/native.py: the system's
libjpeg, else the one PIL bundles), else by PIL: Tiny-ImageNet with hflip only, its validation split read either as
class folders or in the raw val/images + val_annotations.txt layout;
ImageNet with RandomResizedCrop + hflip in training and the centre box of
Resize(256) + CenterCrop(224), scaled with the image size, in evaluation.
"""

from __future__ import annotations

import dataclasses
import gzip
import math
import os
import pickle
import struct
import threading
from typing import Iterator, Optional

import numpy as np

from . import native


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


def _index_order(n: int, shuffle: bool, seed: int, epoch: int,
                 process_index: int = 0, process_count: int = 1):
    """The (rng, index order) of one epoch, the JAX package's stream: with
    several processes the order is cut to a multiple of their count (every
    process must yield as many batches, or the collectives wait forever)
    and process p takes every process_count-th index from p."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    idx = rng.permutation(n) if shuffle else np.arange(n)
    if process_count > 1:
        idx = idx[:n - (n % process_count)]
    return rng, idx[process_index::process_count]


def _batch_starts(n: int, batch_size: int, drop_last: bool) -> range:
    stop = (n // batch_size) * batch_size if drop_last else n
    return range(0, stop, batch_size)


def _hflip(imgs: np.ndarray, flags: np.ndarray) -> np.ndarray:
    sel = flags.astype(bool)
    imgs[sel] = imgs[sel, :, ::-1]
    return imgs


class ArrayDataset:
    """Images (N, H, W, C) uint8 and labels (N,) int32 in memory;
    `augment(imgs, rng)`, where given, transforms each gathered uint8 batch
    with the epoch's numpy generator (the one that shuffled it)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, augment=None):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be (N, H, W, C) uint8, got "
                             f"{images.dtype} {images.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.augment = augment

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size: int, *, shuffle: bool, seed: int,
                epoch: int = 0, drop_last: bool = True,
                process_index: int = 0, process_count: int = 1,
                as_uint8: bool = False
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield NHWC batches: float32 in [0, 1], or the raw uint8 pixels;
        of `batch_size` rows of process `process_index`'s share (each of
        `process_count` processes loads its own rows, the augmentation
        drawing from the stream that shuffled them)."""
        rng, idx = _index_order(len(self), shuffle, seed, epoch,
                                process_index, process_count)
        for s in _batch_starts(len(idx), batch_size, drop_last):
            take = idx[s:s + batch_size].astype(np.int64)
            imgs = self.images[take]
            if self.augment is not None:
                imgs = self.augment(imgs, rng)
            if not as_uint8:
                imgs = imgs.astype(np.float32) / 255.0
            yield imgs, self.labels[take]


# --------------------------------------------------------------------------
# CIFAR augmentation
# --------------------------------------------------------------------------

def pad_crop(imgs: np.ndarray, pad: int, oy: np.ndarray, ox: np.ndarray) -> np.ndarray:
    """Zero-pad each image by `pad` and crop its own size at (oy, ox), as
    torchvision's RandomCrop(size, padding=pad)."""
    n, h, w, _ = imgs.shape
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.empty_like(imgs)
    for i in range(n):
        out[i] = padded[i, oy[i]:oy[i] + h, ox[i]:ox[i] + w]
    return out


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the product is exact in float64."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def rotate(imgs: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate each image by angles[i] degrees about its centre, bilinear,
    zero fill (torchvision's RandomRotation, expand=False), in float32 as
    the JAX package's native ee_rotate_bilinear computes it with FMA
    contraction: source coordinates sy = fma(sin, dx, cos dy) + cy and
    sx = fma(cos, dx, -sin dy) + cx; the four taps summed as
    fma(v11 ... fma(v10 ..., fma(v00 (1 - fy), 1 - fx, v01 (1 - fy) fx)));
    + 0.5, truncated to uint8."""
    f32 = np.float32
    n, h, w, _ = imgs.shape
    cy, cx = f32((h - 1) * 0.5), f32((w - 1) * 0.5)
    yy, xx = np.mgrid[0:h, 0:w]
    dy, dx = yy.astype(f32) - cy, xx.astype(f32) - cx
    out = np.zeros_like(imgs)
    one = f32(1.0)
    for i in range(n):
        a = f32(angles[i]) * f32(math.pi) / f32(180.0)
        ca, sa = f32(math.cos(a)), f32(math.sin(a))
        sy = _fma(sa, dx, ca * dy) + cy
        sx = _fma(ca, dx, -sa * dy) + cx
        inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
        y0 = np.where(inside, sy, 0).astype(np.int64)
        x0 = np.where(inside, sx, 0).astype(np.int64)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        fy = (sy - y0.astype(f32))[..., None]
        fx = (sx - x0.astype(f32))[..., None]
        src = imgs[i].astype(f32)
        top, bottom = one - fy, fy
        acc = (src[y0, x1] * top) * fx
        acc = _fma(src[y0, x0] * top, one - fx, acc)
        acc = _fma(src[y1, x0] * bottom, one - fx, acc)
        acc = _fma(src[y1, x1] * bottom, fx, acc)
        v = np.clip(acc + f32(0.5), 0.0, 255.0).astype(np.uint8)
        out[i] = np.where(inside[..., None], v, 0)
    return out


def cifar_augment(imgs: np.ndarray, rng) -> np.ndarray:
    """RandomCrop(32, padding=4), hflip, RandomRotation(15), the draws taken
    in the JAX package's order: the crop offsets oy then ox, the flips,
    the angles."""
    n = len(imgs)
    oy = rng.integers(0, 9, size=n).astype(np.int32)
    ox = rng.integers(0, 9, size=n).astype(np.int32)
    out = pad_crop(imgs, 4, oy, ox)
    out = _hflip(out, rng.random(n) < 0.5)
    angles = rng.uniform(-15, 15, size=n).astype(np.float32)
    return rotate(out, angles)


# --------------------------------------------------------------------------
# MNIST and CIFAR-100 files
# --------------------------------------------------------------------------

def read_idx(path: str) -> np.ndarray:
    """An idx file (MNIST's format; gzip-compressed when it ends in .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(root: str, train: bool) -> ArrayDataset:
    """{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz] under root,
    root/MNIST/raw or root/raw."""
    split = "train" if train else "t10k"
    for base in (root, os.path.join(root, "MNIST", "raw"), os.path.join(root, "raw")):
        img_p = os.path.join(base, f"{split}-images-idx3-ubyte")
        lab_p = os.path.join(base, f"{split}-labels-idx1-ubyte")
        for suffix in ("", ".gz"):
            if os.path.exists(img_p + suffix):
                return ArrayDataset(read_idx(img_p + suffix)[..., None],
                                    read_idx(lab_p + suffix))
    raise FileNotFoundError(f"MNIST idx files not found under {root!r}")


def load_cifar100(root: str, train: bool) -> ArrayDataset:
    """The pickled `train` / `test` batch under root or
    root/cifar-100-python: fine labels; the train split augmented."""
    base = (root if os.path.exists(os.path.join(root, "train"))
            else os.path.join(root, "cifar-100-python"))
    with open(os.path.join(base, "train" if train else "test"), "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()
    return ArrayDataset(imgs, np.asarray(d[b"fine_labels"]),
                        augment=cifar_augment if train else None)


# --------------------------------------------------------------------------
# Image folders (Tiny-ImageNet, ImageNet)
# --------------------------------------------------------------------------

def _class_index(root: str) -> dict:
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    return {c: i for i, c in enumerate(classes)}


def _pil_decode(path: str, size: int) -> np.ndarray:
    """One image file as (size, size, 3) uint8 through PIL, bilinear-resized
    when it is not already that size."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _decode_files_to_array(paths: list, image_size: int) -> np.ndarray:
    """Image files as one (N, S, S, 3) uint8 array: chunks of 8192 JPEGs
    through the native decoder; a chunk it cannot take (a PNG, a file that
    fails, no libjpeg: neither the system's nor PIL's) through PIL, file by
    file."""
    out = np.empty((len(paths), image_size, image_size, 3), np.uint8)
    chunk = 8192
    for lo in range(0, len(paths), chunk):
        sub = paths[lo:lo + chunk]
        got = None
        if all(p.lower().endswith((".jpeg", ".jpg")) for p in sub):
            got = native.stream_decode_files(
                sub, mode=0, draws=None, eval_resize=0, eval_crop=0,
                oh=image_size, ow=image_size, flip_flags=None)
        if got is not None:
            out[lo:lo + len(sub)] = got
            continue
        for i, p in enumerate(sub):
            out[lo + i] = _pil_decode(p, image_size)
    return out


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
    images = _decode_files_to_array([os.path.join(img_dir, fn) for fn in names],
                                    image_size)
    return ArrayDataset(images, np.asarray([ann[fn] for fn in names]))


def _round_half_away(v: float) -> int:
    """Round half away from zero (C++'s lround), not Python's half to even."""
    return int(np.floor(v + 0.5))


def rrc_box_from_draws(draws: np.ndarray, h: int, w: int) -> tuple[int, int, int, int]:
    """One torchvision RandomResizedCrop box (scale 0.08-1.0, ratio 3/4-4/3,
    10 tries then the centre square) in original-image coordinates, from 40
    uniforms (10 tries x {scale, log-ratio, y, x}), as csrc/eedata.cpp's
    rrc_box computes it: (by, bx, bh, bw)."""
    area = h * w
    lr_lo, lr_hi = np.log(3 / 4), np.log(4 / 3)
    for t in range(10):
        target_area = (0.08 + float(draws[t * 4]) * 0.92) * area
        ratio = np.exp(lr_lo + float(draws[t * 4 + 1]) * (lr_hi - lr_lo))
        bw = _round_half_away(np.sqrt(target_area * ratio))
        bh = _round_half_away(np.sqrt(target_area / ratio))
        if 0 < bw <= w and 0 < bh <= h:
            by = int(float(draws[t * 4 + 2]) * (h - bh + 1))
            bx = int(float(draws[t * 4 + 3]) * (w - bw + 1))
            return by, bx, bh, bw
    s = min(h, w)
    return (h - s) // 2, (w - s) // 2, s, s


def _eval_center_box(h: int, w: int, resize_to: int = 256,
                     crop: int = 224) -> tuple[int, int, int, int]:
    """Resize(short=resize_to) + CenterCrop(crop) as one box of the
    original image: a centred square of (crop / resize_to) x the short
    side, resampled once (csrc/eedata.cpp's center_box)."""
    s = min(h, w)
    side = max(1, _round_half_away(s * crop / float(resize_to)))
    return (h - side) // 2, (w - side) // 2, side, side


class StreamingImageFolder:
    """root/<class>/**/*.{JPEG,jpg,png} streamed from disk: only the paths
    and labels live in memory, and each batch is read, decoded, cropped
    and resized on demand by the native decoder (data/native.py), one
    batch ahead on a thread. Train mode `rrc`: RandomResizedCrop from the
    original resolution, then hflip (ImageNet); `hflip`: the full image
    resized, then hflip (Tiny-ImageNet). Eval: the centre box of
    Resize(eval_resize) + CenterCrop(eval_crop) where eval_resize is set,
    else the full image resized. Every draw of a batch is made up front
    from its own generator, seeded (seed, epoch, 17, batch start): the 40
    RRC uniforms of each image, then the flips. Where the native decoder
    cannot take a batch (a CMYK JPEG, a PNG, a file that fails; no
    libjpeg, neither the system's nor the one PIL bundles, which
    native.find_libjpeg tries in that order), PIL decodes the whole batch
    from the same draws."""

    def __init__(self, root: str, image_size: int, train: bool,
                 class_to_idx: Optional[dict] = None,
                 eval_resize: Optional[int] = None,
                 eval_crop: Optional[int] = None,
                 train_mode: str = "rrc"):
        if train_mode not in ("rrc", "hflip"):
            raise ValueError(f"train_mode must be rrc or hflip, got {train_mode!r}")
        self.root = root
        self.image_size = int(image_size)
        self.train = train
        self.train_mode = train_mode
        self.eval_resize, self.eval_crop = eval_resize, eval_crop
        if class_to_idx is None:
            class_to_idx = _class_index(root)
        self.class_to_idx = class_to_idx
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

    def _load_batch(self, take: np.ndarray, rng,
                    as_uint8: bool = False) -> tuple[np.ndarray, np.ndarray]:
        size = self.image_size
        n = len(take)
        paths = self.paths[take]
        rrc = self.train and self.train_mode == "rrc"
        draws = rng.random((n, 40)).astype(np.float32) if rrc else None
        flips = (rng.random(n) < 0.5).astype(np.uint8) if self.train else None
        if rrc:
            mode = 1
        elif not self.train and self.eval_resize:
            mode = 2
        else:
            mode = 0
        crop = self.eval_crop or size
        imgs = native.stream_decode_files(
            paths, mode, draws, self.eval_resize, crop, size, size, flips,
            dtype=np.uint8 if as_uint8 else np.float32)
        if imgs is not None:
            return imgs, self.labels[take]
        imgs = np.empty((n, size, size, 3), np.uint8)
        for i, p in enumerate(paths):
            imgs[i] = self._pil_crop(p, mode, None if draws is None else draws[i],
                                     crop)
        if flips is not None:
            imgs = _hflip(imgs, flips)
        if not as_uint8:
            imgs = imgs.astype(np.float32) / 255.0
        return imgs, self.labels[take]

    def _pil_crop(self, path: str, mode: int, draws, crop: int) -> np.ndarray:
        """One image through PIL: the box of `mode` cropped, then resized
        with BILINEAR."""
        from PIL import Image
        size = self.image_size
        with Image.open(path) as im:
            im = im.convert("RGB")
            h, w = im.height, im.width
            if mode == 1:
                by, bx, bh, bw = rrc_box_from_draws(draws, h, w)
            elif mode == 2:
                by, bx, bh, bw = _eval_center_box(h, w, self.eval_resize, crop)
            else:
                by, bx, bh, bw = 0, 0, h, w
            return np.asarray(im.crop((bx, by, bx + bw, by + bh)).resize(
                (size, size), Image.BILINEAR))

    def batches(self, batch_size: int, *, shuffle: bool, seed: int,
                epoch: int = 0, drop_last: bool = True,
                process_index: int = 0, process_count: int = 1,
                as_uint8: bool = False
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """ArrayDataset.batches's contract, streamed from disk with one
        batch of lookahead: a thread loads batch i + 1 while the caller
        holds batch i, and an exception it meets is raised here."""
        _, idx = _index_order(len(self), shuffle, seed, epoch,
                              process_index, process_count)
        starts = list(_batch_starts(len(idx), batch_size, drop_last))
        if not starts:
            return
        slot = {}

        def produce(s):
            try:
                rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 17, s]))
                slot[s] = self._load_batch(idx[s:s + batch_size].astype(np.int64),
                                           rng, as_uint8=as_uint8)
            except BaseException as e:  # noqa: BLE001  (raised in the consumer)
                slot[s] = e

        thread = threading.Thread(target=produce, args=(starts[0],))
        thread.start()
        for i, s in enumerate(starts):
            thread.join()
            if i + 1 < len(starts):
                thread = threading.Thread(target=produce, args=(starts[i + 1],))
                thread.start()
            item = slot.pop(s)
            if isinstance(item, BaseException):
                raise item
            yield item


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
    if name == "mnist":
        return load_mnist(root, train), spec
    if name == "cifar100":
        return load_cifar100(root, train), spec
    sub = os.path.join(root, "train" if train else "val")
    if (not train and name == "tiny_imagenet"
            and os.path.exists(os.path.join(sub, "val_annotations.txt"))):
        return load_tiny_imagenet_val(root, spec.image_size), spec
    if name == "tiny_imagenet":
        return StreamingImageFolder(sub, spec.image_size, train=train,
                                    train_mode="hflip"), spec
    if train:
        return StreamingImageFolder(sub, spec.image_size, train=True), spec
    # Resize(256) + CenterCrop(224), scaled with the size (fast-AT's cize)
    return StreamingImageFolder(sub, spec.image_size, train=False,
                                eval_resize=int(round(spec.image_size * 256 / 224)),
                                eval_crop=spec.image_size), spec

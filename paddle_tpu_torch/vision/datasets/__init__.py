"""Built-in datasets (counterpart: ``paddle_tpu/vision/datasets``).

Nothing is downloaded. ``MNIST`` (and ``FashionMNIST``, the same class)
reads local IDX files (gzip) when given them; otherwise each dataset builds
the reference's seeded synthetic set (``.synthetic`` True), the same arrays
as the reference's: MNIST 4096 images of 28 x 28 with a class-dependent
bar; ``Cifar10`` 1024 uint8 HWC images of 32 x 32 x 3 with the label's
channel halved, ``Cifar100`` the same images with labels of 100 classes.
Items are numpy: the image (a float32 CHW array in [0, 1], or
``transform(image)``) and an int64 label.
"""
import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"]


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        self.synthetic = True
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    num, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), dtype=np.uint8)
            self.synthetic = False
            return
        n = 60000 if mode == "train" else 10000
        rng = np.random.RandomState(42 if mode == "train" else 7)
        n = min(n, 4096)
        self.labels = rng.randint(0, 10, size=n).astype(np.int64)
        self.images = np.zeros((n, 28, 28), dtype=np.uint8)
        for i, label in enumerate(self.labels):
            img = rng.randint(0, 50, size=(28, 28))
            img[2 + label * 2: 6 + label * 2, 4:24] += 180
            self.images[i] = np.clip(img, 0, 255)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0)[None, :, :]
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.transform = transform
        self.synthetic = True
        n = 1024
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.labels = rng.randint(0, 10, size=n).astype(np.int64)
        self.images = rng.randint(0, 255, size=(n, 32, 32, 3)).astype(
            np.uint8)
        for i, label in enumerate(self.labels):
            self.images[i, :, :, label % 3] //= 2

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.RandomState(2)
        self.labels = rng.randint(0, 100, size=len(self.labels)).astype(
            np.int64)

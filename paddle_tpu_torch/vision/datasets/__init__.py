"""MNIST (counterpart: ``paddle_tpu/vision/datasets``).

Nothing is downloaded. Given the local IDX files (gzip), the dataset reads
them; otherwise it builds the reference's seeded synthetic set (4096 train
or 4096 test images with a class-dependent bar, ``.synthetic`` True), the
same arrays as the reference's. Items are numpy: a float32 ``[1, 28, 28]``
image in [0, 1] (or ``transform(image)``) and an int64 label. The other
datasets are not ported.
"""
import gzip
import os
import struct

import numpy as np


class MNIST:
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

"""Vision transforms (counterpart: ``paddle_tpu/vision/transforms``).

Host-side numpy preprocessing, in the caller's process or a DataLoader
worker, never on the card: HWC ``uint8`` images in, CHW ``float32`` arrays
out of ``ToTensor``. The random transforms draw from the global
``np.random`` in the reference's order, so one seed (a worker's
``epoch_seed + id``) gives both packages the same crops and flips.

``Resize`` computes what the reference's ``jax.image.resize(...,
method="linear")`` computes: per resized axis a weight matrix of the
triangle kernel at half-pixel centres, widened by the scale when the axis
shrinks (antialiasing), each column normalised to sum 1, in float32; the
axes are contracted one after the other, and the result is cast back to the
input's dtype, which truncates a ``uint8`` image (a pixel whose float sits
on an integer may land one level off the reference's). An image is CHW
when it has three dims, the first 1 or 3 and smaller than the last (the
reference's rule); else HWC, or HW.
"""
import numpy as np

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Transpose", "to_tensor", "normalize",
           "resize"]

_F32_EPS = float(np.finfo(np.float32).eps)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))


class ToTensor(BaseTransform):
    """HWC (or HW) -> float32 CHW; ``uint8`` scaled to [0, 1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return img.astype(np.float32)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


def _linear_weights(in_size, out_size):
    """``[in_size, out_size]`` float32 weights of the antialiased triangle
    kernel (jax's ``compute_weight_mat`` with no translation)."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        chw = (img.ndim == 3 and img.shape[0] in (1, 3)
               and img.shape[0] < img.shape[-1])
        dims = (1, 2) if chw else (0, 1)
        x = img.astype(np.float32)
        for d, n in zip(dims, self.size):
            m = x.shape[d]
            if m == n:
                continue
            w = _linear_weights(m, int(n))
            x = np.moveaxis(np.tensordot(x, w, axes=([d], [0])), -1, d)
        return x.astype(img.dtype, order="C")


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        if self.padding:
            p = self.padding
            img = np.pad(img, [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2))
        h, w = img.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[::-1].copy()
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW"):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)

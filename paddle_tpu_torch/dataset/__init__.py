"""Classic reader-function datasets (counterpart:
``paddle_tpu/dataset/__init__.py``; the reference framework's
`python/paddle/dataset/`: mnist, cifar, imdb, uci_housing, imikolov,
movielens, conll05, wmt14/16).

The fluid-era API: each sub-module has ``train()`` and ``test()``, each
returning a zero-argument reader creator that yields samples. They stand
on the port's ``vision.datasets`` and ``text`` classes, so both API
generations share one corpus (the reference's synthetic one, sample for
sample, where no file is given).
"""
import types as _types

from ..vision import datasets as _vd
from .. import text as _text

__all__ = ["mnist", "cifar", "imdb", "uci_housing", "imikolov",
           "movielens", "conll05", "wmt14", "wmt16"]


def _reader_from(dataset_cls, mode, **kw):
    def creator():
        ds = dataset_cls(mode=mode, **kw)

        def reader():
            for i in range(len(ds)):
                yield ds[i]

        return reader
    return creator


def _module(name, dataset_cls, **kw):
    m = _types.ModuleType(f"{__name__}.{name}")
    m.train = _reader_from(dataset_cls, "train", **kw)
    m.test = _reader_from(dataset_cls, "test", **kw)
    return m


mnist = _module("mnist", _vd.MNIST)
cifar = _types.ModuleType(f"{__name__}.cifar")
cifar.train10 = _reader_from(_vd.Cifar10, "train")
cifar.test10 = _reader_from(_vd.Cifar10, "test")
cifar.train100 = _reader_from(_vd.Cifar100, "train")
cifar.test100 = _reader_from(_vd.Cifar100, "test")
imdb = _module("imdb", _text.Imdb)
uci_housing = _module("uci_housing", _text.UCIHousing)
imikolov = _module("imikolov", _text.Imikolov)
movielens = _module("movielens", _text.Movielens)
conll05 = _module("conll05", _text.Conll05st)
wmt14 = _module("wmt14", _text.WMT14)
wmt16 = _module("wmt16", _text.WMT16)

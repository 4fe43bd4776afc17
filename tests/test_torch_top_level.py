"""The package's top level in the port against ``paddle_tpu``'s on the
CPU: the places, ``set_device``/``get_device``/``device_count``/
``is_compiled_with_tpu``, the dtype names, the default dtype, the grad
mode, ``in_dynamic_mode``/``disable_static``, ``amp.decorate`` and
``ops.convert_dtype``.

Where the meanings agree the values agree. The stated differences
(ROADMAP §3): the port's accelerator is the card, so ``"tpu"``, ``"gpu"``
and ``"cuda"`` all name it, ``TPUPlace(i)`` is ``cuda:i``,
``is_compiled_with_tpu()`` answers whether a card is there, and
``device_count()`` counts cards (the reference counts the JAX devices of
its backend: 8 on this host's virtual CPU mesh); the dtype names are
``torch.dtype`` objects.
"""
import numpy as np
import pytest
import torch

DTYPES = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64", "complex64", "complex128"]


@pytest.fixture
def device_reset():
    from paddle_tpu_torch.core import device
    saved = device._current
    yield device
    device._current = saved


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_names_match_the_reference(name):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    ref, port = getattr(paddle, name), getattr(pt, name)
    assert isinstance(port, torch.dtype)
    assert np.dtype(ref).itemsize == port.itemsize
    assert pt.convert_dtype(name.rstrip("_")) is port
    if name != "bfloat16":  # numpy has no bfloat16
        assert pt.ops.convert_dtype(np.dtype(ref)) is port


def test_places():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    assert repr(pt.CPUPlace()) == repr(paddle.CPUPlace())
    assert repr(pt.TPUPlace(1)) == repr(paddle.TPUPlace(1))
    assert pt.CPUPlace().is_cpu_place() and pt.TPUPlace().is_tpu_place()
    assert pt.Place("gpu", 0).is_tpu_place()
    assert pt.TPUPlace(0) == pt.Place("tpu", 0) != pt.CPUPlace()
    assert pt.resolve_device(pt.CPUPlace()) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.resolve_device(pt.TPUPlace(0))


def test_set_device_cpu_and_the_card(device_reset):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    place = pt.set_device("cpu")
    assert place == pt.CPUPlace()
    assert pt.get_device() == "cpu:0"
    assert pt.resolve_device(None) == torch.device("cpu")
    assert pt.to_tensor([1.0]).device.type == "cpu"  # no place given
    assert paddle.set_device("cpu") == paddle.CPUPlace()
    assert paddle.get_device() == pt.get_device()
    for name in ("gpu", "tpu:0", "cuda:0"):
        if torch.cuda.is_available():
            pt.set_device(name)
            assert pt.resolve_device(None).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.set_device(name)
            assert pt.get_device() == "cpu:0"  # the failed call set nothing
    with pytest.raises(ValueError, match="unsupported device"):
        pt.set_device("xpu")


def test_counts_and_presence():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    assert pt.is_compiled_with_tpu() == torch.cuda.is_available()
    assert pt.device_count() == torch.cuda.device_count()
    assert paddle.is_compiled_with_tpu() is False  # its CPU backend here
    assert paddle.device_count() >= 1


def test_default_dtype_grad_mode_and_dynamic_mode():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    assert pt.get_default_dtype() == paddle.get_default_dtype() == "float32"
    for mod in (paddle, pt):
        with pytest.raises(NotImplementedError):
            mod.set_default_dtype("float64")
    assert pt.in_dynamic_mode() and paddle.in_dynamic_mode()
    assert pt.disable_static() is None and paddle.disable_static() is None
    for mod in (paddle, pt):
        assert mod.is_grad_enabled()
        mod.set_grad_enabled(False)
        assert not mod.is_grad_enabled()
        mod.set_grad_enabled(True)
        assert mod.is_grad_enabled()


def test_amp_decorate_casts_at_o2():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    layer = nn.Linear(4, 4, device="cpu")
    opt = optimizer.SGD(parameters=layer.parameters())
    assert pt.amp.decorate(layer) is layer  # O1: nothing changes
    assert layer.weight.dtype == torch.float32
    got = pt.amp.decorate(layer, opt, level="O2", dtype="bfloat16")
    assert got == (layer, opt) and layer.weight.dtype == torch.bfloat16
    ref = paddle.nn.Linear(4, 4)
    paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    assert str(ref.weight._value.dtype) == "bfloat16"

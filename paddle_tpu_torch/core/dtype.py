"""Dtype names (counterpart: ``paddle_tpu/core/dtype.py``).

The reference keys dtypes by paddle's names ("float32", "bfloat16",
"int32", ...); the port maps the same names onto ``torch.dtype``.
"""
import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.float16: np.float16,
          torch.float32: np.float32, torch.float64: np.float64}


def is_dtype_name(name):
    return isinstance(name, str) and name in _ALIASES


def convert_dtype(dtype):
    """A paddle dtype name, numpy dtype or ``torch.dtype`` -> ``torch.dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _ALIASES:
            raise ValueError(f"unsupported dtype string: {dtype!r}")
        return _ALIASES[dtype]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _ALIASES[name]


def to_numpy_dtype(dtype):
    """``torch.dtype`` -> numpy dtype (bfloat16 has none and raises)."""
    dt = convert_dtype(dtype)
    if dt not in _NUMPY:
        raise ValueError(f"{dt} has no numpy dtype")
    return np.dtype(_NUMPY[dt])

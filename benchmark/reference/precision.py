"""Rounding to TensorFloat-32, for the control that stands in for the program."""

from __future__ import annotations

import torch


def tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits, nearest-even), as float32.

    A product of two TF32 numbers is exact in float32, so a float32 matrix
    product of TF32-rounded operands is what the tensor cores compute in TF32
    mode, on any device.  Complex tensors round each part.
    """
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = i + (0x0FFF + ((i >> 13) & 1))
    return (i & -8192).view(torch.float32)

"""uint64 arithmetic on int64 bit patterns, for the plain (CPU) paths.

PyTorch's CPU UInt64 tensors have no ``>>``, ``%``, ``<`` or
``minimum``, so hashes travel as int64 tensors holding the same 64
bits.  Two's-complement ``<<``, ``&``, ``|``, ``^``, ``==`` and the
wrapping ``+`` and ``*`` already agree with uint64; the helpers below
supply the order, the modulo, the logical right shift and the count of
leading zeros, which do not.
CUDA code reads the same bytes as native ``unsigned long long``.
"""

import numpy as np
import torch

SIGN = -(1 << 63)  # int64 pattern of the uint64 sign bit


def as_tensor(hashes, device):
    """uint64 numpy hashes (or ints) -> int64 bit-pattern tensor."""
    arr = np.ascontiguousarray(np.asarray(hashes, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_numpy(t):
    """int64 bit-pattern tensor -> uint64 numpy array."""
    return t.detach().cpu().numpy().view(np.uint64)


def sort_key(x):
    """Signed key whose order is the unsigned order of x."""
    return x ^ SIGN


def ult(a, b):
    """Unsigned a < b."""
    return sort_key(a) < sort_key(b)


def umin(a, b):
    """Unsigned elementwise minimum."""
    return torch.where(ult(b, a), b, a)


def umod(x, p):
    """Unsigned x % p for an int64 tensor p with 0 < p < 2**61.

    A negative pattern stands for x + 2**64, so its residue is the
    floor-mod of the signed value plus 2**64 % p."""
    r = torch.remainder(x, p)
    wrap = torch.remainder(torch.remainder(torch.full_like(p, 1 << 62), p)
                           * 4, p)
    return torch.where(x < 0, torch.remainder(r + wrap, p), r)


def u32(x):
    """uint32 bit patterns held in an int32 tensor -> int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def i64(c):
    """The int64 bit pattern of a uint64 constant (a Python int)."""
    return c - (1 << 64) if c >= 1 << 63 else c


def lsr(x, r):
    """Logical x >> r for 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x, r):
    """x rotated left by r bits, 0 < r < 64."""
    return (x << r) | lsr(x, 64 - r)


def clz(x):
    """Leading zero bits of every uint64 pattern (64 for 0), by a binary
    search of shifts (a float log2 is inexact above 2**53)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        zero = (x >> (64 - s)) == 0  # the top s bits are clear
        n += zero * s
        x = torch.where(zero, x << s, x)
    return n + (x == 0)

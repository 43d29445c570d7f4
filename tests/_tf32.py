"""Numpy model of float32 products on the card's tensor cores, shared by
the tests of the kernels that run them (MoE's expert products, flash
attention, the SSD scan; csrc/mma_tf32.cuh): each float32 operand v is
split into TF32 parts hi = rna(v), lo = rna(v - hi), and a product is
lo.hi + hi.lo + hi.hi summed in float32. Products of TF32 parts are exact
in float32; the sums here round to nearest, where the tensor cores
truncate, which the card tests and chip_smoke.py measure."""
import numpy as np


def tf32(v):
    """float32 v rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, by bit arithmetic: PTX's cvt.rna.tf32.f32."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def product(a, b, passes):
    """a @ b with float32 operands as the tensor cores take them: one TF32
    pass (hi.hi) or the 3xTF32 split (lo.hi + hi.lo + hi.hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh

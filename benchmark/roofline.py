"""The table of peaks and the least time a piece of work can take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3; 495 TFLOP/s in TF32 on the tensor cores, so
495/3 = 165 TFLOP/s for a product that keeps float32's accuracy (three
TF32 products each, 3xTF32), the fastest float32-accurate rate of the
card; 67 TFLOP/s of float32 outside the tensor cores.

Every matrix product is counted at ``PRODUCT_FLOP_S``, whatever unit a
kernel uses for it today, so that a share reads the same work however a
later change computes it. The float32 configurations allow no single-pass
TF32 or bf16 product, which would be another precision, not the same work.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PRODUCT_FLOP_S = 495e12 / 3
OTHER_FLOP_S = 67e12
PEAK_NAME = "H100 SXM (700 W): 3.35 TB/s, 495/3 TFLOP/s a product"


def bound_s(nbytes: float, product_flops: float,
            other_flops: float = 0.0) -> float:
    """max(bytes / HBM bandwidth, products / 165 TFLOP/s + other FLOPs /
    67 TFLOP/s), in seconds."""
    return max(nbytes / HBM_BYTES_S,
               product_flops / PRODUCT_FLOP_S + other_flops / OTHER_FLOP_S)

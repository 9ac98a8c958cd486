"""Decode plans and the flooding min-sum decoder (CUDA kernel + plain
PyTorch version)."""

from .cuda_static import (make_static_sweep_decoder,
                          minsum_flooding_reference, static_decode_counts)
from .plan import DecodePlan

__all__ = ["DecodePlan", "make_static_sweep_decoder",
           "minsum_flooding_reference", "static_decode_counts"]

"""Decode plans, the flooding decoder (CUDA kernel + plain PyTorch
version) and the torch counterpart of the JAX package's XLA decoder."""

from .cuda_static import (flooding_reference, make_static_sweep_decoder,
                          static_decode_counts)
from .plan import DecodePlan

__all__ = ["DecodePlan", "make_static_sweep_decoder", "flooding_reference",
           "static_decode_counts"]

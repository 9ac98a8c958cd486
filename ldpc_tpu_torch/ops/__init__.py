"""Decode plans, the fused decoder (CUDA kernel + plain PyTorch versions),
the phase-split decoder (two CUDA kernels + plain PyTorch versions) and the
torch counterpart of the JAX package's XLA decoder."""

from .cuda_split import make_split_sweep_decoder, split_reference
from .cuda_static import (barrier_lowers, flooding_reference,
                          make_static_sweep_decoder, static_decode_counts)
from .plan import DecodePlan

__all__ = ["DecodePlan", "make_static_sweep_decoder", "flooding_reference",
           "static_decode_counts", "make_split_sweep_decoder",
           "split_reference", "barrier_lowers"]

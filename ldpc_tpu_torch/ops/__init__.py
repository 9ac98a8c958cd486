"""Decode plans, the fused decoder (CUDA kernel + plain PyTorch versions),
the phase-split decoder (two CUDA kernels + plain PyTorch versions), the
torch counterpart of the JAX package's XLA decoder and its dynamic-plan
decoder (runtime shift tables, the code search's plain reference), and the
float64 oracle."""

from .cuda_split import make_split_sweep_decoder, split_reference
from .cuda_static import (barrier_lowers, flooding_reference,
                          make_static_sweep_decoder, static_decode_counts)
from .decoder import DecodeResult, decode, decoder_for_code, make_decoder
from .dynamic import (DynamicPlan, dynamic_plan, make_dynamic_decoder,
                      make_multi_dynamic_decoder, stack_plans)
from .oracle import dense_min_sum_decode, syndrome_ok
from .plan import DecodePlan

__all__ = ["DecodePlan", "DecodeResult", "decode", "decoder_for_code",
           "make_decoder", "dense_min_sum_decode", "syndrome_ok",
           "make_static_sweep_decoder", "flooding_reference",
           "static_decode_counts", "make_split_sweep_decoder",
           "split_reference", "barrier_lowers", "DynamicPlan",
           "dynamic_plan", "make_dynamic_decoder",
           "make_multi_dynamic_decoder", "stack_plans"]

"""ldpc_tpu_torch: the PyTorch/CUDA port of ``ldpc_tpu`` for one NVIDIA H100.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``ldpc_tpu``;
sub-packages mirror ``ldpc_tpu`` so each module's counterpart is easy to
find:

  codes/   QC shift tables, the JSON code format, CCSDS near-earth
  ops/     decode plans; the flooding min-sum CUDA kernel
           (``csrc/minsum_flooding.cu``), its plain PyTorch version and
           wrapper (``ops/cuda_static.py``)
  sim/     BPSK/AWGN channel, staged Monte-Carlo sweep, BER/FER statistics
  utils/   device selection
  csrc/    CUDA sources and their nvcc + ctypes build

Entry points run on the card unless called with ``device="cpu"``.

Quick start (on the card)::

    import torch
    from ldpc_tpu_torch.codes import near_earth_code
    from ldpc_tpu_torch.sim import make_staged_sweep_device
    step = make_staged_sweep_device(
        near_earth_code(), 50, generator=torch.Generator("cuda").manual_seed(0))
    out = step(torch.full((32768,), 3.4))
"""

__version__ = "0.1.0"

__all__ = ["codes", "ops", "sim", "utils", "csrc"]

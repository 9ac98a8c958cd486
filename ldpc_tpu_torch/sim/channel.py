"""BPSK modulation, AWGN channel and LLR computation on [B, n] tensors.

Same semantics as ``ldpc_tpu.sim.channel`` (reference ``ldpc.py:43-66``):
``modulate`` maps bit 0 -> -1.0 and bit 1 -> +1.0; the noise sigma of an
Eb/N0-style dB value is ``sqrt(0.5 / 10^(dB/10))``; ``awgn`` also reports the
realized RMS of the drawn noise per word; ``slicer`` maps > 0 -> 1.  Min-sum
takes the raw noisy samples as LLRs; ``llr_from_channel`` gives the true LLRs
``2 y / sigma^2``.

The noise comes from an explicit ``torch.Generator`` (Philox on the card).
It never draws the JAX package's bits, so the two channels agree in
distribution only.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device

__all__ = ["snr_db_to_sigma", "modulate", "slicer", "awgn",
           "llr_from_channel", "transmit_zero_codeword",
           "transmit_codewords", "epsilon_probe"]


def snr_db_to_sigma(snr_db, *, device=None) -> torch.Tensor:
    """sigma = sqrt(0.5 / SNR_linear) (ldpc.py:51-55), in float32.

    A tensor argument keeps its device; anything else goes to ``device``.
    """
    if not isinstance(snr_db, torch.Tensor):
        snr_db = torch.as_tensor(snr_db, dtype=torch.float32,
                                 device=resolve_device(device))
    snr = 10.0 ** (snr_db.to(torch.float32) / 10.0)
    return torch.sqrt(0.5 / snr)


def modulate(bits: torch.Tensor) -> torch.Tensor:
    """BPSK: 0 -> -1.0, 1 -> +1.0 (ldpc.py:62-66)."""
    return torch.where(bits == 0, -1.0, 1.0).to(torch.float32)


def slicer(soft: torch.Tensor) -> torch.Tensor:
    """Hard decision: > 0 -> 1, <= 0 -> 0 (ldpc.py:43-48)."""
    return (soft > 0).to(torch.int8)


def awgn(modulated: torch.Tensor, snr_db, *,
         generator: torch.Generator | None = None):
    """Add white Gaussian noise at ``snr_db`` (scalar or one value per word).

    Returns (noisy, sigma[B], sigma_actual[B]); ``sigma_actual`` is the
    realized RMS of the drawn noise of each word (ldpc.py:58).
    """
    b = modulated.shape[0]
    sigma = snr_db_to_sigma(snr_db, device=modulated.device)
    sigma_b = torch.broadcast_to(torch.atleast_1d(sigma), (b,))
    noise = sigma_b[:, None] * torch.randn(
        modulated.shape, generator=generator, dtype=torch.float32,
        device=modulated.device)
    sigma_actual = torch.sqrt(torch.mean(noise * noise, dim=-1))
    return modulated + noise, sigma_b, sigma_actual


def llr_from_channel(noisy: torch.Tensor, sigma) -> torch.Tensor:
    """True channel LLRs ``2 y / sigma^2`` (positive => bit 1)."""
    sigma = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32,
                                             device=noisy.device))
    return 2.0 * noisy / (sigma[:, None] ** 2)


def transmit_zero_codeword(batch: int, n: int, snr_db, *,
                           generator: torch.Generator | None = None,
                           device=None):
    """All-zero codeword through BPSK + AWGN (ldpc.py:364-372).

    Returns (noisy [batch, n], sigma [batch], sigma_actual [batch]).
    """
    clean = torch.full((batch, n), -1.0, dtype=torch.float32,
                       device=resolve_device(device))  # modulate(0) == -1
    return awgn(clean, snr_db, generator=generator)


def transmit_codewords(codewords: torch.Tensor, snr_db, *,
                       generator: torch.Generator | None = None):
    """BPSK + AWGN for explicit codewords [B, n] (the reference's G-based
    path, ldpc.py:409-416).  Returns (noisy, sigma, sigma_actual)."""
    return awgn(modulate(codewords), snr_db, generator=generator)


def epsilon_probe(n: int, flips=(0,), epsilon: float = 0.0, *,
                  device=None) -> torch.Tensor:
    """Deterministic probe [1, n]: the modulated all-zero word plus
    ``epsilon``, with the bits at ``flips`` sign-flipped (ldpc.py:417-418,
    ldpcCUDA.py:677-828).  As JAX's ``.at[flips].multiply(-1.0)``: an index
    in [-n, 0) counts from the end, one outside [-n, n) is dropped, and a
    bit listed twice is flipped twice."""
    v = torch.full((n,), -1.0, dtype=torch.float32,
                   device=resolve_device(device)) + epsilon
    idx = torch.as_tensor(list(flips), dtype=torch.int64, device=v.device)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    odd = torch.bincount(idx, minlength=n) % 2 == 1
    return torch.where(odd, -v, v)[None, :]

"""Perturbed-code robustness suite (copy of ``ldpc_tpu.codes.perturb``).

The reference generates 32 variants of the near-earth code with one circulant
zeroed (``testMatricesGeneratorScript.py:23-34``) for FER-degradation studies.
Here perturbations are pure functions of a QCCode; the suite generator writes
``.npz`` code instances via :func:`ldpc_tpu_torch.codes.io.save_code_instance`.
"""

from __future__ import annotations

from typing import Iterator

from .io import save_code_instance
from .qc import QCCode

__all__ = ["zero_circulant", "zeroed_circulant_suite", "write_suite"]


def zero_circulant(code: QCCode, mb: int, nb: int) -> QCCode:
    """Return the code with circulant (mb, nb) replaced by the zero block."""
    return code.replace_block(mb, nb, ())


def zeroed_circulant_suite(code: QCCode) -> Iterator[tuple[int, int, QCCode]]:
    """All single-zeroed-circulant variants (near-earth: 32 codes)."""
    for mb in range(code.block_rows):
        for nb in range(code.block_cols):
            yield mb, nb, zero_circulant(code, mb, nb)


def write_suite(code: QCCode, out_dir) -> list[str]:
    """Write the whole suite to ``out_dir`` as .npz code instances."""
    names = []
    for mb, nb, variant in zeroed_circulant_suite(code):
        names.append(save_code_instance(
            variant, out_dir, file_name=f"{code.name or 'code'}_zero_{mb}_{nb}"))
    return names

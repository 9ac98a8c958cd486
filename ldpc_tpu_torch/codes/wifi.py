"""IEEE 802.11n QC-LDPC codes (n = 1944, Z = 81); the port's own copy of
``ldpc_tpu.codes.wifi`` (same tables, same names).

The reference ships the rate-5/6 prototype table (``wifiMatrices.py:6-9``)
and expands it densely (``getWifiParityMatrix``, ``wifiMatrices.py:12-34``).
Here prototype tables map straight to ``QCCode`` shift tables — each entry is
a single circulant shift, ``None`` is the all-zero block — so the decoder
consumes them without ever densifying.
"""

from __future__ import annotations

import functools

from .qc import QCCode

__all__ = ["WIFI_1944_81_RATE_1_2", "WIFI_1944_81_RATE_2_3",
           "WIFI_1944_81_RATE_3_4", "WIFI_1944_81_RATE_5_6",
           "wifi_code", "wifi_rates", "from_prototype"]

# IEEE 802.11n n=1944, Z=81 prototype tables (public standard constants,
# IEEE Std 802.11n-2009 Annex R).  Entry = circulant shift, None = zero
# block.  The reference ships only the rate-5/6 table
# (wifiMatrices.py:6-9); the remaining rates complete the 1944-bit
# family.  All share the standard's parity structure: a weight-3 first
# parity column with shifts (1, 0, 1) at (top, middle, bottom) and a
# dual diagonal of 0-shift blocks — invariants enforced by
# tests/test_codes.py and tests/test_torch_wifi.py.
_ = None

# Rate 1/2: 12 x 24
WIFI_1944_81_RATE_1_2 = [
    [57, _, _, _, 50, _, 11, _, 50, _, 79, _, 1, 0, _, _, _, _, _, _, _, _, _, _],
    [3, _, 28, _, 0, _, _, _, 55, 7, _, _, _, 0, 0, _, _, _, _, _, _, _, _, _],
    [30, _, _, _, 24, 37, _, _, 56, 14, _, _, _, _, 0, 0, _, _, _, _, _, _, _, _],
    [62, 53, _, _, 53, _, _, 3, 35, _, _, _, _, _, _, 0, 0, _, _, _, _, _, _, _],
    [40, _, _, 20, 66, _, _, 22, 28, _, _, _, _, _, _, _, 0, 0, _, _, _, _, _, _],
    [0, _, _, _, 8, _, 42, _, 50, _, _, 8, _, _, _, _, _, 0, 0, _, _, _, _, _],
    [69, 79, 79, _, _, _, 56, _, 52, _, _, _, 0, _, _, _, _, _, 0, 0, _, _, _, _],
    [65, _, _, _, 38, 57, _, _, 72, _, 27, _, _, _, _, _, _, _, _, 0, 0, _, _, _],
    [64, _, _, _, 14, 52, _, _, 30, _, _, 32, _, _, _, _, _, _, _, _, 0, 0, _, _],
    [_, 45, _, 70, 0, _, _, _, 77, 9, _, _, _, _, _, _, _, _, _, _, _, 0, 0, _],
    [2, 56, _, 57, 35, _, _, _, _, _, 12, _, _, _, _, _, _, _, _, _, _, _, 0, 0],
    [24, _, 61, _, 60, _, _, 27, 51, _, _, 16, 1, _, _, _, _, _, _, _, _, _, _, 0],
]

# Rate 2/3: 8 x 24
WIFI_1944_81_RATE_2_3 = [
    [61, 75, 4, 63, 56, _, _, _, _, _, _, 8, _, 2, 17, 25, 1, 0, _, _, _, _, _, _],
    [56, 74, 77, 20, _, _, _, 64, 24, 4, 67, _, 7, _, _, _, _, 0, 0, _, _, _, _, _],
    [28, 21, 68, 10, 7, 14, 65, _, _, _, 23, _, _, _, 75, _, _, _, 0, 0, _, _, _, _],
    [48, 38, 43, 78, 76, _, _, _, _, 5, 36, _, 15, 72, _, _, _, _, _, 0, 0, _, _, _],
    [40, 2, 53, 25, _, 52, 62, _, 20, _, _, 44, _, _, _, _, 0, _, _, _, 0, 0, _, _],
    [69, 23, 64, 10, 22, _, 21, _, _, _, _, _, 68, 23, 29, _, _, _, _, _, _, 0, 0, _],
    [12, 0, 68, 20, 55, 61, _, 40, _, _, _, 52, _, _, _, 44, _, _, _, _, _, _, 0, 0],
    [58, 8, 34, 64, 78, _, _, 11, 78, 24, _, _, _, _, _, 58, 1, _, _, _, _, _, _, 0],
]

# Rate 3/4: 6 x 24
WIFI_1944_81_RATE_3_4 = [
    [48, 29, 28, 39, 9, 61, _, _, _, 63, 45, 80, _, _, _, 37, 32, 22, 1, 0, _, _, _, _],
    [4, 49, 42, 48, 11, 30, _, _, _, 49, 17, 41, 37, 15, _, 54, _, _, _, 0, 0, _, _, _],
    [35, 76, 78, 51, 37, 35, 21, _, 17, 64, _, _, _, 59, 7, _, _, 32, _, _, 0, 0, _, _],
    [9, 65, 44, 9, 54, 56, 73, 34, 42, _, _, _, 35, _, _, _, 46, 39, 0, _, _, 0, 0, _],
    [3, 62, 7, 80, 68, 26, _, 80, 55, _, 36, _, 26, _, 9, _, 72, _, _, _, _, _, 0, 0],
    [26, 75, 33, 21, 69, 59, 3, 38, _, _, _, 35, _, 62, 36, 26, _, _, 1, _, _, _, _, 0],
]

# Rate 5/6: 4 x 24 (same public table as the reference's WIFI_1944_81_5_6).
WIFI_1944_81_RATE_5_6 = [
    [13, 48, 80, 66, 4, 74, 7, 30, 76, 52, 37, 60, _, 49, 73, 31, 74, 73, 23, _, 1, 0, _, _],
    [69, 63, 74, 56, 64, 77, 57, 65, 6, 16, 51, _, 64, _, 68, 9, 48, 62, 54, 27, _, 0, 0, _],
    [51, 15, 0, 80, 24, 25, 42, 54, 44, 71, 71, 9, 67, 35, _, 58, _, 29, _, 53, 0, _, 0, 0],
    [16, 29, 36, 41, 44, 56, 59, 37, 50, 24, _, 65, 4, 65, 52, _, 4, _, 73, 52, 1, _, _, 0],
]

_TABLES = {
    (1944, 1 / 2): (WIFI_1944_81_RATE_1_2, 81),
    (1944, 2 / 3): (WIFI_1944_81_RATE_2_3, 81),
    (1944, 3 / 4): (WIFI_1944_81_RATE_3_4, 81),
    (1944, 5 / 6): (WIFI_1944_81_RATE_5_6, 81),
}


def wifi_rates(codeword_size: int = 1944) -> list[float]:
    """The available 802.11n rates for a codeword size, ascending."""
    return sorted(r for (n, r) in _TABLES if n == codeword_size)


def from_prototype(table, z: int, name: str = "",
                   message_size: int | None = None) -> QCCode:
    """Prototype table (entries: shift int or None) -> QCCode."""
    shifts = tuple(
        tuple(() if e is None else (int(e),) for e in row) for row in table
    )
    return QCCode(z=z, shifts=shifts, name=name, message_size=message_size)


@functools.lru_cache(maxsize=None)
def wifi_code(codeword_size: int = 1944, rate: float = 5 / 6) -> QCCode:
    """The 802.11n code for (codeword_size, rate) — n=1944 rates 1/2,
    2/3, 3/4, 5/6.

    Same entry point shape as ``wifiMatrices.getWifiParityMatrix``
    (wifiMatrices.py:12) but returns the QC structure.
    """
    key = (codeword_size, rate)
    if key not in _TABLES:
        raise ValueError(f"no 802.11n table for n={codeword_size}, rate={rate}; "
                         f"available: {sorted(_TABLES)}")
    table, z = _TABLES[key]
    mb = len(table)
    return from_prototype(table, z, name=f"wifi_{codeword_size}_r{rate:.3f}",
                          message_size=codeword_size - mb * z)

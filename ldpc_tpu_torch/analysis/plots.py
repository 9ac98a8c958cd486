"""Evaluation plots (reference ``common.py:29-139, 231-347``): the port's
own copy of ``ldpc_tpu.analysis.plots``.

Matplotlib figures mirroring the reference's dashboards: BER waterfall vs
the analytic uncoded PAM-2 curve (``plotSNRvsBER``, common.py:103-139),
average iterations vs SNR (``plotSNRvsNumberOfIterations``, common.py:87),
decoder-throughput bars (``plotDecoderThroughput``, common.py:29-84 — the
hardcoded measured series are kept as the published baselines to compare
against), and the evaluation scatter + recursive/piecewise fits
(``plotEvaluationData``, common.py:307-332).

All functions return (fig, ax) and save to ``file_name`` when given; no
GUI backend is required.  Matplotlib is imported when a plot is drawn,
never with this module; without it a plot function raises ``ImportError``
and ``pam2_ber`` still works.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pam2_ber", "plot_snr_vs_ber", "plot_snr_vs_iterations",
           "plot_decoder_throughput", "plot_evaluation_data",
           "REFERENCE_THROUGHPUT_SERIES", "REFERENCE_NEAR_EARTH_BER"]


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed here") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


# Published baselines (BASELINE.md / common.py:32-35): decoded bit/s at
# Eb/N0 = 3.0/3.2/3.4/3.6 dB, near-earth, max 50 iterations.
REFERENCE_THROUGHPUT_SERIES = {
    "Intel Xeon (1 core, numba)": [80.9, 713.7, 3462.6, 6923.8],
    "GTX 1060 Ti (numba-CUDA)": [24437.7, 48682.2, 148195.2, 192762.5],
    "RTX 3080 (numba-CUDA)": [17069.3, 25092.0, 42335.2, 48736.2],
}

# Near-earth BER reference points (common.py:112-114): realized SNR -> BER.
REFERENCE_NEAR_EARTH_BER = (
    np.array([2.9914, 3.1541, 3.3076, 3.4404]),
    np.array([2.354e-2, 1.359e-2, 1.079e-2, 0.0]),
)


def pam2_ber(snr_db) -> np.ndarray:
    """Analytic uncoded PAM-2 BER, Q(1/sigma) with the reference's SNR
    definition (matches the hardcoded berPam2 table, common.py:104-110)."""
    from scipy.special import erfc
    snr = 10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
    sigma = np.sqrt(0.5 / snr)
    return 0.5 * erfc(1.0 / (sigma * np.sqrt(2.0)))


def plot_snr_vs_ber(snr_axis, ber, file_name=None, label="decoded",
                    show_pam2: bool = True, show_reference: bool = True):
    """BER waterfall vs uncoded PAM-2 (plotSNRvsBER, common.py:103-139)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.semilogy(snr_axis, np.maximum(np.asarray(ber, float), 1e-12),
                marker="o", label=label)
    if show_pam2:
        grid = np.linspace(min(snr_axis) - 1, max(snr_axis) + 2, 64)
        ax.semilogy(grid, pam2_ber(grid), linestyle="--",
                    label="uncoded PAM-2 (analytic)")
    if show_reference:
        rs, rb = REFERENCE_NEAR_EARTH_BER
        ax.semilogy(rs, np.maximum(rb, 1e-12), linestyle="none",
                    marker="x", label="reference near-earth points")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("Bit error rate")
    ax.set_title("SNR vs BER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if file_name:
        fig.savefig(file_name, dpi=120, bbox_inches="tight")
    return fig, ax


def plot_snr_vs_iterations(snr_axis, avg_iterations, file_name=None):
    """Average decoder iterations vs SNR (common.py:87-101)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(snr_axis, avg_iterations, marker="o")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("Average decoder iterations")
    ax.set_title("SNR vs number of iterations")
    ax.grid(True, alpha=0.3)
    if file_name:
        fig.savefig(file_name, dpi=120, bbox_inches="tight")
    return fig, ax


def plot_decoder_throughput(measured: dict | None = None, file_name=None,
                            snr_labels=("3.0", "3.2", "3.4", "3.6")):
    """Grouped throughput bars (plotDecoderThroughput, common.py:29-84):
    the reference's published hardware series plus any ``measured``
    {label: [bit/s per SNR]} series (e.g. this framework on TPU)."""
    plt = _plt()
    series = dict(REFERENCE_THROUGHPUT_SERIES)
    if measured:
        series.update(measured)
    n_groups, n_series = len(snr_labels), len(series)
    x = np.arange(n_groups)
    width = 0.8 / n_series
    fig, ax = plt.subplots(figsize=(9, 4.5))
    for idx, (label, vals) in enumerate(series.items()):
        ax.bar(x + idx * width, vals[:n_groups], width, label=label)
    ax.set_yscale("log")
    ax.set_xticks(x + 0.4 - width / 2)
    ax.set_xticklabels([f"{s} dB" for s in snr_labels])
    ax.set_ylabel("Decoded bits / s")
    ax.set_title("Decoder throughput @ max 50 iterations (near-earth)")
    ax.legend(fontsize=8)
    if file_name:
        fig.savefig(file_name, dpi=120, bbox_inches="tight")
    return fig, ax


def plot_evaluation_data(snr, ber, file_name=None, fill_between=True):
    """Scatter + linear & piecewise fits (plotEvaluationData,
    common.py:307-332)."""
    from ..sim.reward import piecewise_fit, piecewise_linear

    plt = _plt()
    snr = np.asarray(snr, float)
    ber = np.asarray(ber, float)
    p = np.polyfit(snr, ber, 1)
    trend = np.poly1d(p)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.scatter(snr, ber, s=12, label="per-transmission BER")
    order = np.argsort(snr)
    ax.plot(snr[order], trend(snr[order]), label="linear fit")
    try:
        params, _ = piecewise_fit(snr, ber)
        ax.plot(snr[order], piecewise_linear(snr[order], *params),
                label="piecewise fit")
    except Exception:
        pass
    if fill_between:
        region = np.linspace(snr.min(), snr.max(), 32)
        ax.fill_between(region, trend(region), np.maximum(ber.max(), 0.035),
                        alpha=0.2)
    ax.set_xlabel("Signal to noise ratio")
    ax.set_ylabel("Bit error rate")
    ax.set_title("Evaluation data")
    ax.legend()
    if file_name:
        fig.savefig(file_name, dpi=120, bbox_inches="tight")
    return fig, ax

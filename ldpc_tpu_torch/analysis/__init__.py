"""Evaluation plots (the port's ``analysis/plots.py``)."""

from .plots import (REFERENCE_NEAR_EARTH_BER, REFERENCE_THROUGHPUT_SERIES,
                    pam2_ber, plot_decoder_throughput, plot_evaluation_data,
                    plot_snr_vs_ber, plot_snr_vs_iterations)

__all__ = ["pam2_ber", "plot_snr_vs_ber", "plot_snr_vs_iterations",
           "plot_decoder_throughput", "plot_evaluation_data",
           "REFERENCE_THROUGHPUT_SERIES", "REFERENCE_NEAR_EARTH_BER"]

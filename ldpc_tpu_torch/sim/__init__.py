"""Channel, Monte-Carlo sweeps (staged or not, two engines), BER/FER
statistics and the code-search reward."""

from .channel import (awgn, epsilon_probe, llr_from_channel, modulate,
                      slicer, snr_db_to_sigma, transmit_codewords,
                      transmit_zero_codeword)
from .evaluate import (evaluate_code, evaluate_epsilon_probe,
                       make_staged_decoder_device, make_staged_sweep_device,
                       random_codeword_sweep_step, staged_decode_counts,
                       sweep_step)
from .reward import (BAD_CANDIDATE_REWARD, calc_reward, piecewise_fit,
                     piecewise_linear, recursive_linear_fit)
from .stats import BerStatistics, frame_ber_ci, snr_db_actual, wilson_interval

__all__ = ["awgn", "epsilon_probe", "llr_from_channel", "modulate", "slicer",
           "snr_db_to_sigma", "transmit_codewords", "transmit_zero_codeword",
           "evaluate_code", "evaluate_epsilon_probe",
           "make_staged_decoder_device", "make_staged_sweep_device",
           "random_codeword_sweep_step", "staged_decode_counts",
           "sweep_step", "BerStatistics",
           "frame_ber_ci", "snr_db_actual", "wilson_interval",
           "BAD_CANDIDATE_REWARD", "calc_reward", "piecewise_fit",
           "piecewise_linear", "recursive_linear_fit"]

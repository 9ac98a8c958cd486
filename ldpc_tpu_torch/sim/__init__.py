"""Channel, staged Monte-Carlo sweep and BER/FER statistics."""

from .channel import (awgn, llr_from_channel, modulate, slicer,
                      snr_db_to_sigma, transmit_zero_codeword)
from .evaluate import (make_staged_decoder_device, make_staged_sweep_device,
                       staged_decode_counts)
from .stats import BerStatistics, frame_ber_ci, snr_db_actual, wilson_interval

__all__ = ["awgn", "llr_from_channel", "modulate", "slicer",
           "snr_db_to_sigma", "transmit_zero_codeword",
           "make_staged_decoder_device", "make_staged_sweep_device",
           "staged_decode_counts", "BerStatistics", "frame_ber_ci",
           "snr_db_actual", "wilson_interval"]

"""Post-hoc analysis: evaluation plots, the experiment post-mortem and the
live dashboards (the port of ``ldpc_tpu.analysis``)."""

from .plots import (REFERENCE_NEAR_EARTH_BER, REFERENCE_THROUGHPUT_SERIES,
                    pam2_ber, plot_decoder_throughput, plot_evaluation_data,
                    plot_snr_vs_ber, plot_snr_vs_iterations)
from .dashboard import CirculantDashboard, RewardPlotter
from .postprocess import (POST_MORTEM_SNR_POINTS,
                          REWARD_FOR_NEAR_EARTH_3_0_TO_3_4,
                          REWARD_FOR_NEAR_EARTH_3_0_TO_3_8,
                          action_heatmaps, learning_windows,
                          post_mortem_best_codes, reeval_reward,
                          reward_surface, topk_select)

__all__ = [
    "pam2_ber", "plot_snr_vs_ber", "plot_snr_vs_iterations",
    "plot_decoder_throughput", "plot_evaluation_data",
    "REFERENCE_NEAR_EARTH_BER", "REFERENCE_THROUGHPUT_SERIES",
    "action_heatmaps", "reward_surface", "post_mortem_best_codes",
    "learning_windows", "reeval_reward", "topk_select",
    "REWARD_FOR_NEAR_EARTH_3_0_TO_3_4", "REWARD_FOR_NEAR_EARTH_3_0_TO_3_8",
    "POST_MORTEM_SNR_POINTS",
    "CirculantDashboard", "RewardPlotter",
]

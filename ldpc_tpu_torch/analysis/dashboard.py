"""Live experiment dashboards (reference ``common.py:231-283``,
``utilityFunctions.py:50-108``; the port of ``ldpc_tpu.analysis.dashboard``,
matplotlib imported at first use).

* ``CirculantDashboard`` — the ``spawnGraphics`` equivalent: a figure
  showing the QC parity structure as an (Mb x Nb) grid of circulant
  density cells plus a BER-vs-SNR panel; ``update_circulant`` redraws one
  cell after an env action, ``update_ber`` appends a waterfall curve.
* ``RewardPlotter`` — the live per-epoch reward animation
  (``utilityFunctions.plotter``); headless-safe (saves a PNG per refresh
  when no display is available).
"""

from __future__ import annotations

import numpy as np

from ..codes.qc import QCCode

__all__ = ["CirculantDashboard", "RewardPlotter"]


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


class CirculantDashboard:
    """Parity-structure + BER dashboard (common.spawnGraphics:263-283)."""

    def __init__(self, code: QCCode, file_name=None):
        plt = _plt()
        self.code = code
        self.file_name = file_name
        mb, nb = code.block_rows, code.block_cols
        self.fig, axs = plt.subplots(
            2, 1, figsize=(max(6, nb * 0.6), 7),
            gridspec_kw={"height_ratios": [1, 1.2]})
        self.ax_grid, self.ax_ber = axs
        self._draw_grid()
        self.ax_ber.set_xlabel("SNR (dB)")
        self.ax_ber.set_ylabel("BER")
        self.ax_ber.set_yscale("log")
        self.ax_ber.set_title("SNR to BER")
        self.ax_ber.grid(True, which="both", alpha=0.3)
        self._flush()

    def _draw_grid(self):
        rows = self.code.first_rows()
        density = rows.sum(axis=-1)  # hot bits per circulant
        self.im = self.ax_grid.imshow(density, cmap="viridis",
                                      aspect="auto")
        self.ax_grid.set_title(
            f"circulant weights ({self.code.block_rows} x "
            f"{self.code.block_cols}, Z={self.code.z})")
        self.ax_grid.set_xlabel("block col")
        self.ax_grid.set_ylabel("block row")

    def update_circulant(self, code: QCCode):
        """Redraw after a circulant replacement (updateCirculantImage)."""
        self.code = code
        self.im.set_data(code.first_rows().sum(axis=-1))
        self._flush()

    def update_ber(self, snr, ber, label=None):
        """Append a BER curve (common.updateBerVSnr)."""
        ber = np.maximum(np.asarray(ber, float), 1e-12)
        self.ax_ber.plot(snr, ber, marker="o", label=label)
        if label:
            self.ax_ber.legend(fontsize=7)
        self._flush()

    def _flush(self):
        self.fig.canvas.draw_idle()
        if self.file_name:
            self.fig.savefig(self.file_name, dpi=100, bbox_inches="tight")

    def close(self):
        import matplotlib.pyplot as plt
        plt.close(self.fig)


class RewardPlotter:
    """Live reward trace (utilityFunctions.plotter:50-108)."""

    def __init__(self, file_name=None, title="reward per step"):
        plt = _plt()
        self.file_name = file_name
        self.fig, self.ax = plt.subplots(figsize=(7, 3.5))
        self.ax.set_xlabel("step")
        self.ax.set_ylabel("reward")
        self.ax.set_title(title)
        self.xs: list[float] = []
        self.ys: list[float] = []
        (self.line,) = self.ax.plot([], [], marker=".")

    def append(self, reward: float):
        self.xs.append(len(self.xs))
        self.ys.append(float(reward))
        self.line.set_data(self.xs, self.ys)
        self.ax.relim()
        self.ax.autoscale_view()
        self.fig.canvas.draw_idle()
        if self.file_name:
            self.fig.savefig(self.file_name, dpi=100, bbox_inches="tight")

    def close(self):
        import matplotlib.pyplot as plt
        plt.close(self.fig)

#!/usr/bin/env python
"""Feature heatmap plotting (port of aps_tpu/plot.py::plot_feature)."""

from typing import Optional

import numpy as np


def plot_feature(feats: np.ndarray,
                 dest: str,
                 cmap: str = "jet",
                 hop: Optional[int] = 160,
                 sr: int = 16000,
                 title: str = "") -> None:
    """Save a T x F feature matrix (numpy, or a tensor on any device) as a
    heatmap image; matplotlib is imported at the call."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(feats, "detach"):
        feats = feats.detach().cpu().numpy()
    feats = np.asarray(feats)
    fig, ax = plt.subplots()
    ax.imshow(feats.T, origin="lower", cmap=cmap, aspect="auto",
              interpolation="none")
    if hop:
        num_frames = feats.shape[0]
        xticks = np.linspace(0, num_frames - 1, 5)
        ax.set_xticks(xticks)
        ax.set_xticklabels([f"{t * hop / sr:.2f}" for t in xticks])
        ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency bin")
    if title:
        ax.set_title(title)
    fig.savefig(dest, dpi=200, bbox_inches="tight")
    plt.close(fig)

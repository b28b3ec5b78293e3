# -*- coding: utf-8 -*-
"""Data visualization utilities: the port of ``climsr_tpu.data.utils`` (matplotlib
imported in the calls).

Parity: reference ``climsr/data/utils.py`` — ``im_show_with_colorbar``,
batch-grid plotting, ``get_variable_from_ds_fp``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from climsr_tpu_torch.inference.datasets import get_variable_from_ds_fp  # noqa: F401 (parity re-export)


def im_show_with_colorbar(
    arr: np.ndarray,
    title: str = "",
    cmap: str = "jet",
    save_path: Optional[str] = None,
):
    """Render a raster with a colorbar; NaNs painted black (utils.py:13)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = matplotlib.colormaps[cmap].copy()
    cm.set_bad("black", 1.0)
    fig, ax = plt.subplots(figsize=(8, 5))
    im = ax.imshow(np.ma.masked_invalid(np.asarray(arr)), cmap=cm)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_batch_grid(
    batch: np.ndarray,
    titles: Optional[Sequence[str]] = None,
    ncols: int = 4,
    cmap: str = "jet",
    save_path: Optional[str] = None,
):
    """Plot a (N, H, W[, 1]) batch as an image grid (utils.py:39)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    batch = np.asarray(batch)
    if batch.ndim == 4:
        batch = batch[..., 0]
    n = batch.shape[0]
    nrows = (n + ncols - 1) // ncols
    cm = matplotlib.colormaps[cmap].copy()
    cm.set_bad("black", 1.0)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows), squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(np.ma.masked_invalid(batch[i]), cmap=cm)
            if titles and i < len(titles):
                ax.set_title(titles[i], fontsize=9)
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return fig

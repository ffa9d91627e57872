"""Visualisation (the reference's ``utils/utils.py:4-13``, as the JAX
package's ``utils/viz.py``).  matplotlib is imported on call, so a machine
without it raises ``ImportError`` only when a plot is asked for."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_img_and_mask"]


def plot_img_and_mask(img, mask) -> None:
    """The image and one panel per mask class, shown with matplotlib."""
    import matplotlib.pyplot as plt

    mask = np.asarray(mask)
    classes = int(mask.max()) + 1
    fig, ax = plt.subplots(1, classes + 1)
    ax[0].set_title("Input image")
    ax[0].imshow(img, cmap="gray")
    for i in range(classes):
        ax[i + 1].set_title(f"Mask (class {i + 1})")
        ax[i + 1].imshow(mask == i)
    plt.xticks([]), plt.yticks([])
    plt.show()

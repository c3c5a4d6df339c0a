"""Gradient attributions of the PyTorch port's FAST, and scalp plots.

Importing the package imports no matplotlib: the drawing functions do.
"""

from .attribution import (  # noqa: F401
    attribution_for_predictions,
    expected_gradients,
    expected_gradients_from_draws,
    integrated_gradients,
    zone_importance,
    zone_time_matrix,
)
from .topomap import electrode_position, montage_positions, plot_topomap, save_topomap  # noqa: F401
from .plots import (  # noqa: F401
    plot_attribution_heatmap,
    plot_band_heatmap,
    plot_class_topomaps,
    plot_zone_importance,
    plot_zone_time_heatmap,
    symmetric_vlim,
)

"""Weight compression: k-means palettization and mixed-bit recipes."""

from .mixed_bit import apply_recipe, benchmark_signal_integrity, build_recipe
from .palettize import (
    NBITS,
    PALETTIZE_MIN_SIZE,
    dequantize_tree,
    palettize_tree,
    palettize_weights,
)

__all__ = [
    "NBITS",
    "PALETTIZE_MIN_SIZE",
    "palettize_tree",
    "dequantize_tree",
    "palettize_weights",
    "build_recipe",
    "apply_recipe",
    "benchmark_signal_integrity",
]

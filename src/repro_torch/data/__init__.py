"""Synthetic data and the label-skew and Dirichlet partitioners: numpy
copies of ``repro/data`` (the port imports nothing of the JAX package)."""

from .partition import partition_dirichlet, partition_label_skew
from .synthetic import make_classification, make_image_classification, make_lm_streams

__all__ = ["make_classification", "make_image_classification", "make_lm_streams", "partition_label_skew",
           "partition_dirichlet"]

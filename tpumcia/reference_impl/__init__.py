"""Pure CPU numpy/scipy oracle reproducing the reference notebook's feature semantics.

Test-only: golden tests compare the device path against this module. See SURVEY.md §2.3
for the exact contract (reference: channel_importance_hand_crafted_features.ipynb,
cells 9 and 13). scikit-image is not available in this environment, so the GLCM,
shannon-entropy and random-noise semantics are re-implemented here from their
documented definitions.
"""

from tpumcia.reference_impl.oracle import (
    add_noise_channels,
    basic_statistical_features,
    feature_names,
    feature_vector,
    glcm_features,
    graycomatrix,
    graycoprops,
    shannon_entropy,
)

__all__ = [
    "add_noise_channels",
    "basic_statistical_features",
    "feature_names",
    "feature_vector",
    "glcm_features",
    "graycomatrix",
    "graycoprops",
    "shannon_entropy",
]

"""tpumcia — interpretable multichannel image analysis on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of
`aliechoes/interpretable-multichannel-image-analysis`: HDF5 cell-object
ingestion, fused preprocessing, hand-crafted per-channel feature extraction
(intensity statistics + GLCM texture), classifier heads (device logistic head,
random-forest adapter, ResNet-style CNN), and batched channel-importance
analysis (MDI, permutation, ablation, occlusion) — batched device
computations over device meshes rather than per-image Python loops.

Public workflow (mirrors the reference notebook):

    >>> import tpumcia
    >>> objs = tpumcia.load_objects("objects_dir/")          # h5 contract
    >>> fm = tpumcia.extract_features(objs.images, mask=objs.masks)
    >>> head = tpumcia.fit_head(fm, objs.labels)
    >>> imp = tpumcia.channel_importance(head, fm)
"""

from tpumcia.version import __version__
from tpumcia.config import (
    PipelineConfig,
    FeatureConfig,
    GLCMConfig,
    HeadConfig,
    SynthConfig,
)
from tpumcia.features.extract import (
    extract_features,
    extract_features_batched,
    extract_features_pending,
    FeatureMatrix,
)
from tpumcia.api import (
    load_objects,
    fit_head,
    channel_importance,
    feature_importance,
    run_pipeline,
    analyze_objects,
)

__all__ = [
    "__version__",
    "PipelineConfig",
    "FeatureConfig",
    "GLCMConfig",
    "HeadConfig",
    "SynthConfig",
    "extract_features",
    "extract_features_batched",
    "extract_features_pending",
    "FeatureMatrix",
    "load_objects",
    "fit_head",
    "channel_importance",
    "feature_importance",
    "run_pipeline",
    "analyze_objects",
]

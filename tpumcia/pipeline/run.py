"""End-to-end pipeline runner mirroring the reference notebook workflow:

    load -> (synthesize channels) -> extract features -> split -> scale ->
    fit head -> classification report -> feature + channel importance

(cells 5..28 of the reference, driven by one :class:`PipelineConfig`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from tpumcia.config import PipelineConfig
from tpumcia.features.extract import FeatureMatrix, extract_features
from tpumcia.importance.channels import ChannelImportanceResult, channel_importance
from tpumcia.models.heads import fit_head
from tpumcia.utils.metrics import accuracy, classification_report
from tpumcia.utils.split import train_test_split_indices


@dataclass
class PipelineResult:
    features: FeatureMatrix
    head: Any
    test_accuracy: float
    report: str
    channel_result: ChannelImportanceResult
    feature_result: ChannelImportanceResult | None
    train_idx: np.ndarray
    test_idx: np.ndarray
    timings: dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        lines = [
            f"objects: {len(self.features)}  features: {self.features.shape[1]}",
            f"test accuracy: {self.test_accuracy:.4f}",
            self.channel_result.summary(),
        ]
        return "\n".join(lines)


def _fast_path_ok(cfg: PipelineConfig, images, mask, mesh) -> bool:
    """The fused fast path: device-resident features + one-dispatch
    logistic head fit/sweeps (the round-2 bench plumbing, productized)."""
    from tpumcia.features.extract import batched_fast_path_ok

    if mesh is not None:
        if cfg.fast_path == "always":
            # never silently downgrade an explicit request: the fused path
            # is single-device by design (device-resident features + one
            # local dispatch); SPMD runs use the sharded classic pipeline
            raise ValueError(
                "fast_path='always' is single-device but the mesh config "
                f"resolved {mesh.shape}; set mesh data=1/model=1 (or "
                "fast_path='auto')"
            )
        return False
    if cfg.fast_path == "never":
        return False
    if cfg.head.kind != "logistic" or cfg.normalize != "minmax":
        return False
    if cfg.importance.channel_match != "exact":
        return False  # substring-compat grouping needs the classic path
    if cfg.importance.channel_method != "permutation":
        return False  # the fused dispatch bakes the permutation sweeps
    if cfg.synth.noise_channels > 0 and (images.ndim != 3 or mask is not None):
        return False
    if cfg.synth.noise_channels == 0 and images.ndim != 4:
        return False
    if not batched_fast_path_ok(images.shape, cfg.features):
        return False
    return cfg.fast_path == "always" or len(images) > 4096


def _run_pipeline_fast(
    images, labels, *, mask, cfg, channel_names, groups
) -> PipelineResult:
    """Fused flow: per-batch extraction dispatches also produce a
    device-resident f32 feature block; the head fit + both permutation
    sweeps are ONE further dispatch enqueued BEFORE the wire fetches (its
    compute overlaps the feature-matrix D2H)."""
    from tpumcia.features import registry
    from tpumcia.features.extract import extract_features_pending
    from tpumcia.models.fused import fit_logistic_with_importance

    labels = np.asarray(labels)
    timings: dict[str, float] = {}
    synth_n = cfg.synth.noise_channels

    t0 = time.perf_counter()
    pending = extract_features_pending(
        images, mask,
        batch_size=cfg.batch_size, config=cfg.features,
        channel_names=channel_names, keep_device_values=True,
        synth_noise=synth_n, synth_var=cfg.synth.var,
        synth_seed=cfg.synth.seed,
    )
    X_dev = pending.device_values

    split = train_test_split_indices(
        pending.n,
        test_size=cfg.split.test_size,
        seed=cfg.split.seed,
        stratify=labels if cfg.split.stratify else None,
        groups=groups if cfg.split.group_by else None,
    )
    col_groups = registry.columns_by_channel_positional(pending.num_channels)
    fit_pending = fit_logistic_with_importance(
        X_dev, labels,
        train_idx=split.train_idx, test_idx=split.test_idx,
        groups=col_groups, names=pending.names,
        head_config=cfg.head, importance_config=cfg.importance,
        channel_names=pending.channel_names, defer=True,
    )
    fm = pending.result()  # concurrent wire fetches overlap the head dispatch
    timings["features_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = fit_pending.result()  # the one packed head/sweep fetch
    y_te = labels[split.test_idx]
    test_acc = accuracy(y_te, res.y_pred)
    report = classification_report(y_te, res.y_pred)
    timings["fit_s"] = time.perf_counter() - t0
    timings["importance_s"] = 0.0  # fused into the fit dispatch

    return PipelineResult(
        features=fm,
        head=res.head,
        test_accuracy=test_acc,
        report=report,
        channel_result=res.channel_result,
        feature_result=res.feature_result,
        train_idx=split.train_idx,
        test_idx=split.test_idx,
        timings=timings,
    )


def run_pipeline(
    images,
    labels,
    *,
    mask=None,
    config: PipelineConfig | None = None,
    channel_names: list[str] | None = None,
    groups: np.ndarray | None = None,
) -> PipelineResult:
    """Run the full analysis on a batch of level-quantised images.

    ``groups``: optional per-object group ids (donor/experiment) for grouped
    splitting (h5 contract, BASELINE.json config 4).

    With ``config.mesh`` resolving to more than one device (``data=-1`` uses
    all of them), the extraction, scaler fit, and permutation sweeps run SPMD
    over the mesh's ``data`` axis (SURVEY.md §2.4).

    With ``config.synth.noise_channels > 0``, ``images`` is a (B, H, W)
    grayscale batch and the noise channels are synthesized on device
    (seeded; the reference's ``add_two_noise_channels``, ipynb:148-156).

    Large single-device logistic/minmax runs take the fused fast path
    (``config.fast_path``): device-resident features, one-dispatch head fit
    + permutation sweeps — the headline-benchmark plumbing as the public
    API.
    """
    from tpumcia.config import coerce_config
    from tpumcia.parallel.mesh import mesh_from_config

    cfg = coerce_config(config)
    labels = np.asarray(labels)
    timings: dict[str, float] = {}
    mesh = mesh_from_config(cfg.mesh)

    if cfg.split.group_by and groups is None:
        # silently degrading to an ungrouped split would leak groups
        # (donors) across train/test and report optimistically-biased
        # accuracy with no sign anything went wrong
        raise ValueError(
            f"split.group_by={cfg.split.group_by!r} but no groups were "
            "provided (h5 objects without that metadata key?) — pass "
            "groups= or clear split.group_by"
        )
    if cfg.synth.noise_channels > 0 and mask is not None:
        # the fused path forbids this combination outright; the classic
        # path would silently mask the synthesized noise channels too,
        # giving the same dataset different noise features depending on
        # whether a mask was passed
        raise ValueError(
            "synth.noise_channels does not compose with masks: noise "
            "channels are synthesized full-frame (the reference's "
            "add_two_noise_channels has no mask concept, ipynb:148-156)"
        )

    images_arr = images if hasattr(images, "shape") else np.asarray(images)
    # validate shape agreement up front: rank/length mismatches otherwise
    # surface as opaque transpose/index errors deep in the sharded
    # extraction or the split
    want_ndim = 3 if cfg.synth.noise_channels > 0 else 4
    if images_arr.ndim != want_ndim:
        expected = "(B, H, W) grayscale (synth.noise_channels > 0)" \
            if want_ndim == 3 else "(B, H, W, C)"
        raise ValueError(
            f"run_pipeline expects {expected} images; got shape "
            f"{tuple(images_arr.shape)}"
        )
    n_objects = images_arr.shape[0]
    if n_objects == 0:
        raise ValueError("run_pipeline needs at least one image; got 0")
    if labels.shape[:1] != (n_objects,):
        raise ValueError(
            f"labels length {labels.shape[0] if labels.ndim else 0} does "
            f"not match the {n_objects} images"
        )
    if groups is not None and np.asarray(groups).shape[:1] != (n_objects,):
        raise ValueError(
            f"groups length {len(np.asarray(groups))} does not match the "
            f"{n_objects} images"
        )
    if _fast_path_ok(cfg, images_arr, mask, mesh):
        return _run_pipeline_fast(
            images_arr, labels, mask=mask, cfg=cfg,
            channel_names=channel_names, groups=groups,
        )

    if cfg.synth.noise_channels > 0:
        if images_arr.ndim != 3:
            raise ValueError(
                "synth.noise_channels expects (B, H, W) grayscale input"
            )
        from tpumcia.preprocess.synth import add_noise_channels_batched

        # the SAME per-batch PRNG stream as the fused fast path, so the
        # synthesized dataset is identical on either path; stays a device
        # array (no host round trip of ~12 KB/image)
        images = add_noise_channels_batched(
            images_arr,
            seed=cfg.synth.seed,
            batch_size=cfg.batch_size,
            num_noise=cfg.synth.noise_channels,
            var=cfg.synth.var,
        )

    t0 = time.perf_counter()
    if mesh is None and len(images) > 4096:
        # large single-device inputs: pipelined fixed-size batches (one
        # compiled shape, concurrent wire fetches) instead of one giant
        # collection-sized dispatch
        from tpumcia.features.extract import extract_features_batched

        fm = extract_features_batched(
            images, mask=mask, config=cfg.features,
            channel_names=channel_names, batch_size=cfg.batch_size,
        )
    else:
        fm = extract_features(
            images, mask=mask, config=cfg.features,
            channel_names=channel_names, mesh=mesh,
        )
    timings["features_s"] = time.perf_counter() - t0

    # fetch_to_host handles cross-process (precision='device' on a
    # multi-process mesh) feature values that np.asarray cannot
    from tpumcia.features.finalize import fetch_to_host

    X = np.nan_to_num(
        np.asarray(fetch_to_host(fm.values), dtype=np.float32)
    )
    split = train_test_split_indices(
        len(X),
        test_size=cfg.split.test_size,
        seed=cfg.split.seed,
        stratify=labels if cfg.split.stratify else None,
        groups=groups if cfg.split.group_by else None,
    )

    t0 = time.perf_counter()
    scaler = None
    if mesh is not None and cfg.normalize == "minmax":
        from tpumcia.parallel.sharding import fit_scaler_sharded

        scaler = fit_scaler_sharded(X[split.train_idx], mesh=mesh)
    head = fit_head(
        X[split.train_idx],
        labels[split.train_idx],
        config=cfg.head,
        scale=cfg.normalize == "minmax",
        scaler=scaler,
    )
    timings["fit_s"] = time.perf_counter() - t0

    pred = head.predict(X[split.test_idx])
    test_acc = accuracy(labels[split.test_idx], pred)
    report = classification_report(labels[split.test_idx], pred)

    fm_test = FeatureMatrix(
        values=X[split.test_idx],
        names=fm.names,
        num_channels=fm.num_channels,
        degenerate=None,
        config=fm.config,
        channel_names=fm.channel_names,
    )

    t0 = time.perf_counter()
    channel_res = channel_importance(
        head,
        fm_test,
        labels[split.test_idx],
        method=cfg.importance.channel_method,
        config=cfg.importance,
        mesh=mesh,
    )
    # per-feature view (notebook cell 28, ipynb:493-505): MDI for forests,
    # per-feature permutation sweep otherwise (NOT the grouped channel sweep
    # again — that both duplicated compute and rendered all-zero plots)
    from tpumcia.models.heads import RandomForestHead

    feature_method = (
        "mdi" if isinstance(head, RandomForestHead) else "permutation_features"
    )
    feature_res = channel_importance(
        head,
        fm_test,
        labels[split.test_idx],
        method=feature_method,
        config=cfg.importance,
        mesh=mesh,
    )
    timings["importance_s"] = time.perf_counter() - t0

    return PipelineResult(
        features=fm,
        head=head,
        test_accuracy=test_acc,
        report=report,
        channel_result=channel_res,
        feature_result=feature_res,
        train_idx=split.train_idx,
        test_idx=split.test_idx,
        timings=timings,
    )

"""Config-driven evaluation entry point.

The reference's ``.gitignore`` names a planned-but-never-committed
``configs/sample_config.json`` and ``eval.sh`` (SURVEY.md §0.2); this module
is that capability: run the full pipeline from a JSON config over an h5
object directory, a MedNIST-style image folder, or the synthetic demo set.

    python -m tpumcia.eval --config configs/sample_config.json
    python -m tpumcia.eval --data /path/to/objects --source h5
    python -m tpumcia.eval --source synthetic --n-per-class 200 --plots out/
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_data(args, cfg):
    if args.source == "h5":
        from tpumcia.io.h5 import load_objects
        from tpumcia.preprocess.normalize import quantize_to_levels

        objs = load_objects(args.data, limit=args.limit)
        images = np.asarray(objs.images)
        if images.dtype == np.uint16:
            images = np.asarray(
                quantize_to_levels(images, levels=cfg.features.glcm.levels,
                                   src_levels=65536)
            )
        labels = objs.labels
        if labels is None:
            raise SystemExit("h5 objects carry no labels")
        groups = objs.donors if cfg.split.group_by == "donor" else (
            objs.experiments if cfg.split.group_by == "experiment" else None
        )
        return images, labels, objs.masks, objs.channels, groups

    if args.source == "folder":
        import jax

        from tpumcia.io.mednist import index_image_folder, load_images
        from tpumcia.preprocess.synth import add_noise_channels

        idx = index_image_folder(args.data)
        files = idx.files[: args.limit] if args.limit else idx.files
        labels = idx.labels[: len(files)]
        gray = load_images(files)
        named = np.asarray(idx.class_names)[labels]
        if cfg.synth.noise_channels > 0:
            # config-driven synthesis: hand run_pipeline the grayscale
            # batch so the seeded noise channels are synthesized on device
            # per cfg.synth (fused into extraction on the fast path) —
            # eagerly pre-building channels here both ignored cfg.synth
            # and made any synth-enabled config crash on 4D input
            return np.asarray(gray), named, None, None, None
        images = np.asarray(
            add_noise_channels(gray, jax.random.key(cfg.seed))
        )
        return images, named, None, None, None

    # synthetic demo
    from tpumcia.io.synthetic import synthetic_mednist, synthetic_multichannel

    if cfg.synth.noise_channels > 0:
        # grayscale demo set; run_pipeline synthesizes the noise channels
        # on device per cfg.synth (same routing as the folder source)
        gray, labels, class_names = synthetic_mednist(
            args.n_per_class, seed=cfg.seed
        )
        return np.asarray(gray), np.asarray(class_names)[labels], None, None, None
    images, labels, class_names = synthetic_multichannel(
        args.n_per_class, seed=cfg.seed
    )
    return images, np.asarray(class_names)[labels], None, None, None


def main(argv=None) -> int:
    from tpumcia.config import PipelineConfig
    from tpumcia.pipeline.run import run_pipeline
    from tpumcia.utils.logging import MetricsLogger

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="JSON PipelineConfig")
    p.add_argument("--data", type=str, default=None, help="data directory")
    p.add_argument(
        "--source", choices=("h5", "folder", "synthetic"), default="synthetic"
    )
    p.add_argument("--n-per-class", type=int, default=200)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--plots", type=str, default=None, help="figure output dir")
    p.add_argument("--metrics", type=str, default=None, help="JSONL metrics file")
    p.add_argument(
        "--profile", type=str, default=None,
        help="capture a jax profiler trace of the pipeline into this dir",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help=(
            "initialize the multi-host JAX runtime before building the mesh "
            "(jax.distributed.initialize; coordinator/process topology from "
            "TPUMCIA_COORDINATOR / TPUMCIA_NUM_PROCESSES / "
            "TPUMCIA_PROCESS_ID — see launch_eval.sh)"
        ),
    )
    args = p.parse_args(argv)

    if args.distributed:
        from tpumcia.parallel.distributed import init_distributed, process_summary

        multi = init_distributed()
        print(f"distributed: {process_summary()}"
              + ("" if multi else " (single process: no coordinator configured)"))

    if args.config and not Path(args.config).exists():
        p.error(f"config file not found: {args.config}")
    if args.config:
        try:
            cfg = PipelineConfig.from_json(args.config)
        except (ValueError, TypeError, KeyError) as e:
            p.error(f"invalid config {args.config}: {e}")
    else:
        cfg = PipelineConfig()
    if args.source in ("h5", "folder") and not args.data:
        p.error(f"--data is required for source={args.source}")

    log = MetricsLogger(args.metrics)
    images, labels, masks, channel_names, groups = _load_data(args, cfg)
    log.log("data_loaded", n=len(images), shape=list(images.shape))

    if args.profile:
        from tpumcia.utils.profiling import capture_trace

        with capture_trace(args.profile):
            result = run_pipeline(
                images, labels, mask=masks, config=cfg,
                channel_names=channel_names, groups=groups,
            )
        print(f"profiler trace in {args.profile}")
    else:
        result = run_pipeline(
            images, labels, mask=masks, config=cfg,
            channel_names=channel_names, groups=groups,
        )
    log.log(
        "pipeline_done",
        test_accuracy=result.test_accuracy,
        channel_ranking=[int(c) for c in result.channel_result.ranking],
        timings=result.timings,
    )
    print(result.report)
    print(result.channel_result.summary())

    if args.plots:
        out = Path(args.plots)
        out.mkdir(parents=True, exist_ok=True)
        from tpumcia.reports import plots

        if result.feature_result is not None:
            fig = plots.plot_top_features(
                result.feature_result.feature_importances, result.features.names
            )
            fig.savefig(out / "top_features.png", dpi=120)
            fig2 = plots.plot_channel_importance(result.feature_result)
            fig2.savefig(out / "channel_importance.png", dpi=120)
        perm = result.channel_result.extras.get("permutation")
        if perm is not None:
            fig3 = plots.plot_channel_importance(result.channel_result)
            fig3.savefig(out / "channel_permutation.png", dpi=120)
        print(f"figures written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headline benchmark: feature extraction + channel importance throughput.

Replicates the reference's measured workload (BASELINE.md): 12 000 images,
64x64, 3 channels (1 signal + 2 synthesized noise), 23 features x 3 channels,
classifier head, and permutation channel importance — the notebook does this
at 53.46 images/s on one CPU core (ipynb:353).

The timed section is ONE public-API call: ``run_pipeline`` on its fused fast
path (device-synthesized noise channels, per-batch fused extraction with the
device-resident f32 feature block, one-dispatch logistic fit + both
permutation sweeps enqueued before the wire fetches). There is no
bench-private pipeline — what this prints is what a library user gets.

One process, on a GPU only: without one it exits non-zero and prints no
result. Every rep is kept in ``rep_spread_s``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": N,
   "detail": {...}}
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_IMAGES_PER_SEC = 53.46  # ipynb:353, single CPU core
N_IMAGES = 12_000
BATCH = 2_048
REPS = 8


def main() -> int:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(
            f"bench.py: needs an NVIDIA GPU; jax found {len(devs)} "
            f"{devs[0].platform} device(s)",
            file=sys.stderr,
        )
        return 2

    from tpumcia.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import numpy as np

    from tpumcia.config import (
        HeadConfig,
        MeshConfig,
        PipelineConfig,
        SplitConfig,
        SynthConfig,
    )
    from tpumcia.io.synthetic import synthetic_mednist
    from tpumcia.pipeline.run import run_pipeline

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()

    # data generation and the H2D staging of the grayscale batch are untimed
    gray, labels, _ = synthetic_mednist(N_IMAGES // 6, num_classes=6, seed=0)
    gray_dev = jax.device_put(gray)

    cfg = PipelineConfig(
        mesh=MeshConfig(data=1, model=1),
        synth=SynthConfig(noise_channels=2, seed=0),
        head=HeadConfig(kind="logistic", num_steps=300),
        split=SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path="always",
        batch_size=BATCH,
    )

    # warm-up: compiles every stage at the real shapes
    run_pipeline(gray_dev, labels, config=cfg)

    times = []
    result = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        result = run_pipeline(gray_dev, labels, config=cfg)
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    rate = len(gray) / elapsed

    chan_total = result.channel_result.total
    feat_chan_total = np.array(
        [
            result.feature_result.feature_importances[cols].sum()
            for cols in result.features.channel_columns()
        ]
    )
    ok_ranking = bool(
        int(np.argmax(chan_total)) == 0 and int(np.argmax(feat_chan_total)) == 0
    )

    print(
        json.dumps(
            {
                "metric": "feature_extraction_plus_channel_importance_throughput",
                "value": round(rate, 2),
                "unit": "images/sec",
                "vs_baseline": round(rate / BASELINE_IMAGES_PER_SEC, 2),
                "detail": {
                    "platform": devs[0].platform,
                    "device_kind": devs[0].device_kind,
                    "device_count": len(devs),
                    "card": card,
                    "n_images": len(gray),
                    "elapsed_s": round(elapsed, 4),
                    "rep_spread_s": [round(t, 4) for t in times],
                    "test_accuracy": round(result.test_accuracy, 4),
                    "signal_channel_ranked_first": ok_ranking,
                    "timed_scope": (
                        "run_pipeline(synth+features+fetch+head+importance"
                        "+report); excludes data-gen and H2D staging "
                        "(reference includes disk decode)"
                    ),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

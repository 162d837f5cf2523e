"""Peak rates of the accelerator and the CNN path's FLOP count.

``PEAKS`` holds the published dense peaks of each supported device, keyed by
``jax.devices()[0].device_kind``; a device that is not in the table is an
error, not a default. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM
part, dense rates without sparsity, at the full 700 W power limit. A card
set below that limit (``nvidia-smi --query-gpu=power.limit``) cannot hold
its top clock under a matrix-heavy load, so state every share of these peaks
with the card's power limit beside it.

MACs are counted as 2 ops (mul+add), the standard FLOP convention.

Usage:
  python benchmarks/mfu.py --device-kind "NVIDIA H100 80GB HBM3" \
      [--cnn TRAIN_IMG_S OCC_IMG_S]
"""

from __future__ import annotations

import argparse

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp16_flops": 989e12,
        "fp8_flops": 1979e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 900e9,
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table of ``device_kind``; raises for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def resnet_fwd_macs(
    *,
    width: int = 32,
    h: int = 64,
    w: int = 64,
    channels: int = 3,
    classes: int = 6,
    stages: tuple = (2, 2, 2, 2),
) -> int:
    """Per-image forward MACs of models/cnn.py::ResNet (convs + classifier;
    GroupNorm/relu/pool are bandwidth-trivial next to the convs).

    Mirrors the module structure: 3x3 stem at full resolution, then stages
    of residual blocks — stage s has ``width * 2**s`` features, downsampling
    by 2 at its first block (stage > 0), whose shape change also adds a 1x1
    projection conv. This is the dense count (every output position pays all
    9 taps); XLA's compiled cost_analysis, which discounts the SAME-padding
    border taps, counts 4.1% lower (1.069 vs 1.114 GFLOP fwd) — so a
    utilization derived from this count overstates by ~4%."""
    macs = h * w * 9 * channels * width  # stem
    f_in, hh, ww = width, h, w
    for s, blocks in enumerate(stages):
        f = width * (2**s)
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            hh2, ww2 = hh // stride, ww // stride
            macs += hh2 * ww2 * 9 * f_in * f  # conv1
            macs += hh2 * ww2 * 9 * f * f  # conv2
            if f_in != f or stride != 1:
                macs += hh2 * ww2 * 1 * f_in * f  # 1x1 proj
            f_in, hh, ww = f, hh2, ww2
    macs += f_in * classes  # classifier dense
    return macs


def cnn_table(
    device_kind: str,
    train_img_s: float | None = None,
    occ_img_s: float | None = None,
) -> str:
    """CNN path rows (ResNet-18 width 32, 64x64x3, 6 classes) against the
    device's bf16 peak.

    Train step FLOPs = 3x forward (activation + weight gradients each
    re-pay the forward's MACs — the standard dense-training rule); the
    occlusion sweep is forward-only but evaluates C+1 variants (baseline +
    one per zeroed channel) per image. Pass measured img/s to get the
    achieved bf16 share of the peak."""
    peak = peaks(device_kind)["bf16_flops"]
    fwd = resnet_fwd_macs()
    train, occ = 6 * fwd, (3 + 1) * 2 * fwd
    rows = [
        f"- ResNet-18 width 32, 64x64x3: forward = {2 * fwd / 1e9:.2f} "
        f"GFLOP/img (dense conv count; XLA's padding-aware count is 4% lower)",
        f"- train step = {train / 1e9:.2f} GFLOP/img (3x fwd), bound "
        f"{train / peak * 1e6:.2f} us/img at {peak / 1e12:.0f} bf16 TFLOP/s",
        f"- occlusion sweep = {occ / 1e9:.2f} GFLOP/img (C+1 = 4 forwards), "
        f"bound {occ / peak * 1e6:.2f} us/img",
    ]
    for what, flops, rate in (("train", train, train_img_s),
                              ("occlusion", occ, occ_img_s)):
        if rate:
            rows.append(
                f"- measured {what} {rate:.1f} img/s -> "
                f"{flops * rate / 1e12:.2f} bf16 TFLOP/s = "
                f"{100 * flops * rate / peak:.2f}% of peak"
            )
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", required=True)
    ap.add_argument("--cnn", nargs=2, type=float, metavar=("TRAIN", "OCC"))
    args = ap.parse_args()
    print(cnn_table(args.device_kind, *(args.cnn or ())))


if __name__ == "__main__":
    main()

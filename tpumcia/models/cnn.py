"""ResNet-18-style CNN classifier with a C-channel input stem.

BASELINE.json config 3: "Small CNN (ResNet-18-style, C-channel input conv)
classifier + occlusion/permutation channel importance". The reference
has no CNN (hand-crafted features + RF only); this is the framework's learned
-feature path for multichannel cell images.

Design choices:
* bfloat16 compute / float32 params (tensor-core mixed precision)
* GroupNorm instead of BatchNorm — no cross-device batch statistics, so the
  train step shards over the ``data`` mesh axis without extra collectives
  beyond the gradient psum
* CIFAR-style 3x3 stem (stride 1, no max-pool): inputs are 64x64 cell crops,
  not 224x224 ImageNet frames
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp


def _num_groups(features: int) -> int:
    """Largest group count <= 32 dividing ``features`` (flax GroupNorm
    requires divisibility; min(32, f) crashed init for widths like 48)."""
    g = min(32, features)
    while features % g:
        g -= 1
    return g


class ResidualBlock(nn.Module):
    features: int
    strides: int = 1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        residual = x
        y = nn.Conv(
            self.features, (3, 3), strides=(self.strides, self.strides),
            use_bias=False, dtype=self.dtype, name="conv1",
        )(x)
        y = nn.GroupNorm(num_groups=_num_groups(self.features), dtype=self.dtype)(y)
        y = nn.relu(y)
        y = nn.Conv(
            self.features, (3, 3), use_bias=False, dtype=self.dtype, name="conv2"
        )(y)
        y = nn.GroupNorm(num_groups=_num_groups(self.features), dtype=self.dtype)(y)
        if residual.shape != y.shape:
            residual = nn.Conv(
                self.features, (1, 1), strides=(self.strides, self.strides),
                use_bias=False, dtype=self.dtype, name="proj",
            )(residual)
            residual = nn.GroupNorm(
                num_groups=_num_groups(self.features), dtype=self.dtype
            )(residual)
        return nn.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-18-style: stages (2, 2, 2, 2) of residual blocks."""

    num_classes: int
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    width: int = 64
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        # x: (B, H, W, C) float in [0, 1]; C is arbitrary (the multichannel stem)
        x = x.astype(self.dtype)
        x = nn.Conv(self.width, (3, 3), use_bias=False, dtype=self.dtype,
                    name="stem")(x)
        x = nn.GroupNorm(num_groups=_num_groups(self.width), dtype=self.dtype)(x)
        x = nn.relu(x)
        for stage, num_blocks in enumerate(self.stage_sizes):
            features = self.width * (2**stage)
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                x = ResidualBlock(
                    features, strides=strides, dtype=self.dtype,
                    name=f"stage{stage}_block{block}",
                )(x)
        x = jnp.mean(x, axis=(1, 2))  # global average pool
        x = nn.Dense(self.num_classes, dtype=jnp.float32, name="classifier")(x)
        return x  # (B, num_classes) float32 logits


def make_resnet(num_classes: int, *, width: int = 64, depth: str = "18",
                dtype=jnp.bfloat16) -> ResNet:
    stages = {
        "10": (1, 1, 1, 1),
        "18": (2, 2, 2, 2),
        "34": (3, 4, 6, 3),
    }[depth]
    return ResNet(num_classes=num_classes, stage_sizes=stages, width=width,
                  dtype=dtype)

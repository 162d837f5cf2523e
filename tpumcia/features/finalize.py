"""Finalise sufficient statistics into the reference feature values.

Two backends share one formula implementation:

* ``backend='host'`` — numpy float64 on the (tiny) statistics arrays. Because
  every statistic is an exact integer, this reproduces the reference's
  float64 numpy/scipy results (ipynb:220-311) to ~1e-9 MAE — the histograms
  carry *all* information the reference formulas use, since pixel values are
  level-quantised (SURVEY.md §2.3).
* ``backend='device'`` — the same formulas in jnp float32 under jit, for fully
  device-resident streaming pipelines where the feature matrix feeds a head
  directly and ~1e-6 relative accuracy is irrelevant.

Feature order matches ``registry``: 17 intensity features x channel, then 6
GLCM features x channel.

Deliberate reference-quirk handling:
* percentile q values are 0.1..0.9, not 10..90 (ipynb:242-250) — replicated.
* scipy ``skew``/``kurtosis`` (bias=True, fisher=True) return NaN for a
  zero-variance channel — replicated on the host backend.
* an all-zero channel makes the reference's GLCM rescale divide 0/0
  (ipynb:294); here it deterministically yields contrast=dissimilarity=0,
  homogeneity=ASM=energy=correlation=1, and the channel is flagged degenerate.
* empty masks (count==0) yield zeros and a degenerate flag instead of the
  reference's NaN-propagating behaviour.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpumcia.features.stats import SuffStats, glcm_sumsq_value

_QS = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])


def _intensity_block(hist, count, xp, dtype):
    """(B, C, L) histogram + (B, C) count -> (B, C, 17) intensity features."""
    B, C, L = hist.shape
    top = float(L - 1)
    lev = xp.arange(L).astype(dtype)
    n = count.astype(dtype)
    safe_n = xp.maximum(n, 1)
    empty = n == 0

    nz = hist > 0
    min_lev = xp.argmax(nz, axis=-1).astype(dtype)
    max_lev = (L - 1) - xp.argmax(nz[..., ::-1], axis=-1).astype(dtype)
    min_v = xp.where(empty, 0, min_lev / top)
    max_v = xp.where(empty, 0, max_lev / top)

    # numpy-linear-interpolated percentiles from the exact CDF. The reference
    # passes q = 0.1..0.9 (the 0.1th..0.9th percentiles — ipynb:242-250).
    cdf = xp.cumsum(hist.astype(dtype), axis=-1)  # (B, C, L)
    qs = xp.asarray(_QS).astype(dtype)
    pos = qs[None, None, :] / 100.0 * (safe_n[..., None] - 1)  # (B, C, 9)
    k_lo = xp.floor(pos)
    k_hi = xp.ceil(pos)
    frac = pos - k_lo

    def value_at(k):  # k: (B, C, 9) sorted-order index -> level index
        return xp.sum(cdf[:, :, None, :] <= k[..., None], axis=-1).astype(dtype)

    v_lo = value_at(k_lo)
    v_hi = value_at(k_hi)
    pct = (v_lo + frac * (v_hi - v_lo)) / top  # (B, C, 9)
    pct = xp.where(empty[..., None], 0, pct)

    hist_d = hist.astype(dtype)
    total = xp.sum(hist_d * lev, axis=-1) / top
    mean = total / safe_n
    dev = lev[None, None, :] / top - mean[..., None]
    # explicit multiplies: numpy lowers non-square ** through slow pow()
    dev2 = dev * dev
    hd2 = hist_d * dev2
    m2 = xp.sum(hd2, axis=-1) / safe_n
    m3 = xp.sum(hd2 * dev, axis=-1) / safe_n
    m4 = xp.sum(hd2 * dev2, axis=-1) / safe_n
    std = xp.sqrt(m2)
    # zero-variance must be detected EXACTLY (single occupied level), not
    # via m2 == 0: mean is a rounded quotient here, so a constant nonzero
    # channel can give m2 = O(eps) and return kurt=-2/skew=+-1 instead of
    # the scipy NaN contract (which the hybrid backend — exact integer
    # mean numerators — gets right; the backends must agree)
    zero_var = (min_lev == max_lev) | (m2 == 0)
    safe_m2 = xp.where(zero_var, 1, m2)
    nan = xp.full_like(m2, np.nan)
    kurt = xp.where(zero_var, nan, m4 / (safe_m2 * safe_m2) - 3.0)
    skew = xp.where(zero_var, nan, m3 / safe_m2**1.5)

    p = hist_d / safe_n[..., None]
    plogp = xp.where(p > 0, p * xp.log2(xp.where(p > 0, p, 1)), 0)
    entropy = -xp.sum(plogp, axis=-1)

    z = lambda a: xp.where(empty, 0, a)
    feats = xp.stack(
        [min_v]
        + [pct[..., i] for i in range(9)]
        + [max_v, z(total), z(mean), z(std),
           xp.where(empty, 0, kurt), xp.where(empty, 0, skew), z(entropy)],
        axis=-1,
    )
    return feats  # (B, C, 17)


def _glcm_block(marg_l, marg_r, diff_hist, sumsq, npairs, xp, dtype):
    """GLCM sufficient stats -> (B, C, 6) [contrast, dissimilarity,
    homogeneity, ASM, energy, correlation], skimage ``graycoprops`` semantics
    (ipynb:301-306).

    The quadratic sums below are elementwise products summed with ``xp.sum``
    rather than ``@``: on a GPU a float32 matmul may run in TF32, which keeps
    10 mantissa bits, while ``i**2`` reaches 65,025 (16 significant bits).
    In float64 on the host the products are exact integers, so the sums are
    exact in any order."""
    L = marg_l.shape[-1]
    i = xp.arange(L).astype(dtype)
    i2 = i * i

    N = npairs.astype(dtype)
    safe_N = xp.maximum(N, 1)
    ml = marg_l.astype(dtype)
    mr = marg_r.astype(dtype)
    Pl = ml / safe_N[..., None]
    Pr = mr / safe_N[..., None]

    d = xp.arange(2 * L - 1).astype(dtype) - (L - 1)
    d2 = d * d
    dh = diff_hist.astype(dtype)
    Pd = dh / safe_N[..., None]  # (B, C, 2L-1)
    contrast = xp.sum(Pd * d2, axis=-1)
    dissimilarity = xp.sum(Pd * xp.abs(d), axis=-1)
    homogeneity = xp.sum(Pd / (1.0 + d2), axis=-1)
    s_d2 = xp.sum(dh * d2, axis=-1)
    asm = glcm_sumsq_value(sumsq, xp, dtype) / (safe_N * safe_N)
    energy = xp.sqrt(asm)

    mu_i = xp.sum(i * Pl, axis=-1)
    mu_j = xp.sum(i * Pr, axis=-1)
    di = i[None, None, :] - mu_i[..., None]
    dj = i[None, None, :] - mu_j[..., None]
    var_i = xp.sum(Pl * di * di, axis=-1)
    var_j = xp.sum(Pr * dj * dj, axis=-1)
    std_i, std_j = xp.sqrt(var_i), xp.sqrt(var_j)
    # sum_ij Cij * i*j, exactly, from the three (integer) histograms:
    # 2*S_ij = S_i2 + S_j2 - S_d2  since (i-j)^2 = i^2 + j^2 - 2ij.
    s_i2 = xp.sum(ml * i2, axis=-1)
    s_j2 = xp.sum(mr * i2, axis=-1)
    s_ij = (s_i2 + s_j2 - s_d2) / 2
    cov = s_ij / safe_N - mu_i * mu_j
    denom = std_i * std_j
    ok = (std_i > 1e-15) & (std_j > 1e-15)
    correlation = xp.where(ok, cov / xp.where(ok, denom, 1), 1.0)

    return xp.stack(
        [contrast, dissimilarity, homogeneity, asm, energy, correlation], axis=-1
    )


class FinalizedFeatures(NamedTuple):
    values: np.ndarray | jax.Array  # (B, F)
    degenerate: np.ndarray | jax.Array  # (B, C) bool: empty mask or all-zero channel


def _pack_for_transfer(stats: SuffStats) -> SuffStats:
    """Cast the integer-valued count histograms to the narrowest lossless
    dtype on device before the device->host fetch. Histogram bins are bounded
    by the per-channel pixel/pair count, so uint16 is lossless whenever the
    images have < 65536 pixels — half the transfer bytes on the D2H
    path."""
    if not isinstance(stats.hist, jax.Array):
        return stats
    # one tiny scalar sync decides the packing dtype
    u16_ok = bool(jnp.max(stats.count) < 65536)
    return _pack_jit(stats, narrow="uint16" if u16_ok else "int32")


@partial(jax.jit, static_argnames=("narrow",))
def _pack_jit(s: SuffStats, *, narrow: str) -> SuffStats:
    nd = jnp.dtype(narrow)
    return SuffStats(
        hist=s.hist.astype(nd),
        count=s.count.astype(jnp.int32),
        vmax=s.vmax,
        marg_l=s.marg_l.astype(nd),
        marg_r=s.marg_r.astype(nd),
        diff_hist=s.diff_hist.astype(nd),
        glcm_sumsq=s.glcm_sumsq,  # exact int32 limbs, not u16-representable
        pair_count=s.pair_count.astype(jnp.int32),
    )


def finalize_features(
    stats: SuffStats,
    *,
    include_intensity: bool = True,
    include_glcm: bool = True,
    backend: str = "host",
) -> FinalizedFeatures:
    """Reduce :class:`SuffStats` to the (B, 23*C) feature matrix.

    ``backend='host'``: float64 numpy (exact reference semantics); device
    inputs are narrowed losslessly before the fetch.
    ``backend='hybrid'``: the device reduces every (image, channel) to ~30
    scalars — exact integers (limb-split sums, integer percentile indices)
    plus float32 central moments with exact mean numerators — and the host
    assembles features with O(B*C) scalar float64 math. Accuracy ~1e-7
    relative (moments/entropy/homogeneity are f32-summed; everything else is
    exact); 256x less host work and ~40x less device->host transfer than
    'host'. Requires per-channel pixel counts < 65536.
    ``backend='device'``: float32 jnp under jit (device-resident).
    """
    if backend == "host":
        stats = _pack_for_transfer(stats)
        vals = list(stats)
        glb = [
            i for i, s in enumerate(vals)
            if isinstance(s, jax.Array) and not s.is_fully_addressable
        ]
        if glb:
            # cross-process stats: replicate ALL of them in one dispatch
            # instead of one allgather per field
            for i, g in zip(glb, _replicate_leaves([vals[i] for i in glb])):
                vals[i] = g
        stats = SuffStats(*(np.asarray(s) for s in vals))
        xp, dtype = np, np.float64
        return _finalize(stats, xp, dtype, include_intensity, include_glcm)
    if backend == "hybrid":
        from tpumcia.features.hybrid import finalize_hybrid

        return finalize_hybrid(
            stats, include_intensity=include_intensity, include_glcm=include_glcm
        )
    if backend == "device":
        return _finalize_device_jit(stats, include_intensity, include_glcm)
    raise ValueError(f"unknown backend {backend!r}")


@functools.lru_cache(maxsize=None)
def _replicate_jit(sharding):
    """Stable-identity jitted replicate-identity, cached per sharding: a
    fresh ``jax.jit`` closure per call would re-trace on every multi-host
    host-fetch."""
    return jax.jit(lambda *xs: xs, out_shardings=sharding)


def _replicate_leaves(leaves):
    """Replicate non-fully-addressable (cross-process) global arrays to
    every process in ONE jit dispatch; after this ``np.asarray`` is a
    plain local fetch. Falls back to per-leaf ``process_allgather`` for
    arrays without a ``NamedSharding`` mesh."""
    from jax.sharding import NamedSharding, PartitionSpec

    try:
        rep = NamedSharding(leaves[0].sharding.mesh, PartitionSpec())
        out = _replicate_jit(rep)(*leaves)
        return list(out) if isinstance(out, tuple) else [out]
    except (AttributeError, ValueError, TypeError):
        from jax.experimental.multihost_utils import process_allgather

        return [process_allgather(s, tiled=True) for s in leaves]


def fetch_to_host(s):
    """Device->host fetch that also handles cross-process (multi-host)
    global arrays: a non-fully-addressable array is replicated to every
    process first (np.asarray alone would raise). The shared rule for
    every finalize/extract host conversion."""
    if isinstance(s, jax.Array) and not s.is_fully_addressable:
        (s,) = _replicate_leaves([s])
    return np.asarray(s)


def _finalize(stats, xp, dtype, include_intensity, include_glcm):
    B, C = stats.count.shape[:2]
    blocks = []
    if include_intensity:
        intensity = _intensity_block(stats.hist, stats.count, xp, dtype)
        blocks.append(intensity.reshape(B, -1))
    if include_glcm:
        glcm = _glcm_block(
            stats.marg_l,
            stats.marg_r,
            stats.diff_hist,
            stats.glcm_sumsq,
            stats.pair_count,
            xp,
            dtype,
        )
        blocks.append(glcm.reshape(B, -1))
    values = xp.concatenate(blocks, axis=1)
    degenerate = (stats.count == 0) | (stats.vmax <= 0)
    return FinalizedFeatures(values=values, degenerate=degenerate)


@partial(jax.jit, static_argnums=(1, 2))
def _finalize_device_jit(stats, include_intensity, include_glcm):
    return _finalize(stats, jnp, jnp.float32, include_intensity, include_glcm)

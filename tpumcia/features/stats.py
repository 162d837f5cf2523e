"""Device-side sufficient statistics for the hand-crafted feature set.

Instead of translating the reference's ~20 per-channel numpy passes + Cython GLCM scatter
(ipynb:220-311), each (image, channel) is reduced **on device, in one jitted
pass** to a small set of *integer-valued* sufficient statistics:

* ``hist``      — L-bin histogram of raw levels            (intensity block)
* ``marg_l/r``  — GLCM marginal histograms of the rescaled left/right pixels
* ``diff_hist`` — histogram of (left - right) level differences
* ``glcm_sumsq``— sum of squared co-occurrence counts (for ASM/energy)
* counts, maxima, and mask-aware pair counts

Every statistic is an exactly-representable integer in float32 (counts and
count-weighted integer sums stay < 2^24 for the supported image sizes), so the
float64 host finalisation in ``finalize.py`` reproduces the reference's
numpy/scipy float64 arithmetic to ~1e-9 — far inside the 1e-5 MAE target —
while all pixel-touching work runs on the accelerator.

Histograms and co-occurrence counts are computed as one-hot contractions
(`einsum`) so XLA lowers them to matrix products with bf16 0/1 operands and
f32 accumulation (exact at any matmul precision), in place of the
scatter-style GLCM loop the reference delegates to Cython
(`skimage _glcm_loop`, ipynb:298).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SuffStats(NamedTuple):
    """Per-(image, channel) sufficient statistics. Leading dims (B, C)."""

    hist: jax.Array  # (B, C, L)    raw-level histogram (masked counts)
    count: jax.Array  # (B, C)       number of (masked) pixels
    vmax: jax.Array  # (B, C) i32   max raw level over masked pixels; -1 if none
    marg_l: jax.Array  # (B, C, L)    GLCM left-pixel marginal (rescaled levels)
    marg_r: jax.Array  # (B, C, L)    GLCM right-pixel marginal
    diff_hist: jax.Array  # (B, C, 2L-1) histogram of (left - right) + (L-1)
    glcm_sumsq: jax.Array  # (B, C, 4) i32 limbs of sum(count^2); see
    #                        glcm_sumsq_value — exact for pair counts < 2^24
    #                        (a raw f32 sum of squares loses integer exactness
    #                        once any co-occurrence cell exceeds 4096)
    pair_count: jax.Array  # (B, C)       number of valid (masked) pixel pairs


@functools.lru_cache(maxsize=8)
def rescale_lut(levels: int = 256) -> np.ndarray:
    """(levels, levels) int32 LUT of the reference's GLCM rescale.

    ``LUT[m, v]`` is the uint8 level the reference assigns to raw level ``v``
    in a channel whose max raw level is ``m``: the notebook computes
    ``(ch/255) / (ch.max()/255) * 255`` in float64 and truncates with
    ``astype(uint8)`` (ipynb:293-295). The float64 arithmetic is replicated
    bit-for-bit here on host, so the device path — a table lookup via one-hot
    matmul — is exact, including truncation edge cases. Row 0 (an all-zero
    channel, where the reference divides 0/0) is defined as all zeros; callers
    flag it as degenerate.
    """
    top = float(levels - 1)
    vals = np.arange(levels, dtype=np.float64) / top  # the /255. image values
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = (vals[None, :] / vals[:, None]) * top
    lut = np.clip(np.nan_to_num(scaled, nan=0.0, posinf=top), 0.0, top)
    lut = lut.astype(np.uint8 if levels <= 256 else np.int32).astype(np.int32)
    lut[0, :] = 0
    return lut


@functools.lru_cache(maxsize=8)
def rescale_lut_device(levels: int = 256):
    """Device-resident copy of :func:`rescale_lut` (cached — repeated
    pipeline calls must not re-upload the 256 KB table)."""
    return jnp.asarray(rescale_lut(levels))


def _glcm_sumsq_limbs(glcm_i32, reduce_axes, cheap=False):
    """Exact integer limbs of ``sum(G^2)`` over int32 co-occurrence counts.

    With ``c = a*2^12 + b`` (a = c >> 12, b = c & 4095):
    ``sum(c^2) = 2^24*sum(a^2) + 2^13*sum(a*b) + 2^8*sum((b^2)>>8)
    + sum((b^2)&255)``. Each partial sum stays < 2^31 for per-channel pair
    counts < 2^24 (sum(a^2) <= P^2/2^24, sum(ab) <= P, sum(b^2>>8) <= 16*P,
    sum(b^2&255) <= 255*L^2), so the int32 sums — and the float64 host
    reassembly in :func:`glcm_sumsq_value` — are exact.

    ``cheap`` (callers gate on H*W <= 4096 and levels <= 256): pair counts
    <= 2^12 make ``sum(G^2) <= sum(G)^2 <= 2^24`` exact in one i32 pass,
    emitted as the two low limbs with the hi limbs zero. The limb VALUES
    differ from the generic encoding but reassemble identically under
    :func:`glcm_sumsq_value`'s fixed 2^24/2^13/2^8/1 weights.
    """
    if cheap:
        s2 = jnp.sum(glcm_i32 * glcm_i32, axis=reduce_axes)
        z = jnp.zeros_like(s2)
        return jnp.stack([z, z, s2 >> 8, s2 & 255], axis=-1)
    a = glcm_i32 >> 12
    b = glcm_i32 & 4095
    bb = b * b
    return jnp.stack(
        [
            jnp.sum(a * a, axis=reduce_axes),
            jnp.sum(a * b, axis=reduce_axes),
            jnp.sum(bb >> 8, axis=reduce_axes),
            jnp.sum(bb & 255, axis=reduce_axes),
        ],
        axis=-1,
    )


def glcm_sumsq_value(limbs, xp=np, dtype=np.float64):
    """Reassemble the (.., 4) limbs of :func:`_glcm_sumsq_limbs` into
    ``sum(G^2)`` (use float64 on host for exactness)."""
    s = limbs.astype(dtype)
    return (
        s[..., 0] * 16777216.0
        + s[..., 1] * 8192.0
        + s[..., 2] * 256.0
        + s[..., 3]
    )


def _one_hot(values: jax.Array, size: int, dtype) -> jax.Array:
    """(..., P) int -> (..., P, size) one-hot; 0/1 are exact in any float dtype."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, size), 2)
    return (values[..., None] == iota).astype(dtype)


def _single_image_stats(
    img: jax.Array,  # (C, H, W) int32 raw levels
    weight: jax.Array,  # (C, H, W) {0,1} mask weights
    lut: jax.Array,  # (L, L) int32
    *,
    levels: int,
    offset: tuple[int, int],
    onehot_dtype,
    with_intensity: bool,
    with_glcm: bool,
) -> SuffStats:
    C, H, W = img.shape
    L = levels
    f32 = jnp.float32

    flat = img.reshape(C, H * W)
    wflat = weight.reshape(C, H * W).astype(onehot_dtype)

    oh_raw = _one_hot(flat, L, onehot_dtype)  # (C, HW, L)
    if with_intensity:
        hist = jnp.einsum("cpl,cp->cl", oh_raw, wflat, preferred_element_type=f32)
    else:
        hist = jnp.zeros((C, L), f32)
    count = jnp.sum(wflat.astype(f32), axis=1)
    vmax = jnp.max(jnp.where(weight > 0, img, -1), axis=(1, 2)).astype(jnp.int32)

    if not with_glcm:
        zL = jnp.zeros((C, L), f32)
        return SuffStats(
            hist,
            count,
            vmax,
            zL,
            zL,
            jnp.zeros((C, 2 * L - 1), f32),
            jnp.zeros((C, 4), jnp.int32),
            jnp.zeros((C,), f32),
        )

    # --- GLCM rescale: raw level -> reference uint8 level, via LUT row of the
    # channel max, applied with the already-built one-hot (a matvec).
    # HIGHEST precision: the LUT/row values reach L-1, which is NOT
    # bf16-representable above 256 — DEFAULT matmul precision would
    # silently truncate rescaled levels for levels > 256 configs
    hi_prec = jax.lax.Precision.HIGHEST
    row = jnp.einsum(
        "cl,lk->ck",
        _one_hot(jnp.clip(vmax, 0, L - 1)[:, None], L, onehot_dtype)[:, 0, :],
        lut.astype(f32),
        preferred_element_type=f32,
        precision=hi_prec,
    )  # (C, L) float-exact integers
    resc = jnp.einsum(
        "cpl,cl->cp", oh_raw, row, preferred_element_type=f32,
        precision=hi_prec,
    )
    resc = resc.astype(jnp.int32).reshape(C, H, W)

    marg_l, marg_r, diff_hist, glcm_sumsq, pair_count = _glcm_offset_stats(
        resc, weight, offset, L, onehot_dtype
    )
    return SuffStats(
        hist, count, vmax, marg_l, marg_r, diff_hist, glcm_sumsq, pair_count
    )


def _glcm_offset_stats(resc, weight, offset, L, onehot_dtype):
    """GLCM sufficient stats for one (dr, dc) offset on pre-rescaled levels.

    Shared by the single-offset path and the fused multi-offset path (the
    rescale/one-hot prologue is offset-independent and computed once).
    """
    f32 = jnp.float32
    C, H, W = resc.shape
    dr, dc = offset
    r0, r1 = max(0, -dr), H - max(0, dr)
    c0, c1 = max(0, -dc), W - max(0, dc)
    if r0 >= r1 or c0 >= c1:
        raise ValueError(f"GLCM offset {offset} leaves no valid pairs for {H}x{W}")
    left = resc[:, r0:r1, c0:c1].reshape(C, -1)
    right = resc[:, r0 + dr : r1 + dr, c0 + dc : c1 + dc].reshape(C, -1)
    wl = weight[:, r0:r1, c0:c1].reshape(C, -1)
    wr = weight[:, r0 + dr : r1 + dr, c0 + dc : c1 + dc].reshape(C, -1)
    pw = (wl * wr).astype(onehot_dtype)  # (C, P)

    oh_l = _one_hot(left, L, onehot_dtype) * pw[..., None]
    oh_r = _one_hot(right, L, onehot_dtype)
    marg_l = jnp.einsum("cpl->cl", oh_l.astype(f32))
    marg_r = jnp.einsum("cpl,cp->cl", oh_r, pw, preferred_element_type=f32)
    diff = left - right + (L - 1)  # in [0, 2L-2]
    diff_hist = jnp.einsum(
        "cpl,cp->cl", _one_hot(diff, 2 * L - 1, onehot_dtype), pw,
        preferred_element_type=f32,
    )
    # Full co-occurrence matrix as one matmul; only its sum of squares leaves
    # the op (needed for ASM/energy — the one prop not derivable from
    # marginals).
    glcm = jnp.einsum("cpi,cpj->cij", oh_l, oh_r, preferred_element_type=f32)
    glcm_sumsq = _glcm_sumsq_limbs(
        glcm.astype(jnp.int32), reduce_axes=(1, 2),
        cheap=H * W <= 4096 and L <= 256,
    )
    pair_count = jnp.sum(pw.astype(f32), axis=1)
    return marg_l, marg_r, diff_hist, glcm_sumsq, pair_count


def _single_image_stats_multi(
    img: jax.Array,  # (C, H, W) int32 raw levels
    weight: jax.Array,  # (C, H, W) {0,1} mask weights
    lut: jax.Array,
    *,
    levels: int,
    offsets: tuple[tuple[int, int], ...],
    onehot_dtype,
    with_intensity: bool,
) -> tuple[SuffStats, ...]:
    """Multi-offset sufficient statistics with the offset-independent work
    (raw one-hot, histogram, the reference rescale) computed ONCE and shared
    across all (distance, angle) offsets — a 4-offset extraction costs ~2x a
    single-offset one instead of 4x (skimage's list API, ipynb:298).

    Returns one SuffStats per offset; only the first carries the intensity
    histogram (the rest have zero hists, matching extract_features' layout).
    """
    C, H, W = img.shape
    L = levels
    f32 = jnp.float32

    flat = img.reshape(C, H * W)
    wflat = weight.reshape(C, H * W).astype(onehot_dtype)
    oh_raw = _one_hot(flat, L, onehot_dtype)
    if with_intensity:
        hist = jnp.einsum("cpl,cp->cl", oh_raw, wflat, preferred_element_type=f32)
    else:
        hist = jnp.zeros((C, L), f32)
    count = jnp.sum(wflat.astype(f32), axis=1)
    vmax = jnp.max(jnp.where(weight > 0, img, -1), axis=(1, 2)).astype(jnp.int32)

    hi_prec = jax.lax.Precision.HIGHEST  # LUT values > 256 aren't bf16-exact
    row = jnp.einsum(
        "cl,lk->ck",
        _one_hot(jnp.clip(vmax, 0, L - 1)[:, None], L, onehot_dtype)[:, 0, :],
        lut.astype(f32),
        preferred_element_type=f32,
        precision=hi_prec,
    )
    resc = jnp.einsum(
        "cpl,cl->cp", oh_raw, row, preferred_element_type=f32,
        precision=hi_prec,
    )
    resc = resc.astype(jnp.int32).reshape(C, H, W)

    out = []
    zero_hist = jnp.zeros((C, L), f32)
    for i, off in enumerate(offsets):
        parts = _glcm_offset_stats(resc, weight, off, L, onehot_dtype)
        out.append(
            SuffStats(hist if i == 0 else zero_hist, count, vmax, *parts)
        )
    return tuple(out)


@functools.partial(
    jax.jit,
    static_argnames=(
        "levels", "offsets", "chunk_size", "onehot_dtype", "with_intensity"
    ),
)
def _sufficient_stats_multi_jit(
    img, w, lut, *, levels, offsets, chunk_size, onehot_dtype, with_intensity
):
    if w is None:  # maskless: broadcast inside the jit, never an HBM array
        w = jnp.ones(img.shape, jnp.float32)
    fn = functools.partial(
        _single_image_stats_multi,
        lut=lut,
        levels=levels,
        offsets=offsets,
        onehot_dtype=jnp.dtype(onehot_dtype),
        with_intensity=with_intensity,
    )
    batch = img.shape[0]
    bs = min(chunk_size, batch) if chunk_size else batch
    return jax.lax.map(lambda xw: fn(xw[0], xw[1]), (img, w), batch_size=bs)


def sufficient_stats_multi(
    images,
    mask=None,
    *,
    levels: int = 256,
    offsets: tuple[tuple[int, int], ...] = ((0, 5),),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
) -> tuple[SuffStats, ...]:
    """One fused device pass producing per-offset :class:`SuffStats` (the
    multi-offset sibling of :func:`sufficient_stats`)."""
    img, w = _prep_inputs_opt(images, mask)
    lut = rescale_lut_device(levels)  # cached device copy, no re-upload
    return _sufficient_stats_multi_jit(
        img,
        w,
        lut,
        levels=levels,
        offsets=tuple(tuple(o) for o in offsets),
        chunk_size=chunk_size,
        onehot_dtype=onehot_dtype,
        with_intensity=with_intensity,
    )


def _prep_inputs_opt(images, mask):
    """Like :func:`_prep_inputs` but returns ``w=None`` for ``mask=None`` —
    the jitted consumers broadcast ones internally, so the maskless path
    never materialises a full weight array outside a jit."""
    if mask is None:
        images = jnp.asarray(images)
        if images.ndim != 4:
            raise ValueError(
                f"expected (B, H, W, C) images, got shape {images.shape}"
            )
        return jnp.transpose(images, (0, 3, 1, 2)).astype(jnp.int32), None
    return _prep_inputs(images, mask)


def _prep_inputs(images, mask):
    """-> (B, C, H, W) int32 images, (B, C, H, W) float mask weights."""
    images = jnp.asarray(images)
    if images.ndim != 4:
        raise ValueError(f"expected (B, H, W, C) images, got shape {images.shape}")
    img = jnp.transpose(images, (0, 3, 1, 2)).astype(jnp.int32)
    if mask is None:
        w = jnp.ones(img.shape, jnp.float32)
    else:
        mask = jnp.asarray(mask)
        if mask.ndim == 3:  # (B, H, W) shared across channels
            mask = mask[..., None]
        w = (jnp.transpose(mask, (0, 3, 1, 2)) > 0).astype(jnp.float32)
        if w.shape[1] != img.shape[1]:  # shared mask -> every channel
            w = jnp.broadcast_to(w, img.shape)
    return img, w


@functools.partial(
    jax.jit,
    static_argnames=(
        "levels",
        "offset",
        "chunk_size",
        "onehot_dtype",
        "with_intensity",
        "with_glcm",
    ),
)
def _sufficient_stats_jit(
    img,
    w,
    lut,
    *,
    levels,
    offset,
    chunk_size,
    onehot_dtype,
    with_intensity,
    with_glcm,
):
    if w is None:  # maskless: broadcast inside the jit, never an HBM array
        w = jnp.ones(img.shape, jnp.float32)
    fn = functools.partial(
        _single_image_stats,
        lut=lut,
        levels=levels,
        offset=offset,
        onehot_dtype=jnp.dtype(onehot_dtype),
        with_intensity=with_intensity,
        with_glcm=with_glcm,
    )
    batch = img.shape[0]
    bs = min(chunk_size, batch) if chunk_size else batch
    return jax.lax.map(lambda xw: fn(xw[0], xw[1]), (img, w), batch_size=bs)


def sufficient_stats(
    images,
    mask=None,
    *,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
    with_glcm: bool = True,
) -> SuffStats:
    """Compute per-(image, channel) sufficient statistics on device.

    Parameters
    ----------
    images : (B, H, W, C) integer array of raw levels in [0, levels).
    mask : optional (B, H, W, C) or (B, H, W); nonzero selects pixels. GLCM
        pairs require both endpoints selected (the reference has no mask path;
        semantics defined here per the h5 contract, README.md:9).
    offset : (dr, dc) pixel offset of the co-occurring neighbour. The
        reference uses distance 5 at angle 0 -> (0, 5) (ipynb:298).
    chunk_size : images per vmapped chunk inside the scan (memory knob).
    """
    img, w = _prep_inputs_opt(images, mask)
    lut = rescale_lut_device(levels)  # cached device copy, no re-upload
    return _sufficient_stats_jit(
        img,
        w,
        lut,
        levels=levels,
        offset=offset,
        chunk_size=chunk_size,
        onehot_dtype=onehot_dtype,
        with_intensity=with_intensity,
        with_glcm=with_glcm,
    )


def glcm_matrix(
    images,
    mask=None,
    *,
    levels: int = 256,
    offset=(0, 5),
    distances=None,
    angles=None,
    symmetric: bool = False,
    normed: bool = False,
) -> jax.Array:
    """Co-occurrence matrices (float32, exact counts).

    API parity with ``skimage.feature.graycomatrix`` — including its
    ``symmetric`` (add the transpose) and ``normed`` (divide each matrix by
    its sum) options — for users who want the matrix itself; the feature
    path never materialises it in HBM. Applies the reference's per-channel
    max rescale first (ipynb:293-298; the reference uses the defaults
    ``symmetric=False, normed=False``).

    Two call forms:

    * ``offset=(dr, dc)`` (framework form) -> ``(B, C, L, L)``.
    * ``distances=[...], angles=[...]`` (the skimage list API the reference
      calls at ipynb:298: ``greycomatrix(temp, distances=[5], angles=[0],
      levels=256)``) -> ``(B, C, L, L, D, A)``, one matrix per (distance,
      angle) with ``(dr, dc) = (round(d sin a), round(d cos a))``. The
      rescale/one-hot prologue is shared across all pairs. Pairs whose
      offset leaves no valid positions yield a zero matrix (skimage
      semantics).
    """
    import math

    list_api = distances is not None or angles is not None
    if list_api:
        distances = tuple(distances if distances is not None else (5,))
        angles = tuple(angles if angles is not None else (0.0,))
        offsets = tuple(
            (int(round(math.sin(a) * d)), int(round(math.cos(a) * d)))
            for d in distances
            for a in angles
        )
    else:
        offsets = (tuple(offset),)

    img, w = _prep_inputs(images, mask)
    lut = rescale_lut_device(levels)  # cached device copy, no re-upload

    out = _glcm_matrix_jit(
        img, w, lut,
        levels=levels, offsets=offsets, symmetric=symmetric, normed=normed,
    )  # (B, O, C, L, L)
    if not list_api:
        return out[:, 0]
    B = out.shape[0]
    out = jnp.moveaxis(out, 1, -1)  # (B, C, L, L, O)
    return out.reshape(B, out.shape[1], levels, levels, len(distances), len(angles))


@functools.partial(
    jax.jit, static_argnames=("levels", "offsets", "symmetric", "normed")
)
def _glcm_matrix_jit(img, w, lut, *, levels, offsets, symmetric, normed):
    """Module-level jit (stable identity): a per-call closure would
    re-trace the whole one-hot/einsum graph on every glcm_matrix call."""
    def one(img1, w1):
        C, H, W = img1.shape
        f32 = jnp.float32
        vmax = jnp.max(jnp.where(w1 > 0, img1, -1), axis=(1, 2)).astype(jnp.int32)
        row = jnp.take(lut, jnp.clip(vmax, 0, levels - 1), axis=0).astype(f32)
        oh_raw = _one_hot(img1.reshape(C, -1), levels, f32)
        resc = (
            jnp.einsum(
                "cpl,cl->cp", oh_raw, row, preferred_element_type=f32,
                precision=jax.lax.Precision.HIGHEST,  # row values can be > 256
            )
            .astype(jnp.int32)
            .reshape(C, H, W)
        )
        planes = []
        for dr, dc in offsets:
            r0, r1 = max(0, -dr), H - max(0, dr)
            c0, c1 = max(0, -dc), W - max(0, dc)
            if r0 >= r1 or c0 >= c1:
                planes.append(jnp.zeros((C, levels, levels), f32))
                continue
            left = resc[:, r0:r1, c0:c1].reshape(C, -1)
            right = resc[
                :, r0 + dr : r1 + dr, c0 + dc : c1 + dc
            ].reshape(C, -1)
            pw = (
                w1[:, r0:r1, c0:c1]
                * w1[:, r0 + dr : r1 + dr, c0 + dc : c1 + dc]
            ).reshape(C, -1)
            oh_l = _one_hot(left, levels, f32) * pw[..., None]
            oh_r = _one_hot(right, levels, f32)
            g = jnp.einsum(
                "cpi,cpj->cij", oh_l, oh_r, preferred_element_type=f32
            )
            if symmetric:
                g = g + jnp.swapaxes(g, -1, -2)
            if normed:
                s = jnp.sum(g, axis=(-1, -2), keepdims=True)
                g = g / jnp.where(s == 0, 1.0, s)
            planes.append(g)
        return jnp.stack(planes)  # (O, C, L, L)

    return jax.lax.map(lambda xw: one(xw[0], xw[1]), (img, w), batch_size=8)

"""Hybrid exact finalisation: device scalar-reduction + host f64 assembly.

Motivation: the 'host' backend fetches the full histograms (~7.7 KB/image)
and does O(B*C*L) float64 numpy on the host. This backend moves the O(L)
work onto the device while *keeping exactness* for every feature whose
magnitude makes float32 insufficient:

* exact integers, representable in f32/i32 (< 2^24): pixel/pair counts,
  min/max levels, the level-weighted sum ``T = sum(hist*k)``, percentile
  *indices* (from integer CDF comparisons with integer positions
  ``q*10*(n-1)``), dissimilarity numerator, the marginal first moments
  ``S_i/S_j``, and base-256 limb pairs of the quadratic sums
  ``sum(marg*i^2)`` / ``sum(diff_hist*d^2)`` (reassembled in f64 on host —
  this is what makes contrast and the correlation covariance *exact* despite
  their ~1e8 magnitudes).
* f32-summed small-magnitude quantities (~1e-7 relative): central moments
  m2..m4 (computed from the exact integer deviation numerators
  ``e = n*k - T``, so there is no catastrophic cancellation), entropy,
  homogeneity, ASM sum-of-squares.

The host then assembles features with scalar f64 math on (B, C)-shaped
arrays only. Valid for per-channel pixel counts < 2^16 (u16-histogram
regime); ``extract_features`` falls back to the 'host' backend otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpumcia.features.finalize import FinalizedFeatures
from tpumcia.features.stats import SuffStats

_Q10 = np.arange(1, 10, dtype=np.int32)  # q*10 for q = 0.1 .. 0.9


def _quad_shift(levels: int) -> int:
    """Limb shift for the quadratic sums: the square's hi part stays
    <= 2^15 per level, so each i32 limb partial sum is < 2^31 for
    per-channel counts < 2^16 (valid for levels <= 32768; base-256 for the
    classic levels <= 256 regime, where partials are also f32-exact)."""
    if levels > 32768:
        raise ValueError("hybrid reduction supports at most 32768 levels")
    return max(8, 2 * int(levels - 1).bit_length() - 15)


@jax.jit
def _device_reduce(stats: SuffStats):
    f32 = jnp.float32
    i32 = jnp.int32
    hist = stats.hist.astype(i32)  # (B, C, L) exact counts
    B, C, L = hist.shape
    k = jnp.arange(L, dtype=i32)
    n = stats.count.astype(i32)  # (B, C)
    safe_n = jnp.maximum(n, 1)

    # --- intensity: exact integer pieces ---------------------------------
    nz = hist > 0
    min_lev = jnp.argmax(nz, axis=-1).astype(i32)
    max_lev = (L - 1) - jnp.argmax(nz[..., ::-1], axis=-1).astype(i32)
    total_raw = jnp.sum(hist * k, axis=-1)  # <= 255*65535 < 2^24, exact

    cdf = jnp.cumsum(hist, axis=-1)  # (B, C, L) i32
    num = _Q10[None, None, :] * (safe_n[..., None] - 1)  # exact i32
    k_lo = num // 1000
    rem = num - k_lo * 1000
    k_hi = k_lo + (rem > 0).astype(i32)

    def value_at(kq):  # (B, C, 9) -> level index of sorted order-statistic
        # clip: an all-zero cdf (fully-masked channel) yields L, which the
        # assembly masks to 0 anyway but would overflow the u32 wire's 8-bit
        # index fields; n >= 1 rows are always <= L-1 (cdf[-1] = n > kq)
        return jnp.minimum(
            jnp.sum((cdf[:, :, None, :] <= kq[..., None]).astype(i32), axis=-1),
            L - 1,
        )

    idx_lo = value_at(k_lo)
    idx_hi = value_at(k_hi)

    # central moments: deviations from the *exact* mean numerator
    # e = n*k - T  (exact i32, |e| <= (L-1)*65535); dev = e / ((L-1)*n).
    # The divisor is the level-value scale (level v's float value is
    # v/(L-1), matching assemble_reduced's `top`) — a hard-coded 255 here
    # made std wrong by (L-1)/255 for any levels != 256.
    e = safe_n[..., None] * k[None, None, :] - total_raw[..., None]
    dev = e.astype(f32) / (
        jnp.float32(L - 1) * safe_n[..., None].astype(f32)
    )
    hist_f = hist.astype(f32)
    dev2 = dev * dev
    hd2 = hist_f * dev2
    nf = safe_n.astype(f32)
    m2 = jnp.sum(hd2, axis=-1) / nf
    m3 = jnp.sum(hd2 * dev, axis=-1) / nf
    m4 = jnp.sum(hd2 * dev2, axis=-1) / nf

    p = hist_f / nf[..., None]
    entropy = -jnp.sum(
        jnp.where(p > 0, p * jnp.log2(jnp.where(p > 0, p, 1.0)), 0.0), axis=-1
    )

    return dict(
        n=n,
        vmax=stats.vmax,
        min_lev=min_lev,
        max_lev=max_lev,
        total_raw=total_raw,
        idx_lo=idx_lo,
        idx_hi=idx_hi,
        rem=rem,
        m2=m2,
        m3=m3,
        m4=m4,
        entropy=entropy,
        **_glcm_reduce(stats),
    )


def _glcm_reduce(stats: SuffStats) -> dict:
    """The GLCM (per-offset) half of :func:`_device_reduce`: exact integer
    pieces + f32 small sums derived from one offset's marginals and
    difference reductions. Factored out so the multi-offset wire can reduce
    each offset's stats without recomputing the shared intensity half."""
    f32 = jnp.float32
    i32 = jnp.int32
    L = stats.marg_l.shape[-1]
    k = jnp.arange(L, dtype=i32)
    ml = stats.marg_l.astype(i32)
    mr = stats.marg_r.astype(i32)
    i2 = k * k
    # limb split of the squares: pick the shift so BOTH limb partial sums
    # stay < 2^31 in i32 for any levels (hi part <= 2^15 per level, counts
    # < 2^16). For levels <= 256 this is the classic base-256 split whose
    # partials are also < 2^24 (f32-exact, the u32 wire relies on it); for
    # larger level counts exactness is restored at pack/unpack time by
    # shipping each i32 limb sum as two 16-bit f32 halves.
    S = _quad_shift(L)
    lo_mask = (1 << S) - 1
    s_i2_hi = jnp.sum(ml * (i2 >> S), axis=-1)
    s_i2_lo = jnp.sum(ml * (i2 & lo_mask), axis=-1)
    s_j2_hi = jnp.sum(mr * (i2 >> S), axis=-1)
    s_j2_lo = jnp.sum(mr * (i2 & lo_mask), axis=-1)
    s_i = jnp.sum(ml * k, axis=-1)  # exact first moments
    s_j = jnp.sum(mr * k, axis=-1)
    dh = stats.diff_hist.astype(i32)
    D = dh.shape[-1]
    d = jnp.arange(D, dtype=i32) - (L - 1)
    d2 = d * d
    s_d2_hi = jnp.sum(dh * (d2 >> S), axis=-1)
    s_d2_lo = jnp.sum(dh * (d2 & lo_mask), axis=-1)
    dissim_raw = jnp.sum(dh * jnp.abs(d), axis=-1)  # <= (L-1)*65535, exact i32
    homog_sum = jnp.sum(dh.astype(f32) / (1.0 + d2.astype(f32)), axis=-1)
    return dict(
        s_i2_hi=s_i2_hi,
        s_i2_lo=s_i2_lo,
        s_j2_hi=s_j2_hi,
        s_j2_lo=s_j2_lo,
        s_d2_hi=s_d2_hi,
        s_d2_lo=s_d2_lo,
        s_i=s_i,
        s_j=s_j,
        dissim_raw=dissim_raw,
        homog_sum=homog_sum,
        sumsq=stats.glcm_sumsq,
        npairs=stats.pair_count.astype(i32),
    )


# packing layout: 10 narrow (B, C) scalars (f32-exact: < 2^24 or native
# f32), 10 wide i32 sums shipped as EXACT 16-bit (hi, lo) f32 halves —
# total_raw / s_i / s_j / dissim_raw / the four quadratic limb sums can
# exceed 2^24 for levels > 256, where a bare f32 cast would silently round
# — then (B, C, k) vectors (percentile triples of 9 + the 4 sumsq limbs).
_NARROW_FIELDS = (
    "n", "vmax", "min_lev", "max_lev", "m2", "m3", "m4",
    "entropy", "homog_sum", "npairs",
)
_WIDE_FIELDS = (
    "total_raw", "s_i", "s_j", "dissim_raw",
    "s_i2_hi", "s_i2_lo", "s_j2_hi", "s_j2_lo", "s_d2_hi", "s_d2_lo",
)
_VEC_FIELDS = (("idx_lo", 9), ("idx_hi", 9), ("rem", 9), ("sumsq", 4))


@jax.jit
def _device_reduce_packed(stats: SuffStats) -> jax.Array:
    """Single (B, C, 61) f32 array — one D2H fetch instead of 25."""
    f32 = jnp.float32
    r = _device_reduce(stats)
    parts = [r[f].astype(f32)[..., None] for f in _NARROW_FIELDS]
    for f in _WIDE_FIELDS:
        v = r[f]  # non-negative i32 sum
        parts.append((v >> 16).astype(f32)[..., None])
        parts.append((v & 0xFFFF).astype(f32)[..., None])
    parts += [r[f].astype(f32) for f, _ in _VEC_FIELDS]
    return jnp.concatenate(parts, axis=-1)


def unpack_reduced(packed: np.ndarray, *, levels: int = 256) -> dict:
    packed = np.asarray(packed)
    f64 = np.float64
    out = {}
    i = 0
    for f in _NARROW_FIELDS:
        out[f] = packed[..., i]
        i += 1
    for f in _WIDE_FIELDS:
        out[f] = (
            packed[..., i].astype(f64) * 65536.0
            + packed[..., i + 1].astype(f64)
        )
        i += 2
    for f, width in _VEC_FIELDS:
        out[f] = packed[..., i : i + width]
        i += width
    # f64 quadratic sums for assemble_reduced (limb base matches the device
    # reduction's _quad_shift; the u32 wire carries these whole instead)
    base = float(1 << _quad_shift(levels))
    out["s_i2"] = base * out.pop("s_i2_hi") + out.pop("s_i2_lo")
    out["s_j2"] = base * out.pop("s_j2_hi") + out.pop("s_j2_lo")
    out["s_d2"] = base * out.pop("s_d2_hi") + out.pop("s_d2_lo")
    from tpumcia.features.stats import glcm_sumsq_value

    out["sumsq_value"] = glcm_sumsq_value(out.pop("sumsq"), np, f64)
    # mirror the wire's per-element transport-precondition flag so both
    # decoders expose the same dict (the packed n field is f32, directly
    # comparable on host)
    out["count_overflow"] = out["n"] >= 65536
    return out


# --- u32 wire format ------------------------------------------------------
# 20 uint32 words per (image, channel) — 3.05x fewer D2H bytes than the
# 61-f32 layout above. Valid for levels <= 256 and per-channel pixel
# counts < 2^16 (the hybrid regime extract_features already enforces):
#   w0  : n | min_lev<<16 | max_lev<<24
#   w1  : npairs | (vmax+1)<<16 | count_overflow<<31  (n >= 2^16 flag — the
#         precondition check rides the fetch instead of its own round trip)
#   w2  : total_raw                      (< 2^24)
#   w3-7: percentile (idx_lo | idx_hi<<8) pairs, 2 per word (9 pairs + pad)
#   w8-12: m2 m3 m4 entropy homog_sum    (f32 bit patterns)
#   w13-15: s_i s_j dissim_raw           (< 2^24)
#   w16-18: s_i2 s_j2 s_d2               (exact u32: <= 255^2 * 65535 < 2^32)
#   w19 : sum(G^2)                       (exact u32: <= npairs^2 < 2^32)
# `rem` is not sent — the host re-derives it from n (rem = q*10*(n-1) % 1000).
WIRE_WORDS = 20


def _u32(x):
    return x.astype(jnp.uint32)


def _fbits(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)


def _wire_u32_quads(stats: SuffStats):
    """Exact u32 quadratic sums straight from one offset's integer
    histograms: every true total is < 2^32 in the hybrid regime, so mod-2^32
    accumulation is exact (the f32 wire needs base-256 limb pairs for the
    same values). Returns ``(s_i2, s_j2, s_d2, sumsq)`` u32 arrays."""
    u = _u32
    L = stats.marg_l.shape[-1]
    k = jnp.arange(L, dtype=jnp.uint32)
    k2 = k * k
    s_i2 = jnp.sum(u(stats.marg_l.astype(jnp.int32)) * k2, axis=-1)
    s_j2 = jnp.sum(u(stats.marg_r.astype(jnp.int32)) * k2, axis=-1)
    d = jnp.arange(2 * L - 1, dtype=jnp.int32) - (L - 1)
    d2 = u(d * d)
    s_d2 = jnp.sum(u(stats.diff_hist.astype(jnp.int32)) * d2, axis=-1)
    limbs = u(stats.glcm_sumsq)  # weights 2^24, 2^13, 2^8, 1 (stats.py)
    sumsq = (
        (limbs[..., 0] << 24) + (limbs[..., 1] << 13)
        + (limbs[..., 2] << 8) + limbs[..., 3]
    )
    return s_i2, s_j2, s_d2, sumsq


@jax.jit
def _device_reduce_wire(stats: SuffStats) -> jax.Array:
    """(B, C, 20) uint32 — the minimal-byte exact wire format (levels<=256)."""
    r = _device_reduce(stats)
    u = _u32
    fbits = _fbits

    w0 = u(r["n"]) | (u(r["min_lev"]) << 16) | (u(r["max_lev"]) << 24)
    # w1 bit 31: per-(image,channel) transport-precondition flag (count >=
    # 2^16, where the 16-bit wire fields wrap) — riding the wire fetch
    # instead of a separate blocking scalar fetch. npairs <= n is masked so
    # an overflowing count cannot smear into the vmax/flag bits.
    w1 = (
        (u(r["npairs"]) & 0xFFFF)
        | (u(r["vmax"] + 1) << 16)
        | (u(r["n"] >= 65536) << 31)
    )
    w2 = u(r["total_raw"])
    pair = u(r["idx_lo"]) | (u(r["idx_hi"]) << 8)  # (B, C, 9), 16 bits each
    pair = jnp.concatenate([pair, jnp.zeros_like(pair[..., :1])], axis=-1)
    w_pct = pair[..., 0::2] | (pair[..., 1::2] << 16)  # (B, C, 5)
    w_float = jnp.stack(
        [fbits(r[f]) for f in ("m2", "m3", "m4", "entropy", "homog_sum")],
        axis=-1,
    )
    s_i2, s_j2, s_d2, sumsq = _wire_u32_quads(stats)
    scalars = jnp.stack(
        [w0, w1, w2], axis=-1
    )
    tail = jnp.stack(
        [u(r["s_i"]), u(r["s_j"]), u(r["dissim_raw"]), s_i2, s_j2, s_d2, sumsq],
        axis=-1,
    )
    return jnp.concatenate([scalars, w_pct, w_float, tail], axis=-1)


# --- multi-offset u32 wire --------------------------------------------------
# (B, C, 12 + 9*O) uint32: the intensity/shared words are shipped ONCE and
# each offset appends 9 GLCM words — so a whole multi-offset extraction is
# ONE fetch instead of one per offset (skimage list API, ipynb:298). Same exactness regime as the
# single-offset wire (levels <= 256, per-channel counts < 2^16).
#   shared w0   : n | min_lev<<16 | max_lev<<24
#   shared w1   : (vmax+1) | count_overflow<<31
#   shared w2   : total_raw
#   shared w3-7 : percentile (idx_lo | idx_hi<<8) pairs, 2 per word
#   shared w8-11: m2 m3 m4 entropy           (f32 bit patterns)
#   offset o +0 : npairs                      (< 2^16)
#   offset o +1 : homog_sum                   (f32 bit pattern)
#   offset o +2-4: s_i s_j dissim_raw         (< 2^24)
#   offset o +5-8: s_i2 s_j2 s_d2 sum(G^2)    (exact u32)
MULTI_WIRE_SHARED = 12
MULTI_WIRE_PER_OFFSET = 9


def multi_wire_words(num_offsets: int) -> int:
    return MULTI_WIRE_SHARED + MULTI_WIRE_PER_OFFSET * num_offsets


@jax.jit
def _device_reduce_wire_multi(all_stats: tuple) -> jax.Array:
    """(B, C, 12 + 9*O) uint32 for a tuple of per-offset SuffStats (the
    ``sufficient_stats*_multi`` contract: only ``all_stats[0]`` carries the
    intensity histogram; count/vmax are shared)."""
    r0 = _device_reduce(all_stats[0])
    u = _u32
    fbits = _fbits

    w0 = u(r0["n"]) | (u(r0["min_lev"]) << 16) | (u(r0["max_lev"]) << 24)
    w1 = (u(r0["vmax"] + 1) & 0xFFFF) | (u(r0["n"] >= 65536) << 31)
    w2 = u(r0["total_raw"])
    pair = u(r0["idx_lo"]) | (u(r0["idx_hi"]) << 8)
    pair = jnp.concatenate([pair, jnp.zeros_like(pair[..., :1])], axis=-1)
    w_pct = pair[..., 0::2] | (pair[..., 1::2] << 16)  # (B, C, 5)
    w_float = jnp.stack(
        [fbits(r0[f]) for f in ("m2", "m3", "m4", "entropy")], axis=-1
    )
    words = [jnp.stack([w0, w1, w2], axis=-1), w_pct, w_float]
    for o, stats in enumerate(all_stats):
        g = r0 if o == 0 else _glcm_reduce(stats)
        s_i2, s_j2, s_d2, sumsq = _wire_u32_quads(stats)
        words.append(
            jnp.stack(
                [
                    u(g["npairs"]),
                    fbits(g["homog_sum"]),
                    u(g["s_i"]),
                    u(g["s_j"]),
                    u(g["dissim_raw"]),
                    s_i2,
                    s_j2,
                    s_d2,
                    sumsq,
                ],
                axis=-1,
            )
        )
    return jnp.concatenate(words, axis=-1)


def unpack_wire_multi(packed: np.ndarray, num_offsets: int) -> list[dict]:
    """Decode the multi-offset u32 wire into one
    :func:`assemble_reduced`-compatible dict per offset (the first carries
    the intensity fields; every dict carries n/vmax for the degenerate
    flags). O(B*C) numpy only."""
    p = np.ascontiguousarray(np.asarray(packed))
    assert p.dtype == np.uint32
    assert p.shape[-1] == multi_wire_words(num_offsets), p.shape
    i64 = np.int64
    shared = {}
    w0 = p[..., 0]
    shared["n"] = (w0 & 0xFFFF).astype(i64)
    shared["min_lev"] = ((w0 >> 16) & 0xFF).astype(i64)
    shared["max_lev"] = ((w0 >> 24) & 0xFF).astype(i64)
    w1 = p[..., 1]
    shared["vmax"] = (w1 & 0x7FFF).astype(i64) - 1
    shared["count_overflow"] = (w1 >> 31) != 0
    shared["total_raw"] = p[..., 2].astype(i64)
    pct = p[..., 3:8]
    pairs = np.stack([pct & 0xFFFF, pct >> 16], axis=-1).reshape(
        *pct.shape[:-1], 10
    )[..., :9]
    shared["idx_lo"] = (pairs & 0xFF).astype(i64)
    shared["idx_hi"] = ((pairs >> 8) & 0xFF).astype(i64)
    shared["rem"] = (
        _Q10.astype(i64)[None, None, :]
        * np.maximum(shared["n"] - 1, 0)[..., None]
    ) % 1000
    floats = np.ascontiguousarray(p[..., 8:12]).view(np.float32)
    for i, f in enumerate(("m2", "m3", "m4", "entropy")):
        shared[f] = floats[..., i]
    out = []
    for o in range(num_offsets):
        base = MULTI_WIRE_SHARED + MULTI_WIRE_PER_OFFSET * o
        d = dict(shared)
        d["npairs"] = p[..., base].astype(i64)
        d["homog_sum"] = np.ascontiguousarray(
            p[..., base + 1 : base + 2]
        ).view(np.float32)[..., 0]
        d["s_i"] = p[..., base + 2].astype(i64)
        d["s_j"] = p[..., base + 3].astype(i64)
        d["dissim_raw"] = p[..., base + 4].astype(i64)
        d["s_i2"] = p[..., base + 5].astype(np.float64)
        d["s_j2"] = p[..., base + 6].astype(np.float64)
        d["s_d2"] = p[..., base + 7].astype(np.float64)
        d["sumsq_value"] = p[..., base + 8].astype(np.float64)
        out.append(d)
    return out


def unpack_wire(packed: np.ndarray) -> dict:
    """Decode the u32 wire into the dict :func:`assemble_reduced` consumes.
    O(B*C) numpy only."""
    p = np.ascontiguousarray(np.asarray(packed))
    assert p.dtype == np.uint32 and p.shape[-1] == WIRE_WORDS
    i64 = np.int64
    out = {}
    w0 = p[..., 0]
    out["n"] = (w0 & 0xFFFF).astype(i64)
    out["min_lev"] = ((w0 >> 16) & 0xFF).astype(i64)
    out["max_lev"] = ((w0 >> 24) & 0xFF).astype(i64)
    w1 = p[..., 1]
    out["npairs"] = (w1 & 0xFFFF).astype(i64)
    out["vmax"] = ((w1 >> 16) & 0x7FFF).astype(i64) - 1
    out["count_overflow"] = (w1 >> 31) != 0
    out["total_raw"] = p[..., 2].astype(i64)
    pct = p[..., 3:8]
    pairs = np.stack([pct & 0xFFFF, pct >> 16], axis=-1).reshape(
        *pct.shape[:-1], 10
    )[..., :9]
    out["idx_lo"] = (pairs & 0xFF).astype(i64)
    out["idx_hi"] = ((pairs >> 8) & 0xFF).astype(i64)
    out["rem"] = (
        _Q10.astype(i64)[None, None, :] * np.maximum(out["n"] - 1, 0)[..., None]
    ) % 1000
    floats = np.ascontiguousarray(p[..., 8:13]).view(np.float32)
    out["m2"] = floats[..., 0]
    out["m3"] = floats[..., 1]
    out["m4"] = floats[..., 2]
    out["entropy"] = floats[..., 3]
    out["homog_sum"] = floats[..., 4]
    out["s_i"] = p[..., 13].astype(i64)
    out["s_j"] = p[..., 14].astype(i64)
    out["dissim_raw"] = p[..., 15].astype(i64)
    out["s_i2"] = p[..., 16].astype(np.float64)
    out["s_j2"] = p[..., 17].astype(np.float64)
    out["s_d2"] = p[..., 18].astype(np.float64)
    out["sumsq_value"] = p[..., 19].astype(np.float64)
    return out


_FETCH_POOL = None


def _fetch_pool():
    """Module-level fetch executor shared by every wire fetch (no pool
    setup/teardown per call). Whether concurrent D2H pays over local PCIe
    is not measured yet."""
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _FETCH_POOL = ThreadPoolExecutor(6, thread_name_prefix="tpumcia-fetch")
    return _FETCH_POOL


def _fetch_concurrent(arr, num_chunks: int = 6, min_bytes: int = 1 << 20) -> np.ndarray:
    """D2H fetch of a device array, split into concurrent chunk transfers
    when large. Splits on the leading axis, or the second axis for
    small-B/large-C extractions."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        # cross-process (multi-host) global array: replicate to every
        # process first — local chunked slicing/np.asarray would raise
        from tpumcia.features.finalize import fetch_to_host

        return fetch_to_host(arr)
    if getattr(arr, "nbytes", 0) < min_bytes:
        return np.asarray(arr)
    ex = _fetch_pool()
    if arr.shape[0] >= num_chunks:
        bounds = np.linspace(0, arr.shape[0], num_chunks + 1, dtype=int)
        parts = [arr[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        return np.concatenate(list(ex.map(np.asarray, parts)))
    if arr.ndim >= 2 and arr.shape[1] >= num_chunks:
        bounds = np.linspace(0, arr.shape[1], num_chunks + 1, dtype=int)
        parts = [arr[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        return np.concatenate(list(ex.map(np.asarray, parts)), axis=1)
    return np.asarray(arr)


def finalize_hybrid(
    stats: SuffStats, *, include_intensity: bool = True, include_glcm: bool = True
) -> FinalizedFeatures:
    levels = stats.hist.shape[-1]
    # the transport-precondition check rides the main fetch: the wire
    # carries a per-element overflow flag (w1 bit 31), and the packed
    # path's f32 'n' field is directly comparable on host — no separate
    # blocking scalar fetch
    if levels <= 256:
        reduced = unpack_wire(_fetch_concurrent(_device_reduce_wire(stats)))
        ok = not np.any(reduced["count_overflow"])
    else:
        reduced = unpack_reduced(
            _fetch_concurrent(_device_reduce_packed(stats)), levels=levels
        )
        ok = float(np.max(reduced["n"])) < 65536
    if not ok:
        # the transport's exactness (16-bit wire fields, 16-bit halves,
        # i32 limb bounds) requires per-channel counts < 2^16; violating
        # it would return silently-wrong features, so refuse loudly.
        # extract_features demotes such inputs to the 'host' backend
        # before ever reaching here — this guards direct finalize calls.
        raise ValueError(
            "hybrid finalize requires per-channel pixel counts < 65536 "
            "(images this large should use precision='exact')"
        )
    return assemble_reduced(
        reduced,
        levels=levels,
        include_intensity=include_intensity,
        include_glcm=include_glcm,
    )


def assemble_reduced(
    reduced: dict,
    *,
    levels: int = 256,
    include_intensity: bool = True,
    include_glcm: bool = True,
) -> FinalizedFeatures:
    """Host f64 assembly of a (possibly pre-dispatched) device reduction."""
    r = {kk: np.asarray(v) for kk, v in reduced.items()}  # one small D2H fetch
    f64 = np.float64
    top = float(levels - 1)  # level value divisor

    n = r["n"].astype(f64)
    safe_n = np.maximum(n, 1)
    empty = n == 0
    z = lambda a: np.where(empty, 0.0, a)

    blocks = []
    B, C = r["n"].shape
    if include_intensity:
        min_v = z(r["min_lev"].astype(f64) / top)
        max_v = z(r["max_lev"].astype(f64) / top)
        frac = r["rem"].astype(f64) / 1000.0
        pct = (r["idx_lo"] + frac * (r["idx_hi"] - r["idx_lo"])) / top
        pct = np.where(empty[..., None], 0.0, pct)
        total = r["total_raw"].astype(f64) / top
        mean = total / safe_n
        m2 = r["m2"].astype(f64)
        std = np.sqrt(m2)
        zero_var = m2 == 0
        safe_m2 = np.where(zero_var, 1.0, m2)
        nanv = np.full_like(m2, np.nan)
        kurt = np.where(zero_var, nanv, r["m4"] / (safe_m2 * safe_m2) - 3.0)
        skew = np.where(zero_var, nanv, r["m3"] / safe_m2**1.5)
        feats = np.stack(
            [min_v]
            + [pct[..., i] for i in range(9)]
            + [max_v, z(total), z(mean), z(std),
               np.where(empty, 0.0, kurt), np.where(empty, 0.0, skew),
               z(r["entropy"].astype(f64))],
            axis=-1,
        )
        blocks.append(feats.reshape(B, -1))

    if include_glcm:
        N = r["npairs"].astype(f64)
        safe_N = np.maximum(N, 1.0)
        # exact integer quadratic sums, already reassembled to f64 by the
        # wire decoders (unpack_wire / unpack_reduced)
        s_d2 = r["s_d2"]
        s_i2 = r["s_i2"]
        s_j2 = r["s_j2"]
        s_i = r["s_i"].astype(f64)
        s_j = r["s_j"].astype(f64)

        contrast = s_d2 / safe_N
        dissimilarity = r["dissim_raw"].astype(f64) / safe_N
        homogeneity = r["homog_sum"].astype(f64) / safe_N
        asm = r["sumsq_value"] / (safe_N * safe_N)
        energy = np.sqrt(asm)
        # correlation from exact integer sums: cov*N^2 = N*s_ij - s_i*s_j
        s_ij = (s_i2 + s_j2 - s_d2) / 2.0
        cov_nn = safe_N * s_ij - s_i * s_j
        var_i_nn = safe_N * s_i2 - s_i * s_i
        var_j_nn = safe_N * s_j2 - s_j * s_j
        denom = np.sqrt(np.maximum(var_i_nn, 0.0) * np.maximum(var_j_nn, 0.0))
        # skimage: correlation = 1 when either marginal std ~ 0. var_nn are
        # exact integers, so zero variance is exactly var_nn == 0 (the
        # smallest nonzero integer variance gives std >> skimage's 1e-15).
        ok = (var_i_nn > 0) & (var_j_nn > 0)
        correlation = np.where(ok, cov_nn / np.where(ok, denom, 1.0), 1.0)
        glcm = np.stack(
            [contrast, dissimilarity, homogeneity, asm, energy, correlation],
            axis=-1,
        )
        blocks.append(glcm.reshape(B, -1))

    values = np.concatenate(blocks, axis=1)
    degenerate = (r["n"] == 0) | (r["vmax"] <= 0)
    return FinalizedFeatures(values=values, degenerate=degenerate)

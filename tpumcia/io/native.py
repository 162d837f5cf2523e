"""ctypes bindings for the native host-side packer (native/packer.cpp).

The library is built on first use with g++ (-O3 -shared) into
``native/libmcia_packer.so``; all entry points have pure-numpy fallbacks,
so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libmcia_packer.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    src = _NATIVE_DIR / "packer.cpp"
    if not src.exists():
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", str(src), "-o", str(_SO_PATH),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded native library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO_PATH))
        except OSError:
            return None
        c_long_p = ctypes.POINTER(ctypes.c_long)
        pp = ctypes.POINTER(ctypes.c_void_p)
        for name in ("tpumcia_pack_u8", "tpumcia_pack_u16"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [pp, c_long_p, c_long_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_int]
        q = lib.tpumcia_quantize_u16_to_u8
        q.restype = None
        q.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                      ctypes.c_long, ctypes.c_int]
        _lib = lib
        return _lib


def pack_objects(
    arrays: list[np.ndarray],
    target_hw: tuple[int, int],
    *,
    num_threads: int = 0,
) -> np.ndarray:
    """Center crop/pad a list of (h, w, c) arrays (uint8 or uint16, shared c
    and dtype) into one (B, H, W, c) batch. Native path when available."""
    if not arrays:
        raise ValueError("empty object list")
    c = arrays[0].shape[2]
    dtype = arrays[0].dtype
    if any(a.ndim != 3 or a.shape[2] != c or a.dtype != dtype for a in arrays):
        raise ValueError("objects must share channel count and dtype")
    H, W = target_hw
    out = np.empty((len(arrays), H, W, c), dtype=dtype)

    lib = get_lib()
    if lib is not None and dtype in (np.uint8, np.uint16):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(arrays)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
        )
        hs = (ctypes.c_long * n)(*[a.shape[0] for a in arrays])
        ws = (ctypes.c_long * n)(*[a.shape[1] for a in arrays])
        fn = lib.tpumcia_pack_u8 if dtype == np.uint8 else lib.tpumcia_pack_u16
        fn(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(hs, ctypes.POINTER(ctypes.c_long)),
            ctypes.cast(ws, ctypes.POINTER(ctypes.c_long)),
            n, c, out.ctypes.data_as(ctypes.c_void_p), H, W, num_threads,
        )
        return out

    # PURE-numpy fallback: the jax center_crop_or_pad would issue one
    # device dispatch (and a fresh compile) per unique (h, w) object shape
    # — a host-side pack must never touch the backend
    for i, a in enumerate(arrays):
        h, w = a.shape[0], a.shape[1]
        # centered crop (same floor-division offsets as the C++ kernel and
        # preprocess.center_crop_or_pad)
        if h > H:
            top = (h - H) // 2
            a = a[top : top + H]
        if w > W:
            left = (w - W) // 2
            a = a[:, left : left + W]
        h2, w2 = a.shape[0], a.shape[1]
        pt = (H - h2) // 2
        pl = (W - w2) // 2
        out[i] = 0
        out[i, pt : pt + h2, pl : pl + w2] = a
    return out


def quantize_u16(
    src: np.ndarray, *, levels: int = 256, num_threads: int = 0
) -> np.ndarray:
    """uint16 -> uint8 level quantisation (v * levels / 65536), native when
    available."""
    src = np.ascontiguousarray(src, dtype=np.uint16)
    out = np.empty(src.shape, np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.tpumcia_quantize_u16_to_u8(
            src.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            src.size, levels, num_threads,
        )
        return out
    return np.minimum(
        (src.astype(np.int64) * levels) >> 16, levels - 1
    ).astype(np.uint8)

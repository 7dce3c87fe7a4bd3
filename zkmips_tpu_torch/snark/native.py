"""ctypes bridge to the BN254 MSM and Fr backend of ``csrc/bn254.c``.

The library is the one ``ops/bn254_native.lib()`` builds (with OpenMP, into
``build/native/`` at first use) and loads: one loader, one shared object for
the outer config's Merkle hashing and the SNARK link.  A failed build or load
raises; nothing here falls back to the Python curve arithmetic of
``bn254_curve``, which is the plain version the tests hold this module
against.

Points cross the boundary packed: G1 as (n, 8) uint64 (x then y, canonical,
64-bit limbs little-endian), G2 as (n, 16) (x0, x1, y0, y1), each with an
(n,) int32 infinity flag; scalars as (n, 32) uint8 little-endian; Fr vectors
as (n, 4) uint64, canonical or Montgomery as each function says.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.bn254_native import lib as _lib, pack_fr as _pack_fr, unpack_fr
from .bn254_curve import R as _FR

__all__ = [
    "fr_fft", "fr_fft_mont", "fr_mul_sub_scale", "fr_scale_pows", "fr_vec_add", "fr_vec_div_linear",
    "fr_vec_inv", "fr_vec_mont", "fr_vec_mul", "fr_vec_powers", "fr_vec_scale_add", "fr_vec_sub",
    "g1_msm", "g1_msm_packed", "g1_mul_batch", "g1_mul_batch_packed", "g2_msm", "g2_msm_packed",
    "g2_mul_batch", "g2_mul_batch_packed", "pack_fr", "pack_scalars", "unpack_fr",
]


def _limbs(x: int, n: int = 4) -> list[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def _from_limbs(arr) -> int:
    acc = 0
    for i, v in enumerate(arr):
        acc |= int(v) << (64 * i)
    return acc


def _pack_g1(points) -> tuple[np.ndarray, np.ndarray]:
    pts = np.zeros((len(points), 8), dtype=np.uint64)
    infs = np.zeros(len(points), dtype=np.int32)
    for i, pt in enumerate(points):
        if pt is None:
            infs[i] = 1
        else:
            pts[i, :4] = _limbs(pt[0])
            pts[i, 4:] = _limbs(pt[1])
    return pts, infs


def _pack_g2(points) -> tuple[np.ndarray, np.ndarray]:
    pts = np.zeros((len(points), 16), dtype=np.uint64)
    infs = np.zeros(len(points), dtype=np.int32)
    for i, pt in enumerate(points):
        if pt is None:
            infs[i] = 1
        else:
            (x0, x1), (y0, y1) = pt
            pts[i, 0:4] = _limbs(x0)
            pts[i, 4:8] = _limbs(x1)
            pts[i, 8:12] = _limbs(y0)
            pts[i, 12:16] = _limbs(y1)
    return pts, infs


def _unpack_g1(limbs, inf):
    if inf:
        return None
    return (_from_limbs(limbs[:4]), _from_limbs(limbs[4:8]))


def _unpack_g2(limbs, inf):
    if inf:
        return None
    return (
        (_from_limbs(limbs[0:4]), _from_limbs(limbs[4:8])),
        (_from_limbs(limbs[8:12]), _from_limbs(limbs[12:16])),
    )


def _cptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def pack_scalars(scalars) -> np.ndarray:
    """(n, 32) u8 little-endian scalar array (the MSM/batch ABI)."""
    buf = b"".join(int(s % _FR).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint8).reshape(-1, 32).copy()


def pack_fr(vals) -> np.ndarray:
    """(n, 4) u64 canonical little-endian Fr array."""
    return _pack_fr([int(v) % _FR for v in vals])


# ---- MSMs and fixed-base batches --------------------------------------------


def _msm(group: str, pts: np.ndarray, infs, sc: np.ndarray):
    width = 8 if group == "g1" else 16
    out = np.zeros(width, dtype=np.uint64)
    out_inf = np.zeros(1, dtype=np.int32)
    getattr(_lib(), f"zkm_bn254_{group}_msm")(
        _cptr(pts, ctypes.c_uint64), _cptr(infs, ctypes.c_int32) if infs is not None else None,
        _cptr(sc, ctypes.c_uint8), ctypes.c_int64(len(pts)),
        _cptr(out, ctypes.c_uint64), _cptr(out_inf, ctypes.c_int32),
    )
    return (_unpack_g1 if group == "g1" else _unpack_g2)(out, out_inf[0])


def _mul_batch(group: str, base, scalars_packed: np.ndarray):
    pts, infs = (_pack_g1 if group == "g1" else _pack_g2)([base])
    n = len(scalars_packed)
    out = np.zeros((n, pts.shape[1]), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.int32)
    getattr(_lib(), f"zkm_bn254_{group}_mul_batch")(
        _cptr(pts, ctypes.c_uint64), ctypes.c_int32(int(infs[0])),
        _cptr(np.ascontiguousarray(scalars_packed), ctypes.c_uint8), ctypes.c_int64(n),
        _cptr(out, ctypes.c_uint64), _cptr(out_inf, ctypes.c_int32),
    )
    return out, out_inf


def g1_msm_packed(pts: np.ndarray, infs, sc: np.ndarray):
    """MSM over pre-packed (n, 8) u64 points and (n, 32) u8 scalars."""
    return _msm("g1", pts, infs, sc)


def g2_msm_packed(pts: np.ndarray, infs, sc: np.ndarray):
    return _msm("g2", pts, infs, sc)


def g1_msm(points, scalars):
    """sum scalars[i] * points[i] over G1 point tuples (``None`` = infinity)."""
    pts, infs = _pack_g1(points)
    return _msm("g1", pts, infs, pack_scalars(scalars))


def g2_msm(points, scalars):
    pts, infs = _pack_g2(points)
    return _msm("g2", pts, infs, pack_scalars(scalars))


def g1_mul_batch_packed(base, scalars_packed: np.ndarray):
    """Fixed-base batch returning packed ((n, 8) u64, (n,) i32) arrays."""
    return _mul_batch("g1", base, scalars_packed)


def g2_mul_batch_packed(base, scalars_packed: np.ndarray):
    return _mul_batch("g2", base, scalars_packed)


def g1_mul_batch(base, scalars) -> list:
    """[scalar_i * base for i]: a fixed-base window table in C (key setup)."""
    out, inf = _mul_batch("g1", base, pack_scalars(scalars))
    return [_unpack_g1(out[i], inf[i]) for i in range(len(out))]


def g2_mul_batch(base, scalars) -> list:
    out, inf = _mul_batch("g2", base, pack_scalars(scalars))
    return [_unpack_g2(out[i], inf[i]) for i in range(len(out))]


# ---- Fr FFTs and vector ops --------------------------------------------------


def fr_fft(vals: np.ndarray, root: int, inverse: bool = False) -> np.ndarray:
    """In-place radix-2 FFT over Fr on a packed (n, 4) u64 canonical array."""
    rt = np.array(_limbs(root), dtype=np.uint64)
    _lib().zkm_bn254_fr_fft(
        _cptr(vals, ctypes.c_uint64), ctypes.c_int64(len(vals)),
        _cptr(rt, ctypes.c_uint64), ctypes.c_int32(1 if inverse else 0),
    )
    return vals


def fr_fft_mont(vals: np.ndarray, root: int, inverse: bool = False) -> np.ndarray:
    """In-place FFT on a Montgomery-domain packed array (no domain flips)."""
    rt = np.array(_limbs(root), dtype=np.uint64)
    _lib().zkm_bn254_fr_fft2(
        _cptr(vals, ctypes.c_uint64), ctypes.c_int64(len(vals)),
        _cptr(rt, ctypes.c_uint64), ctypes.c_int32(1 if inverse else 0), ctypes.c_int32(1),
    )
    return vals


def fr_scale_pows(vals: np.ndarray, g: int) -> np.ndarray:
    """vals[i] *= g^i in place (packed canonical array)."""
    gt = np.array(_limbs(g), dtype=np.uint64)
    _lib().zkm_bn254_fr_scale_pows(
        _cptr(vals, ctypes.c_uint64), ctypes.c_int64(len(vals)), _cptr(gt, ctypes.c_uint64)
    )
    return vals


def fr_mul_sub_scale(a: np.ndarray, b: np.ndarray, c: np.ndarray, k: int) -> np.ndarray:
    """(a*b - c) * k elementwise over packed canonical arrays."""
    kt = np.array(_limbs(k), dtype=np.uint64)
    out = np.zeros_like(a)
    _lib().zkm_bn254_fr_mul_sub_scale(
        _cptr(a, ctypes.c_uint64), _cptr(b, ctypes.c_uint64), _cptr(c, ctypes.c_uint64),
        ctypes.c_int64(len(a)), _cptr(kt, ctypes.c_uint64), _cptr(out, ctypes.c_uint64),
    )
    return out


def fr_vec_mont(arr: np.ndarray, to: bool = True) -> np.ndarray:
    """In-place Montgomery domain conversion of a packed Fr array."""
    _lib().zkm_bn254_fr_vec_mont(
        _cptr(arr, ctypes.c_uint64), ctypes.c_int64(len(arr)), ctypes.c_int32(1 if to else 0)
    )
    return arr


def _vec_addsub(a, b, sub):
    out = np.empty_like(a)
    _lib().zkm_bn254_fr_vec_addsub(
        _cptr(a, ctypes.c_uint64), _cptr(b, ctypes.c_uint64), _cptr(out, ctypes.c_uint64),
        ctypes.c_int64(len(a)), ctypes.c_int32(sub),
    )
    return out


def fr_vec_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _vec_addsub(a, b, 0)


def fr_vec_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _vec_addsub(a, b, 1)


def fr_vec_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pointwise product; inputs and outputs Montgomery."""
    out = np.empty_like(a)
    _lib().zkm_bn254_fr_vec_mul(
        _cptr(a, ctypes.c_uint64), _cptr(b, ctypes.c_uint64), _cptr(out, ctypes.c_uint64),
        ctypes.c_int64(len(a)),
    )
    return out


def fr_vec_scale_add(a: np.ndarray, k_m: np.ndarray, d_m: np.ndarray) -> np.ndarray:
    """a * k + d with Montgomery scalars k_m, d_m ((4,) u64)."""
    out = np.empty_like(a)
    _lib().zkm_bn254_fr_vec_scale_add(
        _cptr(a, ctypes.c_uint64), _cptr(k_m, ctypes.c_uint64), _cptr(d_m, ctypes.c_uint64),
        _cptr(out, ctypes.c_uint64), ctypes.c_int64(len(a)),
    )
    return out


def fr_vec_inv(a: np.ndarray) -> np.ndarray:
    """Pointwise batch inverse (Montgomery); zeros map to zero."""
    out = np.empty_like(a)
    _lib().zkm_bn254_fr_vec_inv(
        _cptr(a, ctypes.c_uint64), _cptr(out, ctypes.c_uint64), ctypes.c_int64(len(a))
    )
    return out


def fr_vec_powers(x_m: np.ndarray, s_m: np.ndarray, n: int) -> np.ndarray:
    """[s, s*x, s*x^2, ...] (Montgomery scalars in, packed array out)."""
    out = np.empty((n, 4), dtype=np.uint64)
    _lib().zkm_bn254_fr_vec_powers(
        _cptr(x_m, ctypes.c_uint64), _cptr(s_m, ctypes.c_uint64),
        _cptr(out, ctypes.c_uint64), ctypes.c_int64(n),
    )
    return out


def fr_vec_div_linear(a: np.ndarray, z_m: np.ndarray) -> np.ndarray:
    """a(X) / (X - z) in Montgomery; raises if the remainder is nonzero."""
    out = np.empty((len(a) - 1, 4), dtype=np.uint64)
    rem = _lib().zkm_bn254_fr_vec_div_linear(
        _cptr(a, ctypes.c_uint64), _cptr(z_m, ctypes.c_uint64),
        _cptr(out, ctypes.c_uint64), ctypes.c_int64(len(a)),
    )
    if rem:
        raise AssertionError("division by (X - z) leaves a remainder")
    return out

"""fd-indexed host hooks invoked through the WRITE syscall.

Analog of crates/core/executor/src/hook.rs: a guest writes a request buffer
to a hook fd (consts.rs:39-51) and the host splices the response vectors into
the input stream at the current read position, where the guest picks them up
via the hint syscalls.  Default hooks: ecrecover (fd 5), generic fp sqrt/inv
(fd 7/8), bls12-381 sqrt/inv (fd 9/10).
"""

from __future__ import annotations

from .curves import BLS12381, SECP256K1, SECP256R1

FD_ECRECOVER_HOOK = 5
FD_EDDECOMPRESS = 6
FD_FP_SQRT = 7
FD_FP_INV = 8
FD_BLS12_381_SQRT = 9
FD_BLS12_381_INVERSE = 10

# curve group orders (for the r^-1 scalar in ecrecover)
_ORDER = {
    1: 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    2: 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
}
_FIELD = {1: SECP256K1.p, 2: SECP256R1.p}
_NQR_256 = 3  # non-residue for both secp256k1 and secp256r1


class HookError(Exception):
    pass


def _be(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "big")


def hook_ecrecover(ex, buf: bytes):
    """[curve_id|odd<<7, r(32be), alpha(32be)] -> [1, y, r_inv] or [0, nqr_root]."""
    if len(buf) != 65:
        raise HookError(f"ecrecover buffer must be 65 bytes, got {len(buf)}")
    curve_id = buf[0] & 0x7F
    r_is_y_odd = bool(buf[0] & 0x80)
    if curve_id not in _FIELD:
        raise HookError(f"ecrecover: unsupported curve id {curve_id}")
    p, n = _FIELD[curve_id], _ORDER[curve_id]
    r = int.from_bytes(buf[1:33], "big")
    alpha = int.from_bytes(buf[33:65], "big") % p
    y = pow(alpha, (p + 1) // 4, p)
    if y * y % p == alpha:
        if (y & 1) != r_is_y_odd:
            y = p - y
        r_inv = pow(r, -1, n)
        return [b"\x01", _be(y, 32), _be(r_inv, 32)]
    root = pow(alpha * _NQR_256 % p, (p + 1) // 4, p)
    return [b"\x00", _be(root, 32)]


def _tonelli_shanks(element: int, modulus: int, nqr: int):
    if pow(element, (modulus - 1) // 2, modulus) != 1:
        return None
    if modulus % 4 == 3:
        root = pow(element, (modulus + 1) // 4, modulus)
        return root if root * root % modulus == element else None
    q, s = modulus - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    m, c = s, pow(nqr, q, modulus)
    t, r = pow(element, q, modulus), pow(element, (q + 1) // 2, modulus)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % modulus
            i += 1
            if i == m:
                return None
        b = pow(c, 1 << (m - i - 1), modulus)
        m, c = i, b * b % modulus
        t, r = t * c % modulus, r * b % modulus
    return r


def hook_fp_sqrt(ex, buf: bytes):
    """[len_be4 || elem || modulus || nqr] -> [status, root] (all big endian)."""
    if len(buf) < 4:
        raise HookError("fp_sqrt buffer too small")
    ln = int.from_bytes(buf[:4], "big")
    if len(buf) != 4 + 3 * ln:
        raise HookError(f"fp_sqrt buffer must be {4 + 3 * ln} bytes, got {len(buf)}")
    body = buf[4:]
    element = int.from_bytes(body[:ln], "big")
    modulus = int.from_bytes(body[ln:2 * ln], "big")
    nqr = int.from_bytes(body[2 * ln:], "big")
    if element >= modulus or nqr >= modulus:
        raise HookError("fp_sqrt: element/nqr not canonical")
    if element == 0:
        return [b"\x01", bytes(ln)]
    root = _tonelli_shanks(element, modulus, nqr)
    if root is not None:
        return [b"\x01", _be(root, ln)]
    root = _tonelli_shanks(nqr * element % modulus, modulus, nqr)
    return [b"\x00", _be(root, ln)]


def hook_fp_inverse(ex, buf: bytes):
    """[len_be4 || elem || modulus] -> [elem^-1] (big endian)."""
    if len(buf) < 4:
        raise HookError("fp_inverse buffer too small")
    ln = int.from_bytes(buf[:4], "big")
    if len(buf) != 4 + 2 * ln:
        raise HookError(f"fp_inverse buffer must be {4 + 2 * ln} bytes, got {len(buf)}")
    element = int.from_bytes(buf[4:4 + ln], "big")
    modulus = int.from_bytes(buf[4 + ln:], "big")
    if element == 0:
        raise HookError("fp_inverse: element is zero")
    return [_be(pow(element, modulus - 2, modulus), ln)]


def hook_bls12_381_sqrt(ex, buf: bytes):
    """48-byte BE element -> [status, root]; status 0 means root of 2*elem."""
    if len(buf) < 48:
        raise HookError("bls12_381_sqrt buffer too small")
    p = BLS12381.p
    fe = int.from_bytes(buf[:48], "big")
    if fe >= p:
        raise HookError("bls12_381_sqrt: element not canonical")
    if fe == 0:
        return [b"\x01", bytes(48)]
    root = pow(fe, (p + 1) // 4, p)
    if root * root % p == fe:
        return [b"\x01", _be(root, 48)]
    root = pow(2 * fe % p, (p + 1) // 4, p)
    return [b"\x00", _be(root, 48)]


def hook_bls12_381_inverse(ex, buf: bytes):
    if len(buf) < 48:
        raise HookError("bls12_381_inverse buffer too small")
    p = BLS12381.p
    fe = int.from_bytes(buf[:48], "big")
    if fe == 0:
        raise HookError("bls12_381_inverse: element is zero")
    return [_be(pow(fe, p - 2, p), 48)]


def default_registry() -> dict:
    return {
        FD_ECRECOVER_HOOK: hook_ecrecover,
        FD_FP_SQRT: hook_fp_sqrt,
        FD_FP_INV: hook_fp_inverse,
        FD_BLS12_381_SQRT: hook_bls12_381_sqrt,
        FD_BLS12_381_INVERSE: hook_bls12_381_inverse,
    }

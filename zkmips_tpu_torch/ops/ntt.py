"""Radix-2 NTT, inverse NTT and coset LDE over KoalaBear, plain torch.

Transforms run over axis 0 of (n, w) Montgomery matrices, every column at
once.  The butterflies stay in int64 for the whole transform and the result
is narrowed to int32 once.  Twiddle tables are built on the device and
cached per (log_n, direction, device).

Unlike the reference's radix-8 XLA network there is no width padding: that
worked around an XLA:TPU miscompile at w in {10, 12}; the values here are
the same transform's.
"""

from __future__ import annotations

import torch

from . import bits, field as f

_TWIDDLES: dict = {}


def _stage_twiddles(log_n: int, inverse: bool, device) -> list:
    key = (log_n, inverse, str(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = []
        for s in range(1, log_n + 1):
            w_m = f.two_adic_generator_int(s)
            if inverse:
                w_m = f.inv_int(w_m)
            tw.append(f.batch_powers(w_m, 1 << (s - 1), device).to(torch.int64))
        _TWIDDLES[key] = tw
    return tw


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order DIT NTT of (n,) or (n, w): coefficients -> evaluations over
    the order-n subgroup in natural order; ``inverse`` includes the 1/n scale."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n, w = x.shape
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    y = bits.bitrev_rows(x).to(torch.int64)
    for s, tw in enumerate(_stage_twiddles(log_n, inverse, x.device), start=1):
        half = 1 << (s - 1)
        v = y.view(n >> s, 2, half, w)
        even, odd = v[:, 0], v[:, 1]
        t = f.mul64(odd, tw[None, :, None])
        y = torch.stack([f.add64(even, t), f.sub64(even, t)], dim=1).view(n, w)
        del v, even, odd, t
    if inverse and n > 1:
        y = f.mul64(y, f.to_monty_int(f.inv_int(n)))
    out = f.narrow(y)
    return out[:, 0] if squeeze else out


def coset_lde(x: torch.Tensor, log_blowup: int = 1, shift: int = f.GENERATOR) -> torch.Tensor:
    """Evaluations on the size-n subgroup -> evaluations on shift * K of size
    n << log_blowup, natural order."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    coeffs = ntt(x, inverse=True)
    out = extend_coeffs(coeffs, shift, log_blowup)
    return out[:, 0] if squeeze else out


def coset_lde_bitrev(x: torch.Tensor, log_blowup: int = 1, shift: int = f.GENERATOR) -> torch.Tensor:
    """coset_lde in bit-reversed row order (the committed layout)."""
    return bits.bitrev_rows(coset_lde(x, log_blowup, shift))


def extend_coeffs(coeffs: torch.Tensor, shift: int, log_blowup: int) -> torch.Tensor:
    """Coefficients (n, w) -> evaluations on shift * <w_{n << log_blowup}>:
    scale by shift^i, zero-pad, forward NTT (natural order)."""
    n, w = coeffs.shape
    scaled = f.mul(coeffs, f.batch_powers(shift, n, coeffs.device)[:, None])
    padded = torch.zeros((n << log_blowup, w), dtype=torch.int32, device=coeffs.device)
    padded[:n] = scaled
    del scaled
    return ntt(padded)

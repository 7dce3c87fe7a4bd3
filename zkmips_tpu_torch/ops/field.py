"""KoalaBear base-field arithmetic on torch tensors.

p = 2^31 - 2^24 + 1 = 0x7f000001.  Elements are stored as ``torch.int32`` in
Montgomery form with R = 2^32, bit-identical to the reference's uint32
arrays (every value is below p < 2^31).  torch has no usable uint32
arithmetic on the CPU, so every operation widens to ``torch.int64``: a
product of two reduced elements is below 2^62.

The Montgomery product a*b*R^{-1} is formed as (a*b mod p) * R^{-1} mod p:
both products stay below 2^62, so int64 never overflows.  The ``*64``
helpers return int64 and also accept plain Python ints, which the host-side
transcript code uses.

The host-side trace fills of the MIPS chips and the septic curve work on
numpy arrays: every function here also takes numpy ``uint32`` arrays and
scalars (the same int64 arithmetic) and then returns numpy ``uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0x7F000001  # 2^31 - 2^24 + 1
MONTY_MU = 0x81000001  # P^{-1} mod 2^32
R2 = 0x17F7EFE4  # (2^32)^2 mod P
R_INV = pow(1 << 32, P - 2, P)  # (2^32)^-1 mod P
MONTY_ONE = 0x01FFFFFE  # 2^32 mod P
GENERATOR = 3
TWO_ADICITY = 24


# ---------------------------------------------------------------------------
# Scalar (python int) helpers
# ---------------------------------------------------------------------------


def to_monty_int(x: int) -> int:
    return (x << 32) % P


def from_monty_int(m: int) -> int:
    return (m * pow(1 << 32, P - 2, P)) % P


def inv_int(x: int) -> int:
    return pow(x, P - 2, P)


def two_adic_generator_int(bits: int) -> int:
    """g^((p-1) >> bits) with g = 3: the canonical 2^bits-th root of unity."""
    assert 0 <= bits <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> bits, P)


ONE = MONTY_ONE
TWO = to_monty_int(2)
HALF = to_monty_int((P + 1) // 2)


# ---------------------------------------------------------------------------
# Vectorized arithmetic (int64 core, int32 storage)
# ---------------------------------------------------------------------------


def _wide(x):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int64 else x.to(torch.int64)
    if isinstance(x, (np.ndarray, np.generic)):
        return x.astype(np.int64)
    return x


def narrow(x):
    """int64 field values -> storage: int32 tensor, or numpy uint32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return x.astype(np.uint32)


def monty_const(x: int) -> np.uint32:
    """Montgomery-form numpy scalar of a canonical Python int constant."""
    return np.uint32(to_monty_int(x % P))


def mul64(a, b):
    """Montgomery product a*b*R^{-1} mod p as int64 (inputs in [0, p)): the
    product reduced mod p, times R^{-1} mod p, reduced again.  Both products
    stay below 2^62; four tensor operations, where the shift-add reduction
    took a dozen."""
    return _wide(a) * _wide(b) % P * R_INV % P


def add64(a, b):
    return (_wide(a) + _wide(b)) % P


def sub64(a, b):
    return (_wide(a) - _wide(b)) % P


def mul(a, b) -> torch.Tensor:
    return narrow(mul64(a, b))


def add(a, b) -> torch.Tensor:
    return narrow(add64(a, b))


def sub(a, b) -> torch.Tensor:
    return narrow(sub64(a, b))


def neg(a) -> torch.Tensor:
    return narrow(sub64(0, a))


def double(a) -> torch.Tensor:
    return add(a, a)


def square(a) -> torch.Tensor:
    return mul(a, a)


def from_monty(m) -> torch.Tensor:
    """Montgomery -> canonical (a Montgomery product with 1)."""
    return mul(m, 1)


def to_monty(x) -> torch.Tensor:
    """Canonical (< p) -> Montgomery."""
    return mul(x, R2)


def pow_const(a, e: int) -> torch.Tensor:
    """a ** e for a fixed exponent (square-and-multiply)."""
    if e == 0:
        return narrow(_wide(a) * 0 + MONTY_ONE)
    acc = None
    base = _wide(a)
    while e:
        if e & 1:
            acc = base if acc is None else mul64(acc, base)
        e >>= 1
        if e:
            base = mul64(base, base)
    return narrow(acc)


def inv(a) -> torch.Tensor:
    """Pointwise inverse a^(p-2); zero maps to zero."""
    return pow_const(a, P - 2)


def batch_powers(base_int: int, n: int, device="cpu") -> torch.Tensor:
    """[1, b, ..., b^(n-1)] in Montgomery form (int32), by log-doubling."""
    out = torch.full((1,), MONTY_ONE, dtype=torch.int64, device=device)
    cur = base_int % P
    while out.shape[0] < n:
        out = torch.cat([out, mul64(out, to_monty_int(cur))])
        cur = cur * cur % P
    return narrow(out[:n])

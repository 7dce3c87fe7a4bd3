"""Quartic extension F_{p^4} = F_p[X]/(X^4 - 3): the STARK challenge field.

Tensors with a trailing axis of 4 (c0 + c1 X + c2 X^2 + c3 X^3), each
coefficient a Montgomery int32.  Sums of Montgomery products are formed in
int64 and reduced once (``% p``): the field value is unique, so this matches
the reference's add-after-every-product chain bit for bit.
"""

from __future__ import annotations

import torch

from . import field as f

W = 3  # X^4 = 3
D = 4

_U1 = pow(W, (f.P - 1) // 4, f.P)
# Montgomery Frobenius scale factors u^(i*k) for frob^k, i in 0..3
_FROB_M = [[f.to_monty_int(pow(_U1, i * k, f.P)) for i in range(4)] for k in range(4)]


def scalar(c0: int, c1: int = 0, c2: int = 0, c3: int = 0, device="cpu") -> torch.Tensor:
    """Ext element from canonical ints."""
    return torch.tensor(
        [f.to_monty_int(c % f.P) for c in (c0, c1, c2, c3)], dtype=torch.int32, device=device
    )


def one(device="cpu") -> torch.Tensor:
    return scalar(1, device=device)


def zero(device="cpu") -> torch.Tensor:
    return scalar(0, device=device)


ONE = one()
ZERO = zero()


def zeros_like(a) -> torch.Tensor:
    return torch.zeros_like(torch.as_tensor(a))


def from_base(x) -> torch.Tensor:
    """(...,) base -> (..., 4) ext."""
    x = torch.as_tensor(x, dtype=torch.int32)
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z], dim=-1)


def add(a, b) -> torch.Tensor:
    return f.add(a, b)


def sub(a, b) -> torch.Tensor:
    return f.sub(a, b)


def neg(a) -> torch.Tensor:
    return f.neg(a)


# The schoolbook product's 16 terms a_i * b_j (flattened as 4 i + j) go to
# coefficient (i + j) mod 4, times 3 where i + j >= 4 (X^4 = 3).  _TERMS lists
# them grouped by coefficient.
_WEIGHT = [3 if i + j >= 4 else 1 for i in range(4) for j in range(4)]
_TERMS = [4 * i + (k - i) % 4 for k in range(4) for i in range(4)]
_TABLES: dict = {}


def _tables(device):
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = (torch.tensor(_WEIGHT, dtype=torch.int64, device=device),
                            torch.tensor(_TERMS, dtype=torch.int64, device=device))
    return t


def _mul64(a, b) -> torch.Tensor:
    """Schoolbook product with X^4 = 3: the (..., 4) int64 coefficient sums,
    from one Montgomery product of every coefficient pair."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    weight, terms = _tables(a.device)
    prod = f.mul64(a[..., :, None], b[..., None, :]).flatten(-2) * weight
    return prod[..., terms].unflatten(-1, (4, 4)).sum(-1)


def mul(a, b) -> torch.Tensor:
    return f.narrow(_mul64(a, b) % f.P)


def mul_base(a, b) -> torch.Tensor:
    """ext (..., 4) * base (...,)."""
    b = torch.as_tensor(b)
    return f.mul(a, b[..., None] if b.dim() else b)


def square(a) -> torch.Tensor:
    return mul(a, a)


def pow_const(a, e: int) -> torch.Tensor:
    if e == 0:
        return torch.zeros_like(a) + one(a.device)
    acc = None
    base = a
    while e:
        if e & 1:
            acc = base if acc is None else mul(acc, base)
        e >>= 1
        if e:
            base = square(base)
    return acc


def frobenius(a, k: int = 1) -> torch.Tensor:
    """a^(p^k): coefficient-wise scale."""
    return f.mul(a, torch.tensor(_FROB_M[k % 4], dtype=torch.int64, device=a.device))


def inv(a) -> torch.Tensor:
    """a^{-1} = (product of conjugates) / N(a); zero maps to zero."""
    b = mul(mul(frobenius(a, 1), frobenius(a, 2)), frobenius(a, 3))
    norm = f.narrow(_mul64(a, b)[..., 0] % f.P)  # a*b lies in the base field
    return mul_base(b, f.inv(norm))


def to_canonical(a) -> torch.Tensor:
    return f.from_monty(a)


def powers(base, n: int) -> torch.Tensor:
    """(n, 4): [1, base, ..., base^(n-1)] by log-doubling."""
    out = one(base.device)[None, :]
    cur = base[None, :]
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, cur)], dim=0)
        cur = mul(cur, cur)
    return out[:n]


def powers_host(base, n: int) -> torch.Tensor:
    """(n, 4) CPU tensor [1, base, ..., base^(n-1)]."""
    return powers(torch.as_tensor(base, dtype=torch.int32).cpu(), n)

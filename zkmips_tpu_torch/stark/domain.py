"""Two-adic multiplicative coset domains (host-side protocol objects).

Shifts are canonical Python ints; points off the domain are quartic
extension elements (CPU (4,) int32 tensors, Montgomery).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import bits, ext4, field as f


@dataclass(frozen=True)
class Domain:
    """Coset shift * <w> of size 2^log_n, w = two_adic_generator(log_n)."""

    log_n: int
    shift: int = 1

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def gen(self) -> int:
        return f.two_adic_generator_int(self.log_n)

    def first_point_ext(self) -> torch.Tensor:
        return ext4.scalar(self.shift)

    def next_point_ext(self, z: torch.Tensor) -> torch.Tensor:
        """z * w: the 'next row' opening point."""
        return ext4.mul_base(z, f.to_monty_int(self.gen))

    def zp_at_point_ext(self, z: torch.Tensor) -> torch.Tensor:
        """Vanishing polynomial (z / shift)^n - 1."""
        zs = ext4.mul_base(z, f.to_monty_int(f.inv_int(self.shift)))
        return ext4.sub(ext4.pow_const(zs, self.size), ext4.one())

    def zp_at_point_int(self, x: int) -> int:
        return (pow(x * f.inv_int(self.shift) % f.P, self.size, f.P) - 1) % f.P

    def selectors_at_point_ext(self, z: torch.Tensor) -> dict:
        """is_first_row, is_last_row, is_transition and 1/Z_H at z."""
        unshifted = ext4.mul_base(z, f.to_monty_int(f.inv_int(self.shift)))
        z_h = ext4.sub(ext4.pow_const(unshifted, self.size), ext4.one())
        first = ext4.sub(unshifted, ext4.one())
        last = ext4.sub(unshifted, ext4.scalar(f.inv_int(self.gen)))
        return {
            "is_first_row": ext4.mul(z_h, ext4.inv(first)),
            "is_last_row": ext4.mul(z_h, ext4.inv(last)),
            "is_transition": last,
            "inv_zeroifier": ext4.inv(z_h),
        }

    def create_disjoint_domain(self, min_size: int) -> "Domain":
        """Disjoint coset of at least min_size: shift times GENERATOR."""
        return Domain(max(self.log_n, (min_size - 1).bit_length()), self.shift * f.GENERATOR % f.P)

    def split_domains(self, num_chunks: int) -> list["Domain"]:
        """``num_chunks`` stride-interleaved sub-cosets."""
        log_chunks = num_chunks.bit_length() - 1
        assert 1 << log_chunks == num_chunks and log_chunks <= self.log_n
        w = self.gen
        return [
            Domain(self.log_n - log_chunks, self.shift * pow(w, i, f.P) % f.P)
            for i in range(num_chunks)
        ]

    def points_natural(self, device="cpu") -> torch.Tensor:
        """Canonical int32 points shift * w^i in natural order."""
        return f.from_monty(f.mul(f.batch_powers(self.gen, self.size, device), f.to_monty_int(self.shift % f.P)))


def lde_points_bitrev_monty(log_n: int, device="cpu") -> torch.Tensor:
    """Points of the committed LDE coset g * <w_n>, bit-reversed order
    (x = g * w^rev(i)), Montgomery int32."""
    pts = f.mul(f.batch_powers(f.two_adic_generator_int(log_n), 1 << log_n, device),
                f.to_monty_int(f.GENERATOR))
    return bits.bitrev_rows(pts)


def fold_inv_2x_monty(log_n: int, device="cpu") -> torch.Tensor:
    """1 / (2 * w_n^{rev_{n/2}(t)}) for the FRI fold at layer size 2^log_n
    (the fold runs over the plain subgroup, no coset shift)."""
    nat = f.batch_powers(f.two_adic_generator_int(log_n), max(1 << (log_n - 1), 1), device)
    xs = bits.bitrev_rows(nat) if log_n > 1 else nat
    return f.inv(f.mul(xs, f.TWO))

"""Fiat-Shamir challenger for the outer (BN254) config.

Plonky3's ``MultiField32Challenger<KoalaBear, Bn254Fr, Poseidon2, 3, 2>``,
with the semantics of the reference's in-circuit mirror
(crates/recursion/circuit/src/challenger.rs:236-326):

* state = 3 BN254 scalars; a duplex absorbs up to RATE(2) * PACK(3) = 6
  KoalaBear felts, packing each chunk of 3 into one Fr with a 2^32 stride
  (``reduce_32``) and OVERWRITING state[0..1];
* after the permutation the output buffer is refilled with
  split_32(state[i], 3) for all three state elements; ``sample`` pops from
  the END;
* commitments (single-Fr digests) are observed as their 3 split felts.

It has the interface of ``DuplexChallenger``, so the PCS and the machine
take either transcript.  Everything runs on the host, the proof-of-work
search included (one permutation per candidate).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bn254, ext4, field as f

PACK = bn254.CHALLENGER_PACK  # 3 felts per Fr
RATE = bn254.CHALLENGER_RATE  # 2 Fr slots per duplex


class MultiField32Challenger:
    def __init__(self):
        self.state = [0, 0, 0]  # Fr canonical ints
        self.input_buffer: list[int] = []  # KoalaBear canonical ints
        self.output_buffer: list[int] = []

    def clone(self) -> "MultiField32Challenger":
        c = MultiField32Challenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= PACK * RATE
        for i in range(0, len(self.input_buffer), PACK):
            self.state[i // PACK] = bn254.reduce_32(self.input_buffer[i : i + PACK])
        self.input_buffer.clear()
        self.state = bn254.permute3(self.state)
        self.output_buffer = []
        for pf in self.state:
            self.output_buffer.extend(bn254.split_32(pf, PACK))

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % f.P)
        if len(self.input_buffer) == PACK * RATE:
            self._duplexing()

    def observe_slice(self, values):
        """Observe canonical values (a tensor, array or sequence of ints)."""
        if isinstance(values, torch.Tensor):
            values = values.reshape(-1).tolist()
        else:
            values = np.asarray(values).reshape(-1).tolist()
        for v in values:
            self.observe(v)

    def observe_digest(self, digest):
        """Observe a (1,) BN254 digest as its 3 split felts."""
        for val in np.asarray(digest).reshape(-1):
            for felt in bn254.split_32(int(val), PACK):
                self.observe(felt)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> torch.Tensor:
        """A quartic-extension challenge, Montgomery (4,) int32 on the CPU."""
        return ext4.scalar(self.sample(), self.sample(), self.sample(), self.sample())

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def grind(self, bits: int, device=None) -> int:
        """Smallest witness w such that observing w then sampling ``bits``
        bits gives 0, searched on the host (``device`` is not used)."""
        if bits == 0:
            return 0
        w = 0
        while not self.clone().check_witness(bits, w):
            w += 1
        return w

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

"""Fiat-Shamir duplex challenger over Poseidon2-KoalaBear, width 16 / rate 8.

Host-side, Python ints (the transcript is sequential and tiny).  Semantics
of the reference's DuplexChallenger: observing clears the output buffer and
absorbs in rate-sized chunks by overwrite; sampling pops from the end of the
output buffer.  Observed and sampled values are canonical; the sponge state
is Montgomery.

The proof-of-work search (``grind``) permutes a batch of candidate states
at once on the given device; on a CUDA device that is the Poseidon2
``permute`` kernel.  It returns the smallest witness, whatever the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ext4, field as f, poseidon2 as p2

WIDTH = 16
RATE = 8


class DuplexChallenger:
    def __init__(self):
        self.state = [0] * WIDTH  # Montgomery ints
        self.input_buffer: list[int] = []  # canonical ints
        self.output_buffer: list[int] = []  # canonical ints

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = f.to_monty_int(v)
        self.input_buffer.clear()
        self.state = p2.permute_ints(self.state)
        self.output_buffer = [f.from_monty_int(x) for x in self.state[:RATE]]

    def observe(self, value: int):
        """Observe one canonical field element."""
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % f.P)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values):
        """Observe canonical values (a tensor, array or sequence of ints)."""
        if isinstance(values, torch.Tensor):
            values = values.reshape(-1).tolist()
        else:
            values = np.asarray(values).reshape(-1).tolist()
        for v in values:
            self.observe(v)

    def observe_digest(self, digest_monty: torch.Tensor):
        """Observe an 8-element digest given in Montgomery form."""
        self.observe_slice(f.from_monty(torch.as_tensor(digest_monty).cpu()))

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> torch.Tensor:
        """A quartic-extension challenge, Montgomery (4,) int32 on the CPU."""
        return ext4.scalar(self.sample(), self.sample(), self.sample(), self.sample())

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def grind(self, bits: int, device="cpu") -> int:
        """Smallest witness w such that observing w then sampling ``bits``
        bits gives 0; candidates are searched in batches on ``device``."""
        if bits == 0:
            return 0
        device = torch.device(device)
        batch = 1 << 18 if device.type == "cuda" else 1 << max(10, bits - 2)
        pending = list(self.input_buffer)
        assert len(pending) < RATE  # the witness absorb never triggers a duplex early
        base = list(self.state)
        for i, v in enumerate(pending):
            base[i] = f.to_monty_int(v)
        base_t = torch.tensor(base, dtype=torch.int32, device=device)
        mask = (1 << bits) - 1
        start = 0
        while True:
            wit = torch.arange(start, start + batch, dtype=torch.int64, device=device) % f.P
            states = base_t.expand(batch, WIDTH).clone()
            states[:, len(pending)] = f.to_monty(wit)
            out = p2.permute(states)
            # sample() pops the last lane of the refreshed rate
            sampled = f.from_monty(out[:, RATE - 1])
            hits = torch.nonzero((sampled & mask) == 0)
            if hits.numel():
                return int(wit[hits[0, 0]])
            start += batch

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

"""The Poseidon2 work a STARK proof needs, counted from the proof's own shapes.

Every commitment of a shard proof is a mixed-height Merkle tree: the rows of
the matrices of one height are concatenated and hashed by the width-16
sponge of rate 8 (a row of width w takes ceil(w / 8) permutations), and the
tree is built by 2-to-1 compressions (one permutation each): H - 1 for the
tallest height H, plus h more at every lower height h that has matrices of
its own.  Per proof, in the window:

* the main trace, the permutation (LogUp) trace and the quotient chunks:
  one matrix per chip (per chunk) of height 2^(log_degree + log_blowup),
  with the widths the opened values give (main_local: w rows; perm_local:
  the 4 base limbs of each extension column; each quotient chunk: 4);
* one FRI layer a fold, of 2^(log_max - 1 - k) rows of 8;
* the grind: the PoW witness plus one permutation, since it returns the
  smallest witness.

The preprocessed trace is committed once, at set-up, and is not counted.
Bytes count each input element read once and each digest written once.
Nothing here imports the program: it reads the proof's attributes.
"""

from __future__ import annotations

from dataclasses import dataclass

RATE, DIGEST = 8, 8  # the sponge's rate and a digest, in field elements
WORD = 4


@dataclass
class Work:
    hash_perms: int = 0  # sponge permutations (K1)
    hash_bytes: int = 0
    compressions: int = 0  # 2-to-1 compressions (K2)
    compress_bytes: int = 0
    grind_perms: int = 0  # the grind's permutations

    def __iadd__(self, o: "Work"):
        for k in self.__dataclass_fields__:
            setattr(self, k, getattr(self, k) + getattr(o, k))
        return self

    @property
    def perms(self) -> int:
        return self.hash_perms + self.compressions + self.grind_perms

    @property
    def bytes(self) -> int:
        return self.hash_bytes + self.compress_bytes  # the grind reads and writes one state


def tree(matrices: list) -> Work:
    """A mixed-height tree over [(log_height, width)]."""
    by_h: dict = {}
    for log_h, w in matrices:
        by_h[log_h] = by_h.get(log_h, 0) + int(w)
    out = Work()
    for log_h, w in by_h.items():
        rows = 1 << log_h
        out.hash_perms += rows * -(-w // RATE)
        out.hash_bytes += rows * (w + DIGEST) * WORD
    top = max(by_h)
    n = (1 << top) - 1 + sum(1 << h for h in by_h if h < top)
    out.compressions += n
    out.compress_bytes += n * 3 * DIGEST * WORD
    return out


def proof(p, log_blowup: int) -> Work:
    """Work of one shard proof (a core or a recursion shard)."""
    main, perm, quot = [], [], []
    for ov in p.opened:
        log_h = int(ov.log_degree) + log_blowup
        main.append((log_h, ov.main_local.shape[0]))
        if ov.perm_local.shape[0]:
            perm.append((log_h, ov.perm_local.shape[0]))
        quot += [(log_h, 4)] * len(ov.quotient)
    out = Work()
    for mats in (main, perm, quot):
        if mats:
            out += tree(mats)
    fri = p.fri_proof
    log_max = len(fri.commit_roots) + log_blowup
    for k in range(len(fri.commit_roots)):
        out += tree([(log_max - 1 - k, 2 * 4)])
    out.grind_perms += int(fri.pow_witness) + 1
    return out


def roofline(work: Work, peak: dict) -> dict:
    """The least time one card needs for ``work``: the larger of the bytes
    over the memory bandwidth and the multiplies over the multiply rate."""
    ops_s = work.perms * peak["mul32_per_permutation"] / peak["mul32_per_s"]
    bytes_s = work.bytes / peak["hbm_bytes_per_s"]
    return {"least_s": max(ops_s, bytes_s), "bound": "operations" if ops_s >= bytes_s else "bytes",
            "ops_s": ops_s, "bytes_s": bytes_s}


KERNELS = ("hash_rows_kernel", "permute_kernel")  # K1; K2 and the grind


def p2_roofline(proofs: list, kernel_s: dict, peak: dict) -> float | None:
    """The Poseidon2 kernels' share of their roofline, in %: the least time
    for the permutations of ``proofs`` ([(log_blowup, proof)]) over the
    device seconds of the kernels by name.  None when there is nothing to
    read."""
    busy = sum(s for name, s in kernel_s.items() if any(k in name for k in KERNELS))
    if busy <= 0 or not proofs or peak is None:
        return None
    return 100.0 * roofline(total(proofs), peak)["least_s"] / busy


def total(proofs: list) -> Work:
    """The work of [(log_blowup, proof)]."""
    out = Work()
    for log_blowup, p in proofs:
        out += proof(p, log_blowup)
    return out

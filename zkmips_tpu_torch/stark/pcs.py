"""Two-adic FRI polynomial commitment scheme over KoalaBear / quartic ext.

The reference's protocol (``zkmips_tpu/stark/pcs.py``):

  * commit: each matrix of evaluations over a coset (n, shift s) is extended
    onto the standard coset (n << log_blowup, shift g), rows bit-reversed,
    and the batch is committed in one mixed-height Merkle tree;
  * open: alpha is sampled first; per log-height a reduced vector
    ro_H(x) = sum alpha^{k_H++} * (p_j(z) - p_j(x)) / (z - x), with one
    alpha-power counter per height;
  * FRI: the tallest reduced vector is folded in halves over the plain
    subgroup, one Merkle commit and one beta challenge per layer, lower
    reduced vectors injected with beta^2, a constant final polynomial, the
    proof-of-work grind, then the query indices.

Heavy work runs on the committed matrices' device.  The transcript stays on
the host: each fold layer's root is read back before its beta is sampled
(the reference instead runs the sponge inside its fused fold kernel; the
values are the same).  The verifier runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import bits, ext4, field as f, merkle, ntt
from .challenger import DuplexChallenger
from .domain import Domain, fold_inv_2x_monty, lde_points_bitrev_monty


@dataclass(frozen=True)
class FriConfig:
    """FRI parameters, the reference's values (kb31_poseidon2.rs:54-63,203-240).

    ``hash_family`` names the Merkle and transcript hash: ``"kb"``
    (Poseidon2 over KoalaBear) is the one the port has; ``"bn254"`` (the
    wrap stage's outer config) is not ported and raises."""

    log_blowup: int = 1
    num_queries: int = 84
    proof_of_work_bits: int = 16
    hash_family: str = "kb"

    def __post_init__(self):
        if self.hash_family == "bn254":
            raise NotImplementedError(
                "hash family 'bn254': the BN254 outer config is not ported "
                "(ROADMAP queue 1 item 7a)"
            )
        if self.hash_family != "kb":
            raise ValueError(f"unknown hash family {self.hash_family!r}")

    @staticmethod
    def core() -> "FriConfig":
        return FriConfig(1, 84, 16)

    @staticmethod
    def compressed() -> "FriConfig":
        """The recursion prover's config: blowup 4, 42 queries."""
        return FriConfig(2, 42, 16)

    @staticmethod
    def ultra_compressed() -> "FriConfig":
        """The shrink stage's config: blowup 8, 28 queries."""
        return FriConfig(3, 28, 16)

    @staticmethod
    def test() -> "FriConfig":
        """Small config for fast unit tests (NOT sound)."""
        return FriConfig(1, 8, 4)


@dataclass
class ProverData:
    """A batch commit: coefficients, bit-reversed LDEs and their tree."""

    domains: list
    coeffs: list | None  # per matrix (n, w) coefficients wrt its own domain
    ldes: list  # per matrix (n << log_blowup, w) bit-reversed LDE on the shift-g coset
    tree: merkle.MerkleTree
    log_blowup: int = 1
    persistent: bool = False  # program-lifetime data: open_batches keeps its coeffs

    @property
    def root(self) -> torch.Tensor:
        return self.tree.root


def commit(config: FriConfig, domains_and_matrices) -> ProverData:
    """Commit to [(Domain, evals (n, w) Montgomery int32, natural order)]."""
    coeffs, ldes = [], []
    for dom, evals in domains_and_matrices:
        assert evals.shape[0] == dom.size, "evals height must match domain size"
        c = ntt.ntt(evals, inverse=True)
        rel_shift = f.GENERATOR * f.inv_int(dom.shift) % f.P
        ldes.append(bits.bitrev_rows(ntt.extend_coeffs(c, rel_shift, config.log_blowup)))
        coeffs.append(c)
    domains = [d for d, _ in domains_and_matrices]
    return ProverData(domains, coeffs, ldes, merkle.MerkleTree(ldes), config.log_blowup)


def eval_at_ext_point(coeffs: torch.Tensor, dom: Domain, z: torch.Tensor) -> torch.Tensor:
    """Every column polynomial at ext point z: p(z) = sum_i c_i (z/s)^i.
    Returns (w, 4) on the CPU."""
    n = coeffs.shape[0]
    zs = ext4.mul_base(z.to(coeffs.device), f.to_monty_int(f.inv_int(dom.shift)))
    zpows = ext4.powers(zs, n)
    out = [bits.sum_mod(f.mul64(coeffs, zpows[:, c : c + 1]), dim=0) for c in range(4)]
    return torch.stack(out, dim=-1).cpu()


# ---------------------------------------------------------------------------
# Proof structures
# ---------------------------------------------------------------------------


@dataclass
class CommitPhaseOpening:
    sibling_value: torch.Tensor  # (4,) ext
    siblings: torch.Tensor  # (log, 8) Merkle path


@dataclass
class QueryProof:
    input_openings: list  # per round: (rows list, siblings (log, 8))
    commit_openings: list  # CommitPhaseOpening per fold layer


@dataclass
class FriProof:
    commit_roots: list  # (8,) digests, one per fold layer
    final_poly: torch.Tensor  # (4,) ext
    pow_witness: int
    query_proofs: list


# ---------------------------------------------------------------------------
# Open
# ---------------------------------------------------------------------------


def _reduce_height(parts, log_h: int) -> torch.Tensor:
    """Reduced opening vector (2^log_h, 4) from [(lde, z, ys, apows)], one
    denominator inverse per distinct point z."""
    dev = parts[0][0].device
    x_ext = ext4.from_base(lde_points_bitrev_monty(log_h, dev))
    by_z: dict = {}
    for part in parts:
        by_z.setdefault(tuple(part[1].tolist()), []).append(part)
    acc = None
    for plist in by_z.values():
        num = None
        for lde, _z, ys, apows in plist:
            apows_d = apows.to(dev)
            s_val = bits.sum_mod(ext4.mul(apows_d, ys.to(dev)), dim=0)  # (4,)
            t_vec = torch.stack(
                [bits.sum_mod(f.mul64(lde, apows_d[None, :, c]), dim=1) for c in range(4)], dim=-1
            )
            pn = f.sub64(s_val[None, :], t_vec)
            num = pn if num is None else num + pn
        denom = ext4.sub(plist[0][1].to(dev)[None, :], x_ext)
        contrib = ext4.mul(f.narrow(num % f.P), ext4.inv(denom)).to(torch.int64)
        acc = contrib if acc is None else acc + contrib
    return f.narrow(acc % f.P)


def _fold_commit(cur: torch.Tensor):
    """FRI layer matrix (n/2, 8) = [even ext | odd ext] rows, and its tree layers."""
    layer_mat = torch.cat([cur[0::2], cur[1::2]], dim=1)
    return layer_mat, merkle.build_layers([layer_mat])


def _fold_step(cur, beta, nxt, log_h: int) -> torch.Tensor:
    """f(x), f(-x) -> (f_e + beta f_o) over the half-size subgroup, plus
    beta^2 times the injected reduced vector of that height."""
    dev = cur.device
    beta = beta.to(dev)
    evens, odds = cur[0::2], cur[1::2]
    half_sum = ext4.mul_base(ext4.add(evens, odds), f.HALF)
    half_diff = ext4.mul_base(ext4.sub(evens, odds), fold_inv_2x_monty(log_h, dev))
    folded = ext4.add(half_sum, ext4.mul(beta[None, :], half_diff))
    if nxt is not None:
        folded = ext4.add(folded, ext4.mul(ext4.mul(beta, beta)[None, :], nxt))
    return folded


def open_batches(config: FriConfig, rounds: list, challenger: DuplexChallenger):
    """Open every committed matrix at its points.

    rounds: [(ProverData, points_per_matrix: [[(4,) ext, ...], ...])].
    Returns (opened_values[round][matrix][point] (w, 4) CPU, FriProof)."""
    from ..utils.logger import span

    alpha = challenger.sample_ext()

    with span("open.eval"):
        opened_values = [
            [[eval_at_ext_point(c, dom, z) for z in pts]
             for c, dom, pts in zip(pdata.coeffs, pdata.domains, points_per_mat)]
            for pdata, points_per_mat in rounds
        ]
    # the coefficients' last consumer is the evaluation above, except for
    # program-lifetime (preprocessed) data that later shards reuse
    for pdata, _pts in rounds:
        if not pdata.persistent:
            pdata.coeffs = None

    with span("open.reduce"):
        n_apows = sum(lde.shape[1] * len(pts) for pdata, ppm in rounds
                      for lde, pts in zip(pdata.ldes, ppm))
        alpha_pows = ext4.powers(alpha, n_apows)
        alpha_count: dict[int, int] = {}
        by_height: dict[int, list] = {}
        for (pdata, points_per_mat), mats_vals in zip(rounds, opened_values):
            for lde, dom, pts, vals in zip(pdata.ldes, pdata.domains, points_per_mat, mats_vals):
                log_h = dom.log_n + config.log_blowup
                w = lde.shape[1]
                for z, ys in zip(pts, vals):
                    k0 = alpha_count.get(log_h, 0)
                    alpha_count[log_h] = k0 + w
                    by_height.setdefault(log_h, []).append((lde, z, ys, alpha_pows[k0 : k0 + w]))
        reduced = {log_h: _reduce_height(parts, log_h) for log_h, parts in by_height.items()}
    log_max = max(reduced)
    assert min(reduced) > config.log_blowup, "matrices at the minimum height are unsupported"

    with span("open.fold"):
        cur = reduced[log_max]
        commit_roots, layer_trees = [], []
        layer_mat, layers = _fold_commit(cur)
        for log_h in range(log_max, config.log_blowup, -1):
            tree = merkle.MerkleTree([layer_mat], layers=layers)
            layer_trees.append(tree)
            root = tree.root
            commit_roots.append(root)
            challenger.observe_digest(root)
            beta = challenger.sample_ext()
            nxt = reduced.get(log_h - 1)
            use_next = nxt is not None and log_h - 1 > config.log_blowup
            cur = _fold_step(cur, beta, nxt if use_next else None, log_h)
            if log_h - 1 > config.log_blowup:
                layer_mat, layers = _fold_commit(cur)
        final_poly = cur[0].cpu()

    challenger.observe_slice(ext4.to_canonical(final_poly))
    with span("open.grind"):
        pow_witness = challenger.grind(config.proof_of_work_bits, cur.device)
    assert challenger.check_witness(config.proof_of_work_bits, pow_witness)

    indices = [challenger.sample_bits(log_max) for _ in range(config.num_queries)]

    with span("open.queries"):
        idx = torch.tensor(indices, dtype=torch.int64)
        per_round = []
        for pdata, _pts in rounds:
            batch_log_max = max(d.log_n for d in pdata.domains) + config.log_blowup
            per_round.append(pdata.tree.open_many(idx >> (log_max - batch_log_max)))
        per_layer = []
        for k, tree in enumerate(layer_trees):
            rows, sibs = tree.open_many((idx >> k) >> 1)
            per_layer.append((rows[0], sibs))

    query_proofs = []
    for qi, index in enumerate(indices):
        input_openings = [([m[qi] for m in rows], sibs[qi]) for rows, sibs in per_round]
        commit_openings = []
        for k, (rows, sibs) in enumerate(per_layer):
            row = rows[qi]  # (8,) = [even ext, odd ext]
            sibling = row[4:8] if (index >> k) & 1 == 0 else row[0:4]
            commit_openings.append(CommitPhaseOpening(sibling, sibs[qi]))
        query_proofs.append(QueryProof(input_openings, commit_openings))
    return opened_values, FriProof(commit_roots, final_poly, pow_witness, query_proofs)


# ---------------------------------------------------------------------------
# Verify (CPU)
# ---------------------------------------------------------------------------


class PcsError(Exception):
    pass


def _bitrev_int(i: int, nbits: int) -> int:
    r = 0
    for b in range(nbits):
        r |= ((i >> b) & 1) << (nbits - 1 - b)
    return r


def _lde_points_at(log_h: int, idx: torch.Tensor) -> torch.Tensor:
    """Montgomery g * w^rev(i) for the queried rows only."""
    w = f.two_adic_generator_int(log_h)
    return torch.tensor(
        [f.to_monty_int(f.GENERATOR * pow(w, _bitrev_int(int(i), log_h), f.P) % f.P)
         for i in idx.tolist()],
        dtype=torch.int32,
    )


def verify_batches(config: FriConfig, rounds_info: list, proof: FriProof,
                   challenger: DuplexChallenger):
    """rounds_info: [(root, [(Domain, [(z, ys (w, 4)), ...]) per matrix])].
    Raises PcsError on failure."""
    alpha = challenger.sample_ext()
    betas = []
    for root in proof.commit_roots:
        challenger.observe_digest(root)
        betas.append(challenger.sample_ext())
    challenger.observe_slice(ext4.to_canonical(torch.as_tensor(proof.final_poly)))
    if not challenger.check_witness(config.proof_of_work_bits, proof.pow_witness):
        raise PcsError("invalid proof-of-work witness")
    log_max = len(proof.commit_roots) + config.log_blowup
    if len(proof.query_proofs) != config.num_queries:
        raise PcsError("wrong number of query proofs")
    indices = [challenger.sample_bits(log_max) for _ in range(config.num_queries)]
    idx = torch.tensor(indices, dtype=torch.int64)
    qps = proof.query_proofs
    for qp in qps:
        if len(qp.input_openings) != len(rounds_info):
            raise PcsError("wrong number of input openings")
        if len(qp.commit_openings) != len(betas):
            raise PcsError("wrong number of commit-phase openings")

    n_apows = sum(torch.as_tensor(ys).shape[0] for _root, mats in rounds_info
                  for _dom, pts in mats for _z, ys in pts)
    alpha_pows = ext4.powers(alpha, n_apows)
    ro: dict[int, torch.Tensor] = {}  # log_h -> (Q, 4)
    apow_count: dict[int, int] = {}
    for ri, (root, mats) in enumerate(rounds_info):
        rows_per_mat = [
            torch.stack([torch.as_tensor(qp.input_openings[ri][0][m], dtype=torch.int32) for qp in qps])
            for m in range(len(mats))
        ]
        sibs = torch.stack([torch.as_tensor(qp.input_openings[ri][1], dtype=torch.int32) for qp in qps])
        dims = [(dom.size << config.log_blowup, r.shape[1]) for (dom, _pts), r in zip(mats, rows_per_mat)]
        batch_log_max = max(d.log_n for d, _ in mats) + config.log_blowup
        if not merkle.verify_openings(root, idx >> (log_max - batch_log_max), dims,
                                      rows_per_mat, sibs).all():
            raise PcsError("merkle verification failed for input batch")
        for (dom, pts), rows in zip(mats, rows_per_mat):
            log_h = dom.log_n + config.log_blowup
            x = _lde_points_at(log_h, idx >> (log_max - log_h))  # (Q,)
            w = rows.shape[1]
            rows_ext = ext4.from_base(rows)  # (Q, w, 4)
            for z, ys in pts:
                k0 = apow_count.get(log_h, 0)
                apow_count[log_h] = k0 + w
                diff = ext4.sub(torch.as_tensor(ys, dtype=torch.int32)[None], rows_ext)
                acc = bits.sum_mod(ext4.mul(alpha_pows[k0 : k0 + w][None], diff), dim=1)
                denom = ext4.sub(torch.as_tensor(z, dtype=torch.int32)[None], ext4.from_base(x))
                contrib = ext4.mul(acc, ext4.inv(denom))
                ro[log_h] = contrib if log_h not in ro else ext4.add(ro[log_h], contrib)

    if config.log_blowup in ro:
        raise PcsError("matrix at minimum height not allowed")
    folded = ro.get(log_max)
    if folded is None:
        raise PcsError("no reduced opening at max height")

    gen = f.two_adic_generator_int(log_max)
    x = torch.tensor([pow(gen, _bitrev_int(i, log_max), f.P) for i in indices], dtype=torch.int64)
    for k, beta in enumerate(betas):
        log_folded = log_max - k - 1
        layer_idx = idx >> k
        bit = (layer_idx & 1).bool()
        sib_vals = torch.stack([torch.as_tensor(qp.commit_openings[k].sibling_value, dtype=torch.int32)
                                for qp in qps])
        layer_sibs = torch.stack([torch.as_tensor(qp.commit_openings[k].siblings, dtype=torch.int32)
                                  for qp in qps])
        row = torch.where(bit[:, None], torch.cat([sib_vals, folded], dim=1),
                          torch.cat([folded, sib_vals], dim=1))
        if not merkle.verify_openings(proof.commit_roots[k], layer_idx >> 1,
                                      [(1 << log_folded, 8)], [row], layer_sibs).all():
            raise PcsError(f"merkle verification failed at fold layer {k}")
        e0, e1 = row[:, 0:4], row[:, 4:8]
        x_even = torch.where(bit, (f.P - x) % f.P, x)
        neg2x = (f.P - 2 * x_even % f.P) % f.P
        slope = ext4.mul_base(ext4.sub(e1, e0), f.inv(f.to_monty(neg2x)))
        bm = ext4.sub(beta[None], ext4.from_base(f.to_monty(x_even)))
        folded = ext4.add(e0, ext4.mul(bm, slope))
        nxt = ro.get(log_folded)
        if nxt is not None and log_folded > config.log_blowup:
            folded = ext4.add(folded, ext4.mul(ext4.mul(beta, beta)[None], nxt))
        x = x * x % f.P
    if not torch.equal(folded, torch.as_tensor(proof.final_poly, dtype=torch.int32)[None].expand_as(folded)):
        raise PcsError("final poly mismatch")
    return True

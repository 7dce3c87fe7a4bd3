"""In-DSL shard verifier: a RecursionProgram that verifies a ShardProof.

The analog of the reference's in-circuit STARK verifier
(crates/recursion/circuit/src/stark.rs:213,246 StarkVerifier::verify_shard,
fri.rs:34-363 verify_two_adic_pcs, challenger.rs:62 DuplexChallengerVariable):
the whole host-side ``StarkMachine.verify_shard`` + ``pcs.verify_batches``
pipeline is re-emitted as a straight-line recursion-VM program over hinted
proof values.  Everything data-dependent on the *shape* of the proof (chip
set, log-degrees, widths, FRI layer count) is resolved at build time; only
field values flow through the witness stream, so one compiled program (and
one recursion-machine pk/vk) serves every proof of the same shape — the
reference's per-shape program cache (crates/prover/src/lib.rs:366-438).

Public values of the produced programs: the rec_pv aggregation record
(rec_pv.NUM_REC_PV felts) — the lift program derives it in-circuit from the
verified shard's public values and septic global digest; compress programs
enforce the shard chain rules in-circuit and fold two records (reference
crates/recursion/circuit/src/machine/{core,compress}.rs).
``expected_public_values`` recomputes each record host-side.

``witness`` reads the proofs it is given (the port's ``ShardProof``, whose
tensors may live on the card) once each into a host copy of canonical
Python ints (``host_proof``); the hint extractors read that copy.  The
outer circuit (``snark/outer_circuit``) reads a wrap proof through the same
copy, its BN254 digests kept as Python ints.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from ..ops import field as ff, poseidon2 as p2
from ..stark import air
from ..stark.domain import Domain
from ..stark.machine import ShardProof
from .builder import Builder, Ext, Felt
from .rec_pv import canonical_digest

RATE = 8


def _canon(t) -> list:
    """Montgomery int32 tensor -> nested lists of canonical ints.  A BN254
    digest array of the outer config (numpy, dtype object) holds Fr scalars,
    not KoalaBear values: its Python ints are kept as they are."""
    if isinstance(t, np.ndarray):
        return t.tolist()
    return ff.from_monty(t.cpu()).tolist()


def host_proof(p: ShardProof) -> SimpleNamespace:
    """A ShardProof as the circuits' hints read it: every Montgomery value
    (digests, opened values, FRI openings) canonical, every tensor moved to
    the host once, as nested lists of Python ints."""
    fp = p.fri_proof
    opened = [
        SimpleNamespace(
            preprocessed_local=None if ov.preprocessed_local is None else _canon(ov.preprocessed_local),
            preprocessed_next=None if ov.preprocessed_next is None else _canon(ov.preprocessed_next),
            main_local=_canon(ov.main_local), main_next=_canon(ov.main_next),
            perm_local=_canon(ov.perm_local), perm_next=_canon(ov.perm_next),
            quotient=[_canon(q) for q in ov.quotient],
            local_cumulative_sum=_canon(ov.local_cumulative_sum),
            global_sum=None if ov.global_sum is None else ov.global_sum.cpu().tolist(),
            log_degree=ov.log_degree,
        )
        for ov in p.opened
    ]
    fri = SimpleNamespace(
        commit_roots=[_canon(r) for r in fp.commit_roots],
        final_poly=_canon(fp.final_poly),
        pow_witness=int(fp.pow_witness),
        query_proofs=[
            SimpleNamespace(
                input_openings=[([_canon(r) for r in rows], _canon(sibs))
                                for rows, sibs in qp.input_openings],
                commit_openings=[SimpleNamespace(sibling_value=_canon(co.sibling_value),
                                                 siblings=_canon(co.siblings))
                                 for co in qp.commit_openings],
            )
            for qp in fp.query_proofs
        ],
    )
    return SimpleNamespace(
        main_root=_canon(p.main_root), perm_root=_canon(p.perm_root),
        quotient_root=_canon(p.quotient_root), chip_names=list(p.chip_names),
        opened=opened, fri_proof=fri, public_values=p.public_values.cpu().tolist(),
    )


def _to_host(obj):
    """host_proof of every ShardProof in a witness object (a proof, or a
    tuple/list holding proofs and plain values)."""
    if isinstance(obj, ShardProof):
        return host_proof(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(x) for x in obj)
    return obj


def _ints(t) -> list:
    return [int(x) for x in (t.tolist() if hasattr(t, "tolist") else t)]


# ---------------------------------------------------------------------------
# In-circuit duplex challenger (challenger.rs:62 DuplexChallengerVariable)
# ---------------------------------------------------------------------------


class CircuitChallenger:
    """Mirror of stark.challenger.DuplexChallenger over Felt handles.

    The observe/sample schedule is fully static per proof shape, so the
    circuit reproduces the host transcript exactly (overwrite-absorb,
    sample pops from the end of the refreshed output buffer).
    """

    def __init__(self, b: Builder):
        self.b = b
        zero = b.const_felt(0)
        self.state: list[Felt] = [zero] * 16
        self.input_buffer: list[Felt] = []
        self.output_buffer: list[Felt] = []

    def _duplex(self):
        assert len(self.input_buffer) <= RATE
        st = list(self.state)
        for i, v in enumerate(self.input_buffer):
            st[i] = v
        self.input_buffer.clear()
        self.state = self.b.poseidon2(st)
        self.output_buffer = list(self.state[:RATE])

    def observe(self, felt: Felt):
        self.output_buffer.clear()
        self.input_buffer.append(felt)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_slice(self, felts):
        for v in felts:
            self.observe(v)

    def sample(self) -> Felt:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> Ext:
        return self.b.felts2ext([self.sample() for _ in range(4)])

    def sample_bits(self, nbits: int) -> list:
        """Sampled felt constrained-decomposed; returns the low bits."""
        return self.b.num2bits(self.sample(), 31)[:nbits]

    def check_witness(self, nbits: int, witness: Felt):
        self.observe(witness)
        for bit in self.sample_bits(nbits):
            self.b.assert_zero(bit)


# ---------------------------------------------------------------------------
# In-circuit Poseidon2 hashing / Merkle paths (fri.rs verify_batch)
# ---------------------------------------------------------------------------


def circuit_hash_flat(b: Builder, felts) -> list:
    """PaddingFreeSponge<16,8,8> over a flat felt list (ops/merkle leaf hash)."""
    zero = b.const_felt(0)
    state = [zero] * 16
    for start in range(0, len(felts), RATE):
        chunk = list(felts[start : start + RATE])
        state = chunk + state[len(chunk) :]
        state = b.poseidon2(state)
    return state[:RATE]


def circuit_compress(b: Builder, left, right) -> list:
    return b.poseidon2(list(left) + list(right))[:RATE]


def circuit_merkle_verify(b, digest, index_bits, siblings, root, folds=None):
    """Walk a Merkle path and assert the final digest equals ``root``.

    digest/root: 8-felt lists; index_bits LSB-first (len == len(siblings));
    folds: {level_k: 8-felt digest} folded in after the k-th compression
    (mixed-height MMCS batches, ops/merkle.py verify_opening).
    """
    for k, sib in enumerate(siblings):
        bit = index_bits[k]
        left, right = [], []
        for i in range(RATE):
            l_, r_ = b.select(bit, digest[i], sib[i])
            left.append(l_)
            right.append(r_)
        digest = circuit_compress(b, left, right)
        if folds and (k + 1) in folds:
            digest = circuit_compress(b, digest, folds[k + 1])
    for i in range(RATE):
        b.assert_eq(digest[i], root[i])


# ---------------------------------------------------------------------------
# In-circuit constraint-DAG evaluation at zeta (stark.rs eval_constraints)
# ---------------------------------------------------------------------------


class _ConstraintEval:
    """Walks a chip's symbolic AIR DAG, emitting ExtAlu ops.

    Every node becomes an Ext handle (felt blocks embed as exts with zero
    high coordinates); the binding mirrors StarkMachine._verify_chip_
    constraints' EvalContext in ext mode.
    """

    def __init__(self, b: Builder, opened, selectors, publics, challenges,
                 cum_sum: Ext, global_sum, perm_var_fn):
        self.b = b
        self.opened = opened  # dict segment -> (local handles, next handles)
        self.selectors = selectors
        self.publics = publics
        self.challenges = challenges
        self.cum_sum = cum_sum
        self.global_sum = global_sum
        self.perm_var_fn = perm_var_fn
        self.cache: dict[int, object] = {}

    def eval(self, e):
        k = id(e)
        hit = self.cache.get(k)
        if hit is not None:
            return hit
        b = self.b
        if isinstance(e, air.Const):
            v = b.const_felt(e.value)
        elif isinstance(e, air.Var):
            if e.segment == air.PERM:
                v = self.perm_var_fn(e.col, e.offset)
            else:
                local, nxt = self.opened[e.segment]
                v = (local if e.offset == 0 else nxt)[e.col]
        elif isinstance(e, air.Selector):
            v = self.selectors[e.which]
        elif isinstance(e, air.Public):
            v = self.publics[e.index]
        elif isinstance(e, air.Challenge):
            v = self.challenges[e.index]
        elif isinstance(e, air.CumSumLocal):
            v = self.cum_sum
        elif isinstance(e, air.GlobalSumCoord):
            v = self.global_sum[e.index]
        elif isinstance(e, air.Add):
            v = b.add(self.eval(e.a), self.eval(e.b))
        elif isinstance(e, air.Sub):
            v = b.sub(self.eval(e.a), self.eval(e.b))
        elif isinstance(e, air.Mul):
            v = b.mul(self.eval(e.a), self.eval(e.b))
        elif isinstance(e, air.Neg):
            v = b.sub(b.const_felt(0), self.eval(e.a))
        else:
            raise TypeError(type(e))
        self.cache[k] = v
        return v


# ---------------------------------------------------------------------------
# The shard-verifier circuit
# ---------------------------------------------------------------------------


@dataclass
class _MatInfo:
    domain: Domain
    width: int
    points: list  # list of (z_handle, ys_handles list[Ext])


class _VerifierCircuitBase:
    """Shared machinery: hint plumbing + the single-shard verifier emitter.

    Subclasses call ``_verify_shard`` once (lift) or per child (compress) and
    decide what to commit as public values; ``sel`` maps the top-level
    witness object handed to :meth:`witness` to the ShardProof being
    verified, so one witness stream can carry several proofs.
    """

    def __init__(self, machine):
        self.machine = machine
        self.config = machine.config.fri
        self._spec: list = []  # extractors: witness object -> canonical block
        self._cursel = lambda p: p
        self.b = Builder()

    # -- witness stream ------------------------------------------------------

    def witness(self, proof_obj) -> list:
        host = _to_host(proof_obj)
        return [ex(host) for ex in self._spec]

    # -- hint helpers --------------------------------------------------------

    def _hf(self, extract) -> Felt:
        sel = self._cursel
        self._spec.append(lambda p, e=extract, s=sel: (int(e(s(p))) % ff.P, 0, 0, 0))
        return self.b.hint_felt()

    def _hfs(self, n, extract) -> list:
        """n felts; extract(shard_proof) -> length-n canonical sequence."""
        out = []
        for i in range(n):
            out.append(self._hf(lambda p, e=extract, i=i: e(p)[i]))
        return out

    def _hfs_rows(self, n, extract) -> list:
        """Like _hfs but for Merkle-bound leaf rows — the outer backend uses
        a cheaper range check for these (never transcript-observed)."""
        return self._hfs(n, extract)

    def _hext(self, extract) -> Ext:
        """Ext hint; extract(shard_proof) -> canonical (4,) coords."""
        sel = self._cursel
        self._spec.append(lambda p, e=extract, s=sel: tuple(int(x) for x in e(s(p))))
        return self.b.hint_ext()

    # -- digest/transcript layer (inner KoalaBear-Poseidon2 defaults; the
    #    outer BN254 wrap circuit overrides these, snark/outer_circuit.py —
    #    the reference's StarkVerifier is generic over config the same way,
    #    recursion/circuit/src/stark.rs:213) ------------------------------

    def _new_challenger(self):
        return CircuitChallenger(self.b)

    def _const_root(self, root_arr):
        return [self.b.const_felt(v) for v in canonical_digest(root_arr)]

    def _hint_root(self, extract):
        """Hint one commitment digest; extract(host proof) -> canonical digest."""
        return self._hfs(8, extract)

    def _observe_root(self, ch, digest):
        ch.observe_slice(digest)

    def _leaf_hash(self, felts):
        return circuit_hash_flat(self.b, felts)

    def _compress_digest(self, left, right):
        return circuit_compress(self.b, left, right)

    def _digest_select(self, bit, digest, sib):
        left, right = [], []
        for i in range(RATE):
            l_, r_ = self.b.select(bit, digest[i], sib[i])
            left.append(l_)
            right.append(r_)
        return left, right

    def _assert_digest_eq(self, digest, root):
        for i in range(RATE):
            self.b.assert_eq(digest[i], root[i])

    def _merkle_verify(self, digest, index_bits, siblings, root, folds=None):
        """Walk a Merkle path and assert the final digest equals ``root``;
        folds = {level_k: digest} injected after the k-th compression
        (mixed-height MMCS batches, ops/merkle.py verify_opening)."""
        for k, sib in enumerate(siblings):
            left, right = self._digest_select(index_bits[k], digest, sib)
            digest = self._compress_digest(left, right)
            if folds and (k + 1) in folds:
                digest = self._compress_digest(digest, folds[k + 1])
        self._assert_digest_eq(digest, root)

    # -- the in-circuit shard verifier --------------------------------------

    def _verify_shard(self, vk, tp, sel):
        """Emit a full shard verification; returns (vk_root, pv, global_sum
        handle lists) for the subclass's public-values binding."""
        self._cursel = sel
        b = self.b
        machine, config = self.machine, self.config
        ch = self._new_challenger()
        one_ext = b.const_ext((1, 0, 0, 0))

        chips = [machine.chip_map[n] for n in tp.chip_names]
        opened = tp.opened
        log_degrees = [ov.log_degree for ov in opened]

        # 1. vk observation (constants baked into the program)
        assert vk.prep_root is not None, "verifier circuit requires a preprocessed commitment"
        vk_root = self._const_root(vk.prep_root)
        self._observe_root(ch, vk_root)
        for _name, log_h in vk.prep_heights:
            ch.observe(b.const_felt(log_h))

        # 2. public values
        num_pv = machine.num_public_values
        pv = self._hfs(num_pv, lambda p: p.public_values)
        ch.observe_slice(pv)

        # 3. roots + challenges (transcript order: machine.py verify_shard)
        main_root = self._hint_root(lambda p: p.main_root)
        self._observe_root(ch, main_root)
        perm_challenges = [ch.sample_ext(), ch.sample_ext()]
        perm_chips = [c.perm_width_ext > 0 for c in chips]
        perm_root = None
        if any(perm_chips):
            perm_root = self._hint_root(lambda p: p.perm_root)
            self._observe_root(ch, perm_root)
        cum_exts, global_sums = [], {}
        for i, chip in enumerate(chips):
            if chip.perm_width_ext == 0:
                zero = b.const_felt(0)
                parts = [zero] * 4
            else:
                parts = self._hfs(
                    4, lambda p, i=i: (p.opened[i].local_cumulative_sum)
                )
            ch.observe_slice(parts)
            cum_exts.append(b.felts2ext(parts))
            if chip.commit_scope == air.Scope.Global:
                gs = self._hfs(14, lambda p, i=i: p.opened[i].global_sum)
                ch.observe_slice(gs)
                global_sums[i] = gs
        alpha = ch.sample_ext()
        quotient_root = self._hint_root(lambda p: p.quotient_root)
        self._observe_root(ch, quotient_root)
        zeta = ch.sample_ext()

        # 4. opened values (hint in PCS-round order) + z points
        zw: dict[int, Ext] = {}  # log_n -> zeta * w_{log_n}

        def z_next(log_n: int) -> Ext:
            if log_n not in zw:
                zw[log_n] = b.mul(zeta, b.const_felt(Domain(log_n, 1).gen))
            return zw[log_n]

        rounds: list[tuple[list, list]] = []  # (root_handles, [_MatInfo])
        prep_mats = []
        for name, log_h in vk.prep_heights:
            ci = tp.chip_names.index(name)
            wp = opened[ci].preprocessed_local.shape[0]
            ys_l = [
                self._hext(lambda p, ci=ci, c=c: (p.opened[ci].preprocessed_local[c]))
                for c in range(wp)
            ]
            ys_n = [
                self._hext(lambda p, ci=ci, c=c: (p.opened[ci].preprocessed_next[c]))
                for c in range(wp)
            ]
            prep_mats.append(_MatInfo(Domain(log_h, 1), wp, [(zeta, ys_l), (z_next(log_h), ys_n)]))
        rounds.append((vk_root, prep_mats))

        main_mats, perm_mats, q_mats = [], [], []
        main_opened, perm_opened = [], {}
        for i, chip in enumerate(chips):
            d = Domain(log_degrees[i], 1)
            w = chip.main_width
            ys_l = [
                self._hext(lambda p, i=i, c=c: (p.opened[i].main_local[c]))
                for c in range(w)
            ]
            ys_n = [
                self._hext(lambda p, i=i, c=c: (p.opened[i].main_next[c]))
                for c in range(w)
            ]
            main_opened.append((ys_l, ys_n))
            main_mats.append(_MatInfo(d, w, [(zeta, ys_l), (z_next(d.log_n), ys_n)]))
        for i, chip in enumerate(chips):
            if chip.perm_width_ext == 0:
                continue
            d = Domain(log_degrees[i], 1)
            wflat = 4 * chip.perm_width_ext
            ys_l = [
                self._hext(lambda p, i=i, c=c: (p.opened[i].perm_local[c]))
                for c in range(wflat)
            ]
            ys_n = [
                self._hext(lambda p, i=i, c=c: (p.opened[i].perm_next[c]))
                for c in range(wflat)
            ]
            perm_opened[i] = (ys_l, ys_n)
            perm_mats.append(_MatInfo(d, wflat, [(zeta, ys_l), (z_next(d.log_n), ys_n)]))
        q_opened = []
        for i, chip in enumerate(chips):
            d = Domain(log_degrees[i], 1)
            qdom = d.create_disjoint_domain(d.size << chip.log_quotient_degree)
            chunk_vals = []
            for k, qd in enumerate(qdom.split_domains(chip.quotient_chunks)):
                ys = [
                    self._hext(lambda p, i=i, k=k, c=c: (p.opened[i].quotient[k][c]))
                    for c in range(4)
                ]
                chunk_vals.append(ys)
                q_mats.append(_MatInfo(qd, 4, [(zeta, ys)]))
            q_opened.append(chunk_vals)
        rounds.append((main_root, main_mats))
        if perm_mats:
            rounds.append((perm_root, perm_mats))
        rounds.append((quotient_root, q_mats))

        # 5. FRI verification (pcs.verify_batches mirrored)
        self._verify_pcs(ch, rounds, one_ext)

        # 6. constraint identity per chip
        sels_cache: dict[int, dict] = {}
        mono = [one_ext] + [b.const_ext(tuple(1 if j == c else 0 for j in range(4))) for c in range(1, 4)]
        for i, chip in enumerate(chips):
            d = Domain(log_degrees[i], 1)
            sels, zh = self._selectors(zeta, d, sels_cache)
            prep_handles = None
            if chip.name in dict(vk.prep_heights):
                ci = None
                for mi, (name, _lh) in enumerate(vk.prep_heights):
                    if name == chip.name:
                        ci = mi
                prep_handles = (prep_mats[ci].points[0][1], prep_mats[ci].points[1][1])

            def perm_var(col, off, i=i):
                flat = perm_opened[i][off]
                acc = None
                for c in range(4):
                    term = b.mul(mono[c], flat[4 * col + c]) if c else flat[4 * col]
                    acc = term if acc is None else b.add(acc, term)
                return acc

            ev = _ConstraintEval(
                b,
                {air.MAIN: main_opened[i], air.PREPROCESSED: prep_handles},
                {air.Selector.FIRST: sels["first"], air.Selector.LAST: sels["last"],
                 air.Selector.TRANSITION: sels["transition"]},
                pv, perm_challenges, cum_exts[i], global_sums.get(i),
                perm_var,
            )
            folded = None
            apow = one_ext
            for cexp in chip.constraints:
                term = b.mul(ev.eval(cexp), apow)
                folded = term if folded is None else b.add(folded, term)
                apow = b.mul(apow, alpha)

            # quotient recombination (machine.py _verify_chip_constraints)
            qdom = d.create_disjoint_domain(d.size << chip.log_quotient_degree)
            chunk_doms = qdom.split_domains(chip.quotient_chunks)
            qz = None
            for ci_, cd in enumerate(chunk_doms):
                zp = None
                for j, od in enumerate(chunk_doms):
                    if j == ci_:
                        continue
                    num = self._zp_num(zeta, od)
                    den_inv = ff.inv_int(od.zp_at_point_int(cd.shift))
                    factor = b.mul(num, b.const_felt(den_inv))
                    zp = factor if zp is None else b.mul(zp, factor)
                chunk_val = None
                for c in range(4):
                    term = b.mul(mono[c], q_opened[i][ci_][c]) if c else q_opened[i][ci_][0]
                    chunk_val = term if chunk_val is None else b.add(chunk_val, term)
                term = b.mul(zp, chunk_val) if zp is not None else chunk_val
                qz = term if qz is None else b.add(qz, term)
            b.assert_eq(folded, b.mul(qz, zh))

        # 7. local cumulative sums balance
        total = None
        for ce in cum_exts:
            total = ce if total is None else b.add(total, ce)
        b.assert_zero(total)

        gs_flat = []
        for i in sorted(global_sums):
            gs_flat.extend(global_sums[i])
        return vk_root, pv, gs_flat


    # -- helpers -------------------------------------------------------------

    def _zp_num(self, zeta: Ext, od: Domain) -> Ext:
        """(zeta / shift)^size - 1 via repeated squaring (memoized per zeta
        handle — a multi-proof circuit has one zeta per verified shard)."""
        key = ("zp", id(zeta), od.shift, od.log_n)
        memo = self.b._const_memo
        if key not in memo:
            b = self.b
            us = zeta if od.shift == 1 else b.mul(zeta, b.const_felt(ff.inv_int(od.shift)))
            sq = us
            for _ in range(od.log_n):
                sq = b.mul(sq, sq)
            memo[key] = b.sub(sq, b.const_felt(1))
        return memo[key]

    def _selectors(self, zeta: Ext, d: Domain, cache: dict):
        """is_first/last/transition at zeta for a shift-1 domain + Z_H."""
        if d.log_n not in cache:
            b = self.b
            zh = self._zp_num(zeta, d)
            first_den = b.sub(zeta, b.const_felt(1))
            last_den = b.sub(zeta, b.const_felt(ff.inv_int(d.gen)))
            cache[d.log_n] = (
                {
                    "first": b.div(zh, first_den),
                    "last": b.div(zh, last_den),
                    "transition": last_den,
                },
                zh,
            )
        return cache[d.log_n]

    def _verify_pcs(self, ch: CircuitChallenger, rounds, one_ext: Ext):
        """Mirror of pcs.verify_batches over hinted query openings."""
        b, config = self.b, self.config
        fri_alpha = ch.sample_ext()

        log_max = max(m.domain.log_n for _root, mats in rounds for m in mats) + config.log_blowup
        num_layers = log_max - config.log_blowup

        betas, layer_roots = [], []
        for k in range(num_layers):
            root = self._hint_root(lambda p, k=k: p.fri_proof.commit_roots[k])
            layer_roots.append(root)
            self._observe_root(ch, root)
            betas.append(ch.sample_ext())
        fp_parts = self._hfs(4, lambda p: (p.fri_proof.final_poly))
        ch.observe_slice(fp_parts)
        final_poly = b.felts2ext(fp_parts)
        pow_witness = self._hf(lambda p: p.fri_proof.pow_witness)
        ch.check_witness(config.proof_of_work_bits, pow_witness)

        all_bits = [ch.sample_bits(log_max) for _ in range(config.num_queries)]

        # static alpha-power schedule (one counter per log-height, global
        # across rounds/matrices/points — pcs.py verify_batches order)
        apow_count: dict[int, int] = {}
        schedule: dict[tuple, tuple] = {}
        for ri, (_root, mats) in enumerate(rounds):
            for mi, m in enumerate(mats):
                log_h = m.domain.log_n + config.log_blowup
                for pi in range(len(m.points)):
                    k0 = apow_count.get(log_h, 0)
                    schedule[(ri, mi, pi)] = (log_h, k0)
                    apow_count[log_h] = k0 + m.width
        max_pow = max(apow_count.values(), default=0)
        apows = [one_ext]
        for _ in range(max_pow - 1):
            apows.append(b.mul(apows[-1], fri_alpha))

        beta2 = [b.mul(beta, beta) for beta in betas]
        gen_max = b.const_felt(ff.two_adic_generator_int(log_max))
        g_shift = b.const_felt(ff.GENERATOR)
        neg_two = b.const_felt(ff.P - 2)
        zero_f = b.const_felt(0)

        for q in range(config.num_queries):
            bits = all_bits[q]
            ro: dict[int, Ext] = {}
            x_at: dict[int, Felt] = {}
            for ri, (root, mats) in enumerate(rounds):
                batch_log_max = max(m.domain.log_n for m in mats) + config.log_blowup
                # hint the opened leaf rows for this round
                row_handles = []
                for mi, m in enumerate(mats):
                    row_handles.append(self._hfs_rows(
                        m.width,
                        lambda p, q=q, ri=ri, mi=mi: p.fri_proof.query_proofs[q].input_openings[ri][0][mi],
                    ))
                sibs = [
                    self._hint_root(
                        lambda p, q=q, ri=ri, k=k: p.fri_proof.query_proofs[q].input_openings[ri][1][k]
                    )
                    for k in range(batch_log_max)
                ]
                # mixed-height leaf/fold hashing (ops/merkle.py layout)
                by_height: dict[int, list] = {}
                for m, row in zip(mats, row_handles):
                    h = m.domain.size << config.log_blowup
                    by_height.setdefault(h, []).extend(row)
                max_h = max(by_height)
                digest = self._leaf_hash(by_height[max_h])
                folds = {}
                size = max_h
                for k in range(batch_log_max):
                    size //= 2
                    if size in by_height:
                        folds[k + 1] = self._leaf_hash(by_height[size])
                tree_bits = bits[log_max - batch_log_max :]
                self._merkle_verify(digest, tree_bits, sibs, root, folds)
                # reduced openings
                for mi, m in enumerate(mats):
                    log_h = m.domain.log_n + config.log_blowup
                    if log_h not in x_at:
                        mat_bits = bits[log_max - log_h :]
                        xr = b.exp_reverse_bits(
                            b.const_felt(ff.two_adic_generator_int(log_h)), mat_bits
                        )
                        x_at[log_h] = b.mul(g_shift, xr)
                    x = x_at[log_h]
                    for pi, (z, ys) in enumerate(m.points):
                        _lh, k0 = schedule[(ri, mi, pi)]
                        acc = b.batch_fri(row_handles[mi], ys, apows[k0 : k0 + m.width])
                        contrib = b.div(acc, b.sub(z, x))
                        ro[log_h] = contrib if log_h not in ro else b.add(ro[log_h], contrib)

            # fold chain over the plain subgroup (fri.rs:258-266)
            folded = ro[log_max]
            x = b.exp_reverse_bits(gen_max, bits)
            for k in range(num_layers):
                log_folded = log_max - k - 1
                bit = bits[k]
                sib_parts = self._hfs_rows(4, lambda p, q=q, k=k: (
                    p.fri_proof.query_proofs[q].commit_openings[k].sibling_value
                ))
                folded_parts = b.ext_to_felts(folded)
                row = []
                for i in range(4):
                    l_, r_ = b.select(bit, folded_parts[i], sib_parts[i])
                    row.append((l_, r_))
                left = [lr[0] for lr in row]
                right = [lr[1] for lr in row]
                row8 = left + right
                leaf = self._leaf_hash(row8)
                path = [
                    self._hint_root(
                        lambda p, q=q, k=k, j=j: p.fri_proof.query_proofs[q].commit_openings[k].siblings[j]
                    )
                    for j in range(log_folded)
                ]
                self._merkle_verify(leaf, bits[k + 1 :], path, layer_roots[k])
                e0 = b.felts2ext(left)
                e1 = b.felts2ext(right)
                negx = b.sub(zero_f, x)
                x_even, _ = b.select(bit, x, negx)
                slope = b.div(b.sub(e1, e0), b.mul(neg_two, x_even))
                bm = b.sub(betas[k], x_even)
                folded = b.add(e0, b.mul(bm, slope))
                nxt = ro.get(log_folded)
                if nxt is not None and log_folded > config.log_blowup:
                    folded = b.add(folded, b.mul(beta2[k], nxt))
                x = b.mul(x, x)
            b.assert_eq(folded, final_poly)



# ---------------------------------------------------------------------------
# Septic field / curve gadget (for the in-circuit global-sum aggregation;
# the reference's sum_digest_v2 analog)
# ---------------------------------------------------------------------------


def _sept_binop(b, op, x, y):
    return [op(xi, yi) for xi, yi in zip(x, y)]


def _sept_mul(b, x, y):
    """Septic product of two 7-felt vectors: z^7 = 8 - 2z reduction."""
    c = [None] * 13
    for i in range(7):
        for j in range(7):
            t = b.mul(x[i], y[j])
            c[i + j] = t if c[i + j] is None else b.add(c[i + j], t)
    eight = b.const_felt(8)
    two = b.const_felt(2)
    for k in range(12, 6, -1):
        c[k - 7] = b.add(c[k - 7], b.mul(eight, c[k]))
        c[k - 6] = b.sub(c[k - 6], b.mul(two, c[k]))
    return c[:7]


def _sept_curve_add(circ, p1, p2, inv_extract):
    """In-circuit septic curve addition (x1, y1) + (x2, y2) with the slope
    denominator's inverse hinted from the witness (constrained by
    dx * inv == 1, which also enforces x1 != x2).

    ``inv_extract(witness_obj) -> 7 canonical ints`` supplies
    (x2 - x1)^{-1}; the curve is y^2 = x^3 + 3z x - 3 so the affine
    addition law is the generic chord formula."""
    b = circ.b
    x1, y1 = p1
    x2, y2 = p2
    sub, add = b.sub, b.add
    dx = _sept_binop(b, sub, x2, x1)
    inv = [circ._hf(lambda w, e=inv_extract, i=i: e(w)[i]) for i in range(7)]
    prod = _sept_mul(b, dx, inv)
    b.assert_eq(prod[0], b.const_felt(1))
    for i in range(1, 7):
        b.assert_zero(prod[i])
    m = _sept_mul(b, _sept_binop(b, sub, y2, y1), inv)
    m2 = _sept_mul(b, m, m)
    x3 = _sept_binop(b, sub, _sept_binop(b, sub, m2, x1), x2)
    y3 = _sept_binop(b, sub, _sept_mul(b, m, _sept_binop(b, sub, x1, x3)), y1)
    return x3, y3


def _sum_digest_gadget(circ, dl, dr, base_extract):
    """dl + (dr - START) over 14-felt digest handles (rec_pv.sum_digests).

    ``base_extract(witness_obj) -> (left_digest, right_digest)`` canonical
    28 ints, used to compute the two hinted slope inverses host-side."""
    from ..machine.global_chip import START as _START
    from ..ops import septic as _septic

    b = circ.b
    start_x = [int(c) for c in _START[0]]
    start_y = [int(c) for c in _START[1]]
    neg_start = (
        [b.const_felt(v) for v in start_x],
        [b.const_felt((ff.P - v) % ff.P) for v in start_y],
    )

    def _host_step1(w):
        _dl_v, dr_v = base_extract(w)
        dx = [(start_x[i] - dr_v[i]) % ff.P for i in range(7)]
        return _septic._inv_int7(dx)

    p_r = (dr[:7], dr[7:])
    d = _sept_curve_add(circ, p_r, neg_start, _host_step1)

    def _host_step2(w):
        dl_v, dr_v = base_extract(w)
        pr_ = (list(dr_v[:7]), list(dr_v[7:]))
        ns = (start_x, [(ff.P - v) % ff.P for v in start_y])
        dpt = _septic.curve_add_int(pr_, ns)
        dx = [(dpt[0][i] - dl_v[i]) % ff.P for i in range(7)]
        return _septic._inv_int7(dx)

    p_l = (dl[:7], dl[7:])
    out = _sept_curve_add(circ, p_l, d, _host_step2)
    return list(out[0]) + list(out[1])


class DigestShardVerifierCircuit(_VerifierCircuitBase):
    """Generic single-proof verifier committing

        digest = compress(vk.prep_root, sponge(pv ++ global_sums))

    (the pre-record lift binding, still used to recursively verify
    arbitrary-machine proofs in tests and tools; the production ladder uses
    ShardVerifierCircuit's structured rec_pv record instead)."""

    def __init__(self, machine, vk, template_proof):
        super().__init__(machine)
        self.vk = vk
        vk_root, pv, gs = self._verify_shard(vk, template_proof, lambda p: p)
        payload = circuit_hash_flat(self.b, pv + gs)
        digest = circuit_compress(self.b, vk_root, payload)
        zero = self.b.const_felt(0)
        n = machine.num_public_values
        self.b.commit_public_values((digest + [zero] * n)[:n])
        self.program = self.b.compile()

    def expected_public_values(self, proof) -> list:
        n = self.machine.num_public_values
        return (lift_digest(self.vk, proof) + [0] * n)[:n]


class ShardVerifierCircuit(_VerifierCircuitBase):
    """The "lift" program (machine/core.rs ZKMRecursiveVerifier analog):
    verifies one core-machine ShardProof and commits the full
    rec_pv.NUM_REC_PV aggregation record derived in-circuit from the
    shard's public values and septic global digest (so compress programs
    can enforce the shard chain rules in-circuit and the final proof is
    O(1)).  ``exit_code == 0`` is asserted here (verify.rs:171-180)."""

    def __init__(self, machine, vk, template_proof):
        from ..machine import pv as core_pv
        from . import rec_pv

        super().__init__(machine)
        self.vk = vk
        self.has_cpu = "Cpu" in template_proof.chip_names
        b = self.b
        vk_root, pv, gs = self._verify_shard(vk, template_proof, lambda p: p)
        assert len(gs) == 14, "lift expects exactly one global-scope chip digest"
        b.assert_zero(pv[core_pv.PV_EXIT_CODE])
        zero = b.const_felt(0)
        rec: list = [zero] * rec_pv.NUM_REC_PV

        def put(span, vals):
            lo, hi = span
            assert hi - lo == len(vals)
            rec[lo:hi] = vals

        put(rec_pv.COMMITTED_DIGEST, pv[core_pv.PV_DIGEST : core_pv.PV_DIGEST + 16])
        put(rec_pv.DEFERRED_DIGEST,
            pv[core_pv.PV_DEFERRED_DIGEST : core_pv.PV_DEFERRED_DIGEST + 8])
        put(rec_pv.START_PC, [pv[core_pv.PV_START_PC]])
        put(rec_pv.NEXT_PC, [pv[core_pv.PV_NEXT_PC]])
        put(rec_pv.EXIT_CODE, [pv[core_pv.PV_EXIT_CODE]])
        put(rec_pv.START_SHARD, [pv[core_pv.PV_SHARD]])
        put(rec_pv.NEXT_SHARD, [b.add(pv[core_pv.PV_SHARD], b.const_felt(1))])
        put(rec_pv.START_EXECUTION_SHARD, [pv[core_pv.PV_EXECUTION_SHARD]])
        nxt_ex = (b.add(pv[core_pv.PV_EXECUTION_SHARD], b.const_felt(1))
                  if self.has_cpu else pv[core_pv.PV_EXECUTION_SHARD])
        put(rec_pv.NEXT_EXECUTION_SHARD, [nxt_ex])
        put(rec_pv.CONTAINS_EXECUTION_SHARD, [b.const_felt(1 if self.has_cpu else 0)])
        for span, base in (
            (rec_pv.PREV_INIT_ADDR, core_pv.PV_PREV_INIT_ADDR),
            (rec_pv.LAST_INIT_ADDR, core_pv.PV_LAST_INIT_ADDR),
            (rec_pv.PREV_FINALIZE_ADDR, core_pv.PV_PREV_FINALIZE_ADDR),
            (rec_pv.LAST_FINALIZE_ADDR, core_pv.PV_LAST_FINALIZE_ADDR),
        ):
            put(span, pv[base : base + 2])
        put(rec_pv.CORE_VK_DIGEST, vk_root)
        put(rec_pv.GLOBAL_SUM, gs)
        b.commit_public_values(rec)
        self.program = self.b.compile()

    def expected_public_values(self, proof) -> list:
        from . import rec_pv

        gs = []
        for ov in proof.opened:
            if ov.global_sum is not None:
                gs.extend(_ints(ov.global_sum))
        return rec_pv.lift_record(self.vk, _ints(proof.public_values), gs, self.has_cpu)


def lift_digest_values(vk, pv, gs) -> list:
    """Lift digest from raw (pv, global-sum) values (no proof needed)."""
    payload = p2.hash_canonical(_ints(pv) + _ints(gs))
    return p2.compress_canonical(canonical_digest(vk.prep_root), payload)


def lift_digest(vk, proof) -> list:
    """Host-side recomputation of DigestShardVerifierCircuit's pv digest."""
    gs = []
    for ov in proof.opened:
        if ov.global_sum is not None:
            gs.extend(_ints(ov.global_sum))
    return lift_digest_values(vk, proof.public_values, gs)


def compress_digest(left_pv, right_pv) -> list:
    """Host-side parent digest: compress(left child pv, right child pv)."""
    return p2.compress_canonical(_ints(left_pv), _ints(right_pv))


class ShrinkVerifierCircuit(_VerifierCircuitBase):
    """Pass-through re-proof (prover/src/lib.rs:958 shrink analog): verifies
    one recursion proof and commits the SAME public values, so the digest
    chain survives while the proof is re-proven under a higher-blowup
    (smaller) FRI config by the caller."""

    def __init__(self, machine, vk, template_proof):
        super().__init__(machine)
        self.vk = vk
        _, pv, _ = self._verify_shard(vk, template_proof, lambda p: p)
        self.b.commit_public_values(pv)
        self.program = self.b.compile()

    def expected_public_values(self, proof) -> list:
        return _ints(proof.public_values)


class CompressVerifierCircuit(_VerifierCircuitBase):
    """The "compress" program (machine/compress.rs ZKMCompressVerifier
    analog): verifies TWO recursion-machine proofs whose public values are
    rec_pv records, enforces the shard chain rules IN-CIRCUIT
    (compress.rs:94-480 — pc/shard/execution-shard chaining, digest
    set-once rules, addr-bit chaining, vk-digest consistency), sums the
    septic global digests on the curve, and commits the folded record.
    Child vks are baked as constants: the parent program's identity pins
    the whole sub-tree of programs."""

    def __init__(self, machine, left_vk, right_vk, template_left, template_right):
        from . import rec_pv

        super().__init__(machine)
        b = self.b
        _, pv_l, _ = self._verify_shard(left_vk, template_left, lambda p: p[0])
        _, pv_r, _ = self._verify_shard(right_vk, template_right, lambda p: p[1])
        self._cursel = lambda p: p

        def span_l(span):
            return pv_l[span[0] : span[1]]

        def span_r(span):
            return pv_r[span[0] : span[1]]

        def assert_span_chain(sl, sr):
            for a, c in zip(span_l(sl), span_r(sr)):
                b.assert_eq(a, c)

        # chaining rules
        assert_span_chain(rec_pv.NEXT_PC, rec_pv.START_PC)
        assert_span_chain(rec_pv.NEXT_SHARD, rec_pv.START_SHARD)
        assert_span_chain(rec_pv.CORE_VK_DIGEST, rec_pv.CORE_VK_DIGEST)
        assert_span_chain(rec_pv.LAST_INIT_ADDR, rec_pv.PREV_INIT_ADDR)
        assert_span_chain(rec_pv.LAST_FINALIZE_ADDR, rec_pv.PREV_FINALIZE_ADDR)
        assert_span_chain(rec_pv.END_RECONSTRUCT_DEFERRED,
                          rec_pv.START_RECONSTRUCT_DEFERRED)
        # digest set-once: every nonzero left element pins elementwise
        # equality (compress.rs:330-397)
        for dig in (rec_pv.COMMITTED_DIGEST, rec_pv.DEFERRED_DIGEST):
            lc, rc = span_l(dig), span_r(dig)
            for flag in lc:
                for lj, rj in zip(lc, rc):
                    b.assert_zero(b.mul(flag, b.sub(lj, rj)))
        # execution-shard algebra (linearized; both flags must be boolean)
        one = b.const_felt(1)
        l_has = span_l(rec_pv.CONTAINS_EXECUTION_SHARD)[0]
        r_has = span_r(rec_pv.CONTAINS_EXECUTION_SHARD)[0]
        for h in (l_has, r_has):
            b.assert_zero(b.mul(h, b.sub(one, h)))
        l_start_ex = span_l(rec_pv.START_EXECUTION_SHARD)[0]
        l_next_ex = span_l(rec_pv.NEXT_EXECUTION_SHARD)[0]
        r_start_ex = span_r(rec_pv.START_EXECUTION_SHARD)[0]
        r_next_ex = span_r(rec_pv.NEXT_EXECUTION_SHARD)[0]
        b.assert_zero(b.mul(b.mul(l_has, r_has), b.sub(l_next_ex, r_start_ex)))
        first_seen = b.mul(r_has, b.sub(one, l_has))
        start_ex = b.add(l_start_ex, b.mul(first_seen, b.sub(r_start_ex, l_start_ex)))
        next_ex = b.add(l_next_ex, b.mul(r_has, b.sub(r_next_ex, l_next_ex)))
        contains = b.add(l_has, b.mul(r_has, b.sub(one, l_has)))
        # septic global digest sum
        def _digs(pair):
            from . import rec_pv as rp

            return (
                rp.get([int(x) for x in pair[0].public_values], rp.GLOBAL_SUM),
                rp.get([int(x) for x in pair[1].public_values], rp.GLOBAL_SUM),
            )

        gsum = _sum_digest_gadget(
            self, span_l(rec_pv.GLOBAL_SUM), span_r(rec_pv.GLOBAL_SUM), _digs
        )

        zero = b.const_felt(0)
        rec: list = [zero] * rec_pv.NUM_REC_PV

        def put(span, vals):
            lo, hi = span
            assert hi - lo == len(vals)
            rec[lo:hi] = vals

        put(rec_pv.COMMITTED_DIGEST, span_r(rec_pv.COMMITTED_DIGEST))
        put(rec_pv.DEFERRED_DIGEST, span_r(rec_pv.DEFERRED_DIGEST))
        put(rec_pv.START_PC, span_l(rec_pv.START_PC))
        put(rec_pv.NEXT_PC, span_r(rec_pv.NEXT_PC))
        put(rec_pv.EXIT_CODE, span_r(rec_pv.EXIT_CODE))
        put(rec_pv.START_SHARD, span_l(rec_pv.START_SHARD))
        put(rec_pv.NEXT_SHARD, span_r(rec_pv.NEXT_SHARD))
        put(rec_pv.START_EXECUTION_SHARD, [start_ex])
        put(rec_pv.NEXT_EXECUTION_SHARD, [next_ex])
        put(rec_pv.CONTAINS_EXECUTION_SHARD, [contains])
        put(rec_pv.PREV_INIT_ADDR, span_l(rec_pv.PREV_INIT_ADDR))
        put(rec_pv.LAST_INIT_ADDR, span_r(rec_pv.LAST_INIT_ADDR))
        put(rec_pv.PREV_FINALIZE_ADDR, span_l(rec_pv.PREV_FINALIZE_ADDR))
        put(rec_pv.LAST_FINALIZE_ADDR, span_r(rec_pv.LAST_FINALIZE_ADDR))
        put(rec_pv.START_RECONSTRUCT_DEFERRED, span_l(rec_pv.START_RECONSTRUCT_DEFERRED))
        put(rec_pv.END_RECONSTRUCT_DEFERRED, span_r(rec_pv.END_RECONSTRUCT_DEFERRED))
        put(rec_pv.CORE_VK_DIGEST, span_l(rec_pv.CORE_VK_DIGEST))
        put(rec_pv.GLOBAL_SUM, gsum)
        b.commit_public_values(rec)
        self.program = self.b.compile()

    def expected_public_values(self, pair) -> list:
        from . import rec_pv

        return rec_pv.fold_records(_ints(pair[0].public_values), _ints(pair[1].public_values))


def record_digest(pv) -> list:
    """8-felt Poseidon2 sponge digest of a rec_pv record (canonical ints) —
    the guest-facing commitment a VERIFY_ZKM_PROOF syscall passes as its
    pv_digest argument (the reference guest's `verify_zkm_proof` hashes the
    inner proof's public values the same way)."""
    return p2.hash_canonical(_ints(pv))


def rolling_deferred_digest(prev: list, child_vk_root: list, child_pv: list) -> list:
    """Host-side deferred-digest chain link (machine/deferred.rs:113 analog):

        new = Poseidon2_sponge(prev(8) ++ child_vk_root(8) ++ child_pv(8))

    All values canonical KoalaBear ints.  Protocol note: our compressed
    proofs carry an 8-felt pv digest (the lift/compress digest tree) rather
    than the reference's full flattened PV vector, so the chain binds
    (child program vk root, child compress digest) — which transitively
    authenticates the child's full shard public values including its
    committed-value digest."""
    return p2.hash_canonical(_ints(prev) + _ints(child_vk_root) + _ints(child_pv))


class DeferredVerifierCircuit(_VerifierCircuitBase):
    """Deferred-proof aggregation program (machine/deferred.rs:43 analog):
    verifies ONE compressed recursion proof (a deferred guest proof, vk
    baked as a constant) and commits the rolling deferred-digest chain link

        pv = prev_digest(8) ++ rolling(prev, child_vk_root, child_pv)(8)

    The recursion machine carries 8 public values, so the (prev, new) pair
    is bound as pv = Poseidon2_compress(prev, new): the prover states the
    chain values alongside the proof and the host verifier recomputes the
    compress binding (RecursionProver.verify_deferred), then walks the chain
    matching its head/tail against zeros and the core proof's
    deferred_proofs_digest public values."""

    def __init__(self, machine, child_vk, template_proof):
        super().__init__(machine)
        b = self.b
        vk_root, pv, _ = self._verify_shard(child_vk, template_proof, lambda w: w[0])
        self._cursel = lambda w: w
        prev = self._hfs(8, lambda w: [int(x) for x in w[1]])
        new = circuit_hash_flat(b, prev + vk_root + pv)
        digest = circuit_compress(b, prev, new)
        # the recursion machine's pv record is rec_pv.NUM_REC_PV wide; the
        # deferred chain only uses the first 8 slots (the rest are zero)
        from . import rec_pv

        zero = b.const_felt(0)
        b.commit_public_values(digest + [zero] * (rec_pv.NUM_REC_PV - len(digest)))
        self.program = self.b.compile()
        self.child_vk = child_vk

    def chain_link(self, witness_obj) -> tuple:
        """(prev, new) canonical chain values for a witness."""
        proof, prev = witness_obj
        vk_root = canonical_digest(self.child_vk.prep_root)
        new = rolling_deferred_digest(prev, vk_root, _ints(proof.public_values))
        return [int(x) for x in prev], new

    def expected_public_values(self, witness_obj) -> list:
        from . import rec_pv

        prev, new = self.chain_link(witness_obj)
        digest = compress_digest(prev, new)
        return digest + [0] * (rec_pv.NUM_REC_PV - len(digest))

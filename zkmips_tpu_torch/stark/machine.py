"""StarkMachine: multi-chip shard prover + verifier.

Shard transcript order (identical to the reference's):

  observe(vk: preprocessed root, prep heights)
  observe(public_values)
  observe(main root); sample perm challenges alpha_p, beta_p
  observe(perm root); per chip: observe local cumsum (4 felts),
    and for global-scope chips the 14 septic digest felts
  sample alpha; observe(quotient root); sample zeta
  PCS open/verify (rounds: preprocessed, main, permutation, quotient)

``setup`` and ``prove_shard`` run on a CUDA device unless the caller passes
another (``device="cpu"``); without a GPU they raise.  ``verify_shard`` is
host-side and runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ext4, field as f
from . import air, pcs, permutation, quotient as quotient_mod
from .challenger import DuplexChallenger
from .chip import Chip, pad_to_power_of_two, padded_height
from .domain import Domain
from .pcs import FriConfig


@dataclass
class StarkConfig:
    fri: FriConfig

    @staticmethod
    def core() -> "StarkConfig":
        return StarkConfig(FriConfig.core())

    @staticmethod
    def outer() -> "StarkConfig":
        """The BN254 outer config of the wrap stage."""
        return StarkConfig(FriConfig.outer())

    @staticmethod
    def test() -> "StarkConfig":
        return StarkConfig(FriConfig.test())

    def challenger(self):
        """A fresh transcript for the config's hash family."""
        if self.fri.hash_family == "bn254":
            from .challenger_bn254 import MultiField32Challenger

            return MultiField32Challenger()
        return DuplexChallenger()

    def zero_digest(self):
        """The digest of an empty commitment (the perm root of a shard
        without lookups): eight zero felts, or one zero BN254 scalar (a (1,)
        object array) at the outer config."""
        if self.fri.hash_family == "bn254":
            z = np.empty(1, dtype=object)
            z[0] = 0
            return z
        return torch.zeros(8, dtype=torch.int32)


@dataclass
class VerifyingKey:
    prep_root: torch.Tensor | np.ndarray | None  # (8,) int32, or (1,) object at the outer config
    prep_heights: list  # [(name, log_h)] in committed order

    def observe_into(self, ch: DuplexChallenger):
        if self.prep_root is not None:
            ch.observe_digest(self.prep_root)
        for _name, log_h in self.prep_heights:
            ch.observe(log_h)


@dataclass
class ProvingKey:
    prep_data: pcs.ProverData | None
    prep_traces: dict  # name -> (H, wp) Montgomery int32 on device
    prep_order: list  # chip names in committed (height-desc) order
    vk: VerifyingKey
    device: torch.device

    def to(self, device) -> "ProvingKey":
        """The key on ``device``: every tensor of ``prep_traces`` and
        ``prep_data`` copied there (tensors already there are shared), the
        data's ``persistent`` flag kept, the verifying key shared."""
        device = torch.device(device)
        prep_data = None if self.prep_data is None else self.prep_data.to(device)
        traces = {n: t.to(device) for n, t in self.prep_traces.items()}
        return ProvingKey(prep_data, traces, list(self.prep_order), self.vk, device)


@dataclass
class ChipOpenedValues:
    preprocessed_local: torch.Tensor | None  # (wp, 4) ext
    preprocessed_next: torch.Tensor | None
    main_local: torch.Tensor  # (w, 4)
    main_next: torch.Tensor
    perm_local: torch.Tensor  # (4*W, 4)
    perm_next: torch.Tensor
    quotient: list  # per chunk: (4, 4) ext values of the 4 base columns
    local_cumulative_sum: torch.Tensor  # (4,) ext
    global_sum: torch.Tensor | None  # (14,) canonical, global-scope chips only
    log_degree: int


@dataclass
class ShardProof:
    main_root: torch.Tensor
    perm_root: torch.Tensor
    quotient_root: torch.Tensor
    chip_names: list  # included chips, height-desc order
    opened: list  # ChipOpenedValues, same order
    fri_proof: pcs.FriProof
    public_values: torch.Tensor  # (num_pv,) canonical


class VerificationError(Exception):
    pass


def upload_trace(t: np.ndarray, target: int, device) -> torch.Tensor:
    """Canonical uint32 host trace -> Montgomery int32 on ``device``,
    zero-padded to ``target`` rows (to_monty(0) == 0)."""
    h, w = t.shape
    assert target >= h
    src = torch.from_numpy(np.ascontiguousarray(t, dtype=np.uint32).view(np.int32)).to(device)
    out = torch.zeros((target, w), dtype=torch.int32, device=device)
    out[:h] = f.to_monty(src)
    return out


class StarkMachine:
    def __init__(self, config: StarkConfig, chips: list[Chip], num_public_values: int = 0,
                 shape_config=None):
        self.config = config
        self.chips = chips
        self.num_public_values = num_public_values
        self.chip_map = {c.name: c for c in chips}
        self.shape_config = shape_config  # optional fixed-shape menu

    # ------------------------------------------------------------------ setup

    def setup(self, program, device=None) -> ProvingKey:
        device = resolve_device(device)
        preps = []
        for chip in self.chips:
            t = chip.air.generate_preprocessed(program)
            if t is not None:
                t = np.asarray(t, dtype=np.uint32)
                fixed_rows = None
                if self.shape_config is not None:
                    fixed_rows = self.shape_config.fix_preprocessed_rows(t.shape[0])
                t = pad_to_power_of_two(t, fixed_rows=fixed_rows)
                preps.append((chip.name, upload_trace(t, t.shape[0], device)))
        preps.sort(key=lambda nt: -nt[1].shape[0])
        if preps:
            prep_data = pcs.commit(
                self.config.fri, [(Domain(m.shape[0].bit_length() - 1, 1), m) for _n, m in preps]
            )
            prep_data.persistent = True
            vk = VerifyingKey(prep_data.root, [(n, m.shape[0].bit_length() - 1) for n, m in preps])
        else:
            prep_data, vk = None, VerifyingKey(None, [])
        return ProvingKey(prep_data, dict(preps), [n for n, _ in preps], vk, device)

    # ------------------------------------------------------------------ prove

    def fill_traces(self, chips: list, record) -> dict:
        """{chip name: canonical uint32 main trace} of ``chips`` for
        ``record``, on the host.

        Fills run in a thread pool (numpy and the C helpers release the
        GIL) when there are more than three.  Chips that consume other
        fills' side outputs (the Byte chip reads the byte-lookup arrays every
        ALU fill appends) run after the producers.  The byte-lookup list
        order is thread-dependent but its multiset -- all the Byte chip
        reads -- is not.  Each fill is timed as ``fill.<chip>`` under the
        caller's span path."""
        from ..utils.logger import current_path, span

        parent = current_path()

        def fill(c):
            with span(f"fill.{c.name}", parent=parent):
                return c.name, np.asarray(c.air.generate_trace(record, None), dtype=np.uint32)

        producers = [c for c in chips if not getattr(c.air, "trace_consumes_fills", False)]
        consumers = [c for c in chips if getattr(c.air, "trace_consumes_fills", False)]
        if len(producers) > 3:
            from ..utils.pool import make_pool

            with make_pool(min(8, len(producers))) as tp:
                raw = dict(tp.map(fill, producers))
        else:
            raw = dict(map(fill, producers))
        raw.update(map(fill, consumers))
        return raw

    def prove_shard(self, pk: ProvingKey, record, public_values, device=None) -> ShardProof:
        """Prove one shard; ``record`` is passed opaquely to the chips."""
        from ..utils.logger import note, span

        device = resolve_device(device)
        if device != pk.device:
            raise ValueError(f"proving key lives on {pk.device}, not {device}")
        chips = [c for c in self.chips if c.air.included(record)]
        for name in pk.prep_traces:
            assert self.chip_map[name] in chips, f"preprocessed chip {name} must be included"
        public_values = torch.as_tensor(np.asarray(public_values, dtype=np.uint32).view(np.int32))

        with span("prove.trace_gen"):
            raw = self.fill_traces(chips, record)
            for n, t in raw.items():
                note(f"rows.{n}", t.shape[0])
        with span("prove.upload"):
            shape = None
            if self.shape_config is not None:
                shape = self.shape_config.fix_shape(
                    {n: t.shape[0] for n, t in raw.items()},
                    widths={n: t.shape[1] for n, t in raw.items()},
                )
            traces = {}
            for chip in chips:
                t = raw.pop(chip.name)
                fixed = pk.prep_traces.get(chip.name)
                if fixed is not None:
                    target = fixed.shape[0]
                elif shape is not None and shape.log_h(chip.name) is not None:
                    target = 1 << shape.log_h(chip.name)
                else:
                    target = padded_height(t.shape[0])
                pad_hook = getattr(chip.air, "pad_rows", None)
                if pad_hook is not None:
                    t = pad_hook(t, target)
                traces[chip.name] = upload_trace(t, target, device)
        chips = sorted(chips, key=lambda c: -traces[c.name].shape[0])
        names = [c.name for c in chips]
        log_degrees = {n: traces[n].shape[0].bit_length() - 1 for n in names}

        ch = self.config.challenger()
        pk.vk.observe_into(ch)
        ch.observe_slice(public_values)

        with span("prove.main_commit"):
            main_data = pcs.commit(
                self.config.fri, [(Domain(log_degrees[n], 1), traces[n]) for n in names]
            )
        ch.observe_digest(main_data.root)
        perm_challenges = [ch.sample_ext(), ch.sample_ext()]

        perm_flats, cum_sums = {}, {}
        with span("prove.perm_traces"):
            for chip in chips:
                perm_flats[chip.name], cum_sums[chip.name] = permutation.generate_permutation_trace(
                    chip, pk.prep_traces.get(chip.name), traces[chip.name],
                    perm_challenges[0], perm_challenges[1], chip.batch_size,
                )
        perm_names = [c.name for c in chips if c.perm_width_ext > 0]
        perm_data = None
        if perm_names:
            with span("prove.perm_commit"):
                perm_data = pcs.commit(
                    self.config.fri, [(Domain(log_degrees[n], 1), perm_flats[n]) for n in perm_names]
                )
            ch.observe_digest(perm_data.root)
        global_sums = {}
        for chip in chips:
            ch.observe_slice(ext4.to_canonical(cum_sums[chip.name]))
            if chip.commit_scope == air.Scope.Global:
                gsum = _chip_global_sum(traces[chip.name])
                global_sums[chip.name] = gsum
                ch.observe_slice(gsum)
        alpha = ch.sample_ext()

        publics_monty = f.to_monty(public_values)
        q_doms, q_mats = [], []
        with span("prove.quotient"):
            for chip in chips:
                n = chip.name
                prep_coeffs = None
                if n in pk.prep_order:
                    prep_coeffs = pk.prep_data.coeffs[pk.prep_order.index(n)]
                perm_coeffs = perm_data.coeffs[perm_names.index(n)] if n in perm_names else None
                gs = global_sums.get(n)
                doms, chunks = quotient_mod.quotient_chunks(
                    chip, traces[n], pk.prep_traces.get(n), perm_flats[n], publics_monty,
                    perm_challenges, cum_sums[n], None if gs is None else f.to_monty(gs), alpha,
                    main_coeffs=main_data.coeffs[names.index(n)],
                    prep_coeffs=prep_coeffs, perm_coeffs=perm_coeffs,
                )
                q_doms.extend(doms)
                q_mats.extend(chunks)
        with span("prove.quotient_commit"):
            quotient_data = pcs.commit(self.config.fri, list(zip(q_doms, q_mats)))
        ch.observe_digest(quotient_data.root)
        zeta = ch.sample_ext()

        # the traces, permutation traces and quotient chunks are dead from
        # here on: the open phase reads the committed coefficients and LDEs
        n_q = len(q_mats)
        del traces, perm_flats, q_mats

        with span("prove.open"):
            rounds = []
            if pk.prep_data is not None:
                prep_points = [
                    [zeta, Domain(pk.prep_traces[n].shape[0].bit_length() - 1, 1).next_point_ext(zeta)]
                    for n in pk.prep_order
                ]
                rounds.append((pk.prep_data, prep_points))
            rounds.append((main_data, [[zeta, Domain(log_degrees[n], 1).next_point_ext(zeta)]
                                       for n in names]))
            if perm_data is not None:
                rounds.append((perm_data, [[zeta, Domain(log_degrees[n], 1).next_point_ext(zeta)]
                                           for n in perm_names]))
            rounds.append((quotient_data, [[zeta]] * n_q))
            opened_vals, fri_proof = pcs.open_batches(self.config.fri, rounds, ch)

        ri = 0
        prep_opened = {}
        if pk.prep_data is not None:
            prep_opened = dict(zip(pk.prep_order, opened_vals[ri]))
            ri += 1
        main_opened = opened_vals[ri]
        perm_opened = {}
        if perm_data is not None:
            perm_opened = dict(zip(perm_names, opened_vals[ri + 1]))
            ri += 1
        q_opened = opened_vals[ri + 1]

        opened, qi = [], 0
        empty = torch.zeros((0, 4), dtype=torch.int32)
        for i, chip in enumerate(chips):
            nchunks = chip.quotient_chunks
            qvals = [q_opened[qi + k][0] for k in range(nchunks)]
            qi += nchunks
            po = prep_opened.get(chip.name)
            pe = perm_opened.get(chip.name)
            opened.append(ChipOpenedValues(
                preprocessed_local=None if po is None else po[0],
                preprocessed_next=None if po is None else po[1],
                main_local=main_opened[i][0],
                main_next=main_opened[i][1],
                perm_local=empty if pe is None else pe[0],
                perm_next=empty if pe is None else pe[1],
                quotient=qvals,
                local_cumulative_sum=cum_sums[chip.name],
                global_sum=global_sums.get(chip.name),
                log_degree=log_degrees[chip.name],
            ))

        return ShardProof(
            main_root=main_data.root,
            perm_root=self.config.zero_digest() if perm_data is None else perm_data.root,
            quotient_root=quotient_data.root,
            chip_names=names,
            opened=opened,
            fri_proof=fri_proof,
            public_values=public_values,
        )

    # ----------------------------------------------------------------- verify

    def verify_shard(self, vk: VerifyingKey, proof: ShardProof):
        """Check a shard proof on the host; raises VerificationError."""
        ch = self.config.challenger()
        vk.observe_into(ch)
        if proof.public_values.shape[0] != self.num_public_values:
            raise VerificationError("wrong number of public values")
        ch.observe_slice(proof.public_values)

        chips = []
        for n in proof.chip_names:
            c = self.chip_map.get(n)
            if c is None:
                raise VerificationError(f"unknown chip {n}")
            chips.append(c)
        if len(proof.opened) != len(chips):
            raise VerificationError("wrong number of opened chips")
        for n, _ in vk.prep_heights:
            if n not in proof.chip_names:
                raise VerificationError(f"preprocessed chip {n} missing from shard")

        ch.observe_digest(proof.main_root)
        perm_challenges = [ch.sample_ext(), ch.sample_ext()]
        if any(c.perm_width_ext > 0 for c in chips):
            ch.observe_digest(proof.perm_root)
        for chip, ov in zip(chips, proof.opened):
            if chip.perm_width_ext == 0 and not torch.equal(ov.local_cumulative_sum, ext4.zero()):
                raise VerificationError(f"{chip.name}: nonzero cumsum without lookups")
            ch.observe_slice(ext4.to_canonical(ov.local_cumulative_sum))
            if chip.commit_scope == air.Scope.Global:
                if ov.global_sum is None:
                    raise VerificationError("missing global sum")
                ch.observe_slice(ov.global_sum)
        alpha = ch.sample_ext()
        ch.observe_digest(proof.quotient_root)
        zeta = ch.sample_ext()

        for chip, ov in zip(chips, proof.opened):
            if tuple(ov.main_local.shape) != (chip.main_width, 4):
                raise VerificationError(f"{chip.name}: bad main opening width")
            if tuple(ov.perm_local.shape) != (4 * chip.perm_width_ext, 4):
                raise VerificationError(f"{chip.name}: bad perm opening width")
            if len(ov.quotient) != chip.quotient_chunks:
                raise VerificationError(f"{chip.name}: bad quotient chunk count")

        rounds_info = []
        if vk.prep_root is not None:
            prep_mats = []
            for n, log_h in vk.prep_heights:
                ov = proof.opened[proof.chip_names.index(n)]
                d = Domain(log_h, 1)
                prep_mats.append((d, [(zeta, ov.preprocessed_local),
                                      (d.next_point_ext(zeta), ov.preprocessed_next)]))
            rounds_info.append((vk.prep_root, prep_mats))
        main_mats, perm_mats, q_mats = [], [], []
        for chip, ov in zip(chips, proof.opened):
            d = Domain(ov.log_degree, 1)
            zg = d.next_point_ext(zeta)
            main_mats.append((d, [(zeta, ov.main_local), (zg, ov.main_next)]))
            if chip.perm_width_ext > 0:
                perm_mats.append((d, [(zeta, ov.perm_local), (zg, ov.perm_next)]))
            qdom = d.create_disjoint_domain(d.size << chip.log_quotient_degree)
            for k, qd in enumerate(qdom.split_domains(chip.quotient_chunks)):
                q_mats.append((qd, [(zeta, ov.quotient[k])]))
        rounds_info.append((proof.main_root, main_mats))
        if perm_mats:
            rounds_info.append((proof.perm_root, perm_mats))
        rounds_info.append((proof.quotient_root, q_mats))

        try:
            pcs.verify_batches(self.config.fri, rounds_info, proof.fri_proof, ch)
        except pcs.PcsError as e:
            raise VerificationError(f"pcs: {e}") from e

        publics_monty = f.to_monty(proof.public_values)
        for chip, ov in zip(chips, proof.opened):
            _verify_chip_constraints(chip, ov, zeta, alpha, perm_challenges, publics_monty)

        total = ext4.zero()
        for ov in proof.opened:
            total = ext4.add(total, ov.local_cumulative_sum)
        if not torch.equal(total, ext4.zero()):
            raise VerificationError("local cumulative sums do not balance")
        return True


def _chip_global_sum(trace_monty: torch.Tensor) -> torch.Tensor:
    """The claimed global septic digest: the last row's trailing 14 main
    columns, canonical, on the host."""
    return f.from_monty(trace_monty[-1, -14:]).cpu()


def _ext_from_flat(rows4: torch.Tensor) -> torch.Tensor:
    """The 4 opened ext values of an ext column's 4 base limbs -> its value:
    e(zeta) = sum_c v_c * X^c."""
    out = None
    for c in range(4):
        mono = torch.zeros(4, dtype=torch.int32)
        mono[c] = f.MONTY_ONE
        term = ext4.mul(rows4[c], mono)
        out = term if out is None else ext4.add(out, term)
    return out


def _verify_chip_constraints(chip, ov: ChipOpenedValues, zeta, alpha, perm_challenges, publics_monty):
    d = Domain(ov.log_degree, 1)
    sels = d.selectors_at_point_ext(zeta)

    # the opened values as Python ints: the DAG is evaluated at one point
    main = (ov.main_local.tolist(), ov.main_next.tolist())
    prep = (None, None) if ov.preprocessed_local is None else \
        (ov.preprocessed_local.tolist(), ov.preprocessed_next.tolist())
    perm_cols = ov.perm_local.shape[0] // 4
    perm = tuple([_ext_from_flat(flat[4 * c : 4 * c + 4]).tolist() for c in range(perm_cols)]
                 for flat in (ov.perm_local, ov.perm_next))

    def var_fn(segment, col, offset):
        if segment == air.MAIN:
            return main[offset][col]
        if segment == air.PREPROCESSED:
            return prep[offset][col]
        if segment == air.PERM:
            return perm[offset][col]
        raise ValueError(segment)

    ctx = air.IntEvalContext(
        var_fn,
        selectors={
            air.Selector.FIRST: sels["is_first_row"],
            air.Selector.LAST: sels["is_last_row"],
            air.Selector.TRANSITION: sels["is_transition"],
        },
        publics=publics_monty,
        challenges=perm_challenges,
        cum_sum=ov.local_cumulative_sum,
        global_sum=None if ov.global_sum is None else f.to_monty(ov.global_sum),
    )
    folded = air.fold_constraints(chip.constraints, alpha, ctx)

    # recombine the quotient chunks (uni-stark verifier recombination)
    qdom = d.create_disjoint_domain(d.size << chip.log_quotient_degree)
    chunk_doms = qdom.split_domains(chip.quotient_chunks)
    qz = None
    for i, (cd, vals) in enumerate(zip(chunk_doms, ov.quotient)):
        zp = ext4.one()
        for j, od in enumerate(chunk_doms):
            if j == i:
                continue
            num = od.zp_at_point_ext(zeta)
            den = od.zp_at_point_int(cd.shift)
            zp = ext4.mul(zp, ext4.mul_base(num, f.to_monty_int(f.inv_int(den))))
        term = ext4.mul(zp, _ext_from_flat(vals))
        qz = term if qz is None else ext4.add(qz, term)

    rhs = ext4.mul(qz, d.zp_at_point_ext(zeta))
    if not torch.equal(folded, rhs):
        raise VerificationError(f"{chip.name}: constraint identity failed at zeta")

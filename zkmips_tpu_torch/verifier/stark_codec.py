"""Stable byte encoding for core STARK proofs + the byte-API STARK verifier.

The reference ships a byte-boundary STARK verifier in its standalone
verifier crate (crates/verifier/src/stark/verify.rs:113: proof bytes +
public inputs + vk bytes -> ok/err).  This module is the same boundary for
the port's proofs: a self-describing little-endian u32 wire format (no
pickle, no Python objects) for ``ShardProof``/``VerifyingKey``, plus
``verify_core``, which rebuilds the proof objects and runs the full MIPS
machine verifier (shard STARKs + cross-shard chain rules).

Wire format (all integers little-endian u32 unless noted):

    header:  magic "ZKST" | version | kind (1=core proof list) | config id
    vk:      magic "ZKVK" | version | pc_start | has_prep
             [prep_root u32[dlen]] | n_heights | (name, log_h) ...
    strings: len | utf8 bytes zero-padded to a u32 boundary
    arrays:  ndim | shape... | data (uint32)
    fr256:   0xFFFFFFFF | ndim | shape... | 32-byte LE ints (BN254 digests)
    ext points (4,) and digests (8,) are plain arrays

The port's proofs hold int32 tensors with the bits of the reference's uint32
arrays (Montgomery or canonical, field by field), so the bytes are the
reference's for the same proof.  ``decode_*`` rebuilds the port's dataclasses
with int32 tensors on the CPU, and BN254 digests (the outer config) as
numpy object arrays of Python ints.  The encoding is deterministic:
encode(decode(b)) == b.  The recursion ladder's proofs have their own
kinds: ``encode_compressed_proof`` (a ``CompressedProof`` of any stage:
compress, shrink or the BN254 wrap) and ``encode_deferred_proof``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..stark import pcs
from ..stark.machine import ChipOpenedValues, ShardProof, VerifyingKey

MAGIC_PROOF = b"ZKST"
MAGIC_VK = b"ZKVK"
VERSION = 2
KIND_CORE = 1
_FR256 = 0xFFFF_FFFF  # the array tag of BN254 (outer config) digests


class CodecError(Exception):
    pass


class _W:
    def __init__(self):
        self.parts: list[bytes] = []

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", int(v)))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", int(v)))

    def raw(self, b: bytes):
        self.parts.append(b)

    def s(self, name: str):
        b = name.encode()
        self.u32(len(b))
        pad = -len(b) % 4
        self.raw(b + b"\x00" * pad)

    def arr(self, t):
        if isinstance(t, np.ndarray) and t.dtype == object:
            self.u32(_FR256)
            self.u32(t.ndim)
            for d in t.shape:
                self.u32(d)
            for v in t.reshape(-1):
                self.raw(int(v).to_bytes(32, "little"))
            return
        a = np.ascontiguousarray(t.detach().cpu().to(torch.int32).numpy()).view(np.uint32)
        self.u32(a.ndim)
        for d in a.shape:
            self.u32(d)
        self.raw(a.tobytes())

    def opt_arr(self, t):
        if t is None:
            self.u32(0)
        else:
            self.u32(1)
            self.arr(t)

    def bytes_(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, b: bytes):
        self.b = b
        self.off = 0

    def u32(self) -> int:
        return int.from_bytes(self.raw(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.raw(8), "little")

    def raw(self, n: int) -> bytes:
        if self.off + n > len(self.b):
            raise CodecError("truncated proof bytes")
        v = self.b[self.off : self.off + n]
        self.off += n
        return v

    def s(self) -> str:
        n = self.u32()
        pad = -n % 4
        try:
            return self.raw(n + pad)[:n].decode()
        except UnicodeDecodeError as e:
            raise CodecError(f"invalid utf-8 string: {e}") from e

    def arr(self):
        ndim = self.u32()
        is_fr = ndim == _FR256
        if is_fr:
            ndim = self.u32()
        if ndim > 4:
            raise CodecError("bad array rank")
        shape = tuple(self.u32() for _ in range(ndim))
        count = int(np.prod(shape)) if shape else 1
        if count > (1 << 28):
            raise CodecError("array too large")
        if is_fr:
            out = np.empty(count, dtype=object)
            for i in range(count):
                out[i] = int.from_bytes(self.raw(32), "little")
            return out.reshape(shape)
        data = np.frombuffer(self.raw(4 * count), dtype=np.int32).reshape(shape)
        return torch.from_numpy(data.copy())

    def opt_arr(self):
        return self.arr() if self.u32() else None


# ---------------------------------------------------------------------------
# verifying key
# ---------------------------------------------------------------------------


def encode_vk(vk: VerifyingKey, pc_start: int) -> bytes:
    w = _W()
    w.raw(MAGIC_VK)
    w.u32(VERSION)
    w.u32(pc_start)
    w.opt_arr(vk.prep_root)
    w.u32(len(vk.prep_heights))
    for name, log_h in vk.prep_heights:
        w.s(name)
        w.u32(log_h)
    return w.bytes_()


def decode_vk(b: bytes):
    """-> (VerifyingKey, pc_start)."""
    r = _R(b)
    if r.raw(4) != MAGIC_VK or r.u32() != VERSION:
        raise CodecError("bad vk header")
    pc_start = r.u32()
    prep_root = r.opt_arr()
    n = r.u32()
    heights = [(r.s(), r.u32()) for _ in range(n)]
    return VerifyingKey(prep_root, heights), pc_start


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------


def _enc_opened(w: _W, ov: ChipOpenedValues):
    w.u32(ov.log_degree)
    w.opt_arr(ov.preprocessed_local)
    w.opt_arr(ov.preprocessed_next)
    w.arr(ov.main_local)
    w.arr(ov.main_next)
    w.arr(ov.perm_local)
    w.arr(ov.perm_next)
    w.u32(len(ov.quotient))
    for q in ov.quotient:
        w.arr(q)
    w.arr(ov.local_cumulative_sum)
    w.opt_arr(ov.global_sum)


def _dec_opened(r: _R) -> ChipOpenedValues:
    log_degree = r.u32()
    p_l, p_n = r.opt_arr(), r.opt_arr()
    m_l, m_n = r.arr(), r.arr()
    e_l, e_n = r.arr(), r.arr()
    quotient = [r.arr() for _ in range(r.u32())]
    cum = r.arr()
    gs = r.opt_arr()
    return ChipOpenedValues(p_l, p_n, m_l, m_n, e_l, e_n, quotient, cum, gs, log_degree)


def _enc_fri(w: _W, fp: pcs.FriProof):
    w.u32(len(fp.commit_roots))
    for root in fp.commit_roots:
        w.arr(root)
    w.arr(fp.final_poly)
    w.u64(fp.pow_witness)
    w.u32(len(fp.query_proofs))
    for qp in fp.query_proofs:
        w.u32(len(qp.input_openings))
        for rows, sibs in qp.input_openings:
            w.u32(len(rows))
            for row in rows:
                w.arr(row)
            w.arr(sibs)
        w.u32(len(qp.commit_openings))
        for co in qp.commit_openings:
            w.arr(co.sibling_value)
            w.arr(co.siblings)


def _dec_fri(r: _R) -> pcs.FriProof:
    roots = [r.arr() for _ in range(r.u32())]
    final_poly = r.arr()
    pow_witness = r.u64()
    queries = []
    for _ in range(r.u32()):
        input_openings = []
        for _ in range(r.u32()):
            rows = [r.arr() for _ in range(r.u32())]
            sibs = r.arr()
            input_openings.append((rows, sibs))
        commit_openings = [
            pcs.CommitPhaseOpening(r.arr(), r.arr()) for _ in range(r.u32())
        ]
        queries.append(pcs.QueryProof(input_openings, commit_openings))
    return pcs.FriProof(roots, final_poly, pow_witness, queries)


def _enc_shard(w: _W, p: ShardProof):
    w.arr(p.main_root)
    w.arr(p.perm_root)
    w.arr(p.quotient_root)
    w.u32(len(p.chip_names))
    for n in p.chip_names:
        w.s(n)
    for ov in p.opened:
        _enc_opened(w, ov)
    _enc_fri(w, p.fri_proof)
    w.arr(p.public_values)


def _dec_shard(r: _R) -> ShardProof:
    main_root, perm_root, q_root = r.arr(), r.arr(), r.arr()
    names = [r.s() for _ in range(r.u32())]
    opened = [_dec_opened(r) for _ in names]
    fri = _dec_fri(r)
    pv = r.arr()
    return ShardProof(main_root, perm_root, q_root, names, opened, fri, pv)


CONFIG_IDS = {"core": 1, "test": 2}


def encode_core_proof(proofs: list, config: str = "core") -> bytes:
    """Serialize a list of core shard proofs (the ZKMCoreProofData analog).

    ``config`` names the FRI parameter set the proofs were generated under
    ("core" = the sound production parameters); the tag is part of the wire
    format so the verifier rebuilds the exact configuration.
    """
    w = _W()
    w.raw(MAGIC_PROOF)
    w.u32(VERSION)
    w.u32(KIND_CORE)
    w.u32(CONFIG_IDS[config])
    w.u32(len(proofs))
    for p in proofs:
        _enc_shard(w, p)
    return w.bytes_()


def decode_core_proof(b: bytes) -> tuple:
    """-> (proofs, config_name)."""
    r = _R(b)
    if r.raw(4) != MAGIC_PROOF or r.u32() != VERSION:
        raise CodecError("bad proof header")
    if r.u32() != KIND_CORE:
        raise CodecError("not a core proof")
    cfg_id = r.u32()
    names = {v: k for k, v in CONFIG_IDS.items()}
    if cfg_id not in names:
        raise CodecError("unknown config id")
    n = r.u32()
    if n > (1 << 16):
        raise CodecError("too many shards")
    proofs = [_dec_shard(r) for _ in range(n)]
    if r.off != len(b):
        raise CodecError("trailing bytes")
    return proofs, names[cfg_id]


# ---------------------------------------------------------------------------
# byte-API verifier (verifier/src/stark/verify.rs analog)
# ---------------------------------------------------------------------------


def verify_core(proof_bytes: bytes, vk_bytes: bytes,
                expected_pv_stream: bytes | None = None,
                allowed_configs: tuple = ("core",)) -> bool:
    """Verify serialized core shard proofs against a serialized vk.

    Rebuilds the full MIPS machine, runs every shard STARK plus the
    cross-shard chain rules (on the host), and optionally checks that the
    committed-value digest equals sha256(expected_pv_stream) -- the
    reference byte API's public-inputs binding.

    The FRI config named in the (attacker-controlled) proof bytes must be in
    ``allowed_configs``: by default only the sound production config is
    accepted, as the reference's standalone verifier pins its config
    (crates/verifier/src/stark/verify.rs).  Tests may pass
    ``allowed_configs=("core", "test")`` to accept the small unsound config.
    """
    import hashlib

    from ..machine.machine import MipsMachine
    from ..machine.pv import PV_DIGEST
    from ..stark.machine import StarkConfig, VerificationError

    vk, pc_start = decode_vk(vk_bytes)
    proofs, config = decode_core_proof(proof_bytes)
    if config not in allowed_configs:
        raise VerificationError(
            f"proof config {config!r} not in allowed_configs {allowed_configs}"
        )
    m = MipsMachine(StarkConfig.test() if config == "test" else StarkConfig.core())

    class _Prog:
        pass

    prog = _Prog()
    prog.pc_start = pc_start
    m.verify(vk, proofs, prog)
    if expected_pv_stream is not None:
        digest = hashlib.sha256(expected_pv_stream).digest()
        words = [int.from_bytes(digest[4 * i : 4 * i + 4], "little") for i in range(8)]
        pv = [int(x) for x in proofs[-1].public_values.tolist()]
        got = [
            pv[PV_DIGEST + 2 * i] | (pv[PV_DIGEST + 2 * i + 1] << 16) for i in range(8)
        ]
        if got != words:
            raise VerificationError("committed digest does not match public values")
    return True


# ---------------------------------------------------------------------------
# recursion-ladder proofs (compressed / deferred); the reference bincodes
# these (crates/stark/src/types.rs:37-129), the same stable-bytes goal here
# ---------------------------------------------------------------------------

KIND_COMPRESSED = 2
KIND_DEFERRED = 3

_STAGE_IDS = {"compress": 1, "shrink": 2, "wrap": 3}


def _enc_root_tuple(w: _W, root: tuple):
    w.u32(len(root))
    for v in root:
        w.raw(int(v).to_bytes(32, "little"))


def _dec_root_tuple(r: _R) -> tuple:
    n = r.u32()
    if n > 8:
        raise CodecError("bad vk root length")
    return tuple(int.from_bytes(r.raw(32), "little") for _ in range(n))


def _dec_header(r: _R, kind: int, what: str) -> str:
    if r.raw(4) != MAGIC_PROOF or r.u32() != VERSION:
        raise CodecError("bad proof header")
    if r.u32() != kind:
        raise CodecError(f"not a {what} proof")
    names = {v: k for k, v in CONFIG_IDS.items()}
    cfg_id = r.u32()
    if cfg_id not in names:
        raise CodecError("unknown config id")
    return names[cfg_id]


def encode_compressed_proof(cp, config: str = "core") -> bytes:
    """Serialize a CompressedProof (any stage: compress, shrink or wrap)."""
    w = _W()
    w.raw(MAGIC_PROOF)
    w.u32(VERSION)
    w.u32(KIND_COMPRESSED)
    w.u32(CONFIG_IDS[config])
    w.u32(_STAGE_IDS[cp.stage])
    w.u32(cp.num_shards)
    _enc_root_tuple(w, cp.final_vk_root)
    _enc_shard(w, cp.proof)
    return w.bytes_()


def decode_compressed_proof(b: bytes):
    """-> (CompressedProof, config_name)."""
    from ..recursion.compress import CompressedProof

    r = _R(b)
    config = _dec_header(r, KIND_COMPRESSED, "compressed")
    stages = {v: k for k, v in _STAGE_IDS.items()}
    stage_id = r.u32()
    if stage_id not in stages:
        raise CodecError("unknown stage id")
    num_shards = r.u32()
    root = _dec_root_tuple(r)
    proof = _dec_shard(r)
    if r.off != len(b):
        raise CodecError("trailing bytes")
    return CompressedProof(proof, root, num_shards, stages[stage_id]), config


def encode_deferred_proof(dp, config: str = "core") -> bytes:
    """Serialize a DeferredProof chain link."""
    w = _W()
    w.raw(MAGIC_PROOF)
    w.u32(VERSION)
    w.u32(KIND_DEFERRED)
    w.u32(CONFIG_IDS[config])
    _enc_root_tuple(w, dp.final_vk_root)
    _enc_root_tuple(w, dp.child_vk_root)
    w.arr(torch.tensor(dp.prev_digest, dtype=torch.int32))
    w.arr(torch.tensor(dp.new_digest, dtype=torch.int32))
    _enc_shard(w, dp.proof)
    return w.bytes_()


def decode_deferred_proof(b: bytes):
    """-> (DeferredProof, config_name)."""
    from ..recursion.compress import DeferredProof

    r = _R(b)
    config = _dec_header(r, KIND_DEFERRED, "deferred")
    final_root = _dec_root_tuple(r)
    child_root = _dec_root_tuple(r)
    prev = [int(x) for x in r.arr().tolist()]
    new = [int(x) for x in r.arr().tolist()]
    proof = _dec_shard(r)
    if r.off != len(b):
        raise CodecError("trailing bytes")
    return DeferredProof(proof, final_root, child_root, prev, new), config

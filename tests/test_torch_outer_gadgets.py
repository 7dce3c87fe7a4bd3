"""The port's KoalaBear-in-Fr gadgets (``snark/gadgets.py``) against the
reference's: each case of the reference's ``tests/test_outer_gadgets.py``
is built by both packages from the same seeded values, and the two
constraint systems must be equal in full (every constraint, every witness
value: tolerance 0), satisfied, and agree with the host implementations
(``ops/bn254``, ``stark/challenger_bn254``)."""

import random

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import bn254 as jbn254
from zkmips_tpu.snark import gadgets as jg, r1cs as jr1cs
from zkmips_tpu.stark.challenger_bn254 import MultiField32Challenger as JChallenger

from zkmips_tpu_torch.ops import bn254, field as ff
from zkmips_tpu_torch.snark import gadgets as g, r1cs
from zkmips_tpu_torch.stark.challenger_bn254 import MultiField32Challenger

P = ff.P
PORT = (g, r1cs, bn254, MultiField32Challenger)
REFERENCE = (jg, jr1cs, jbn254, JChallenger)


def _permute3(gm, b, bn, _ch):
    vals = [random.randrange(gm.R) for _ in range(3)]
    out = gm.permute3_gadget(b.fr, [b.fr.witness(v, gm.R - 1) for v in vals])
    assert [o.value % gm.R for o in out] == bn.permute3(vals)


def _split_32(gm, b, bn, _ch):
    for v in [0, 1, gm.R - 1, random.randrange(gm.R)]:
        felts = gm.split_32_gadget(b, b.fr.witness(v, gm.R - 1), 3)
        assert [f.canonical for f in felts] == bn.split_32(v, 3)


def _kb_arithmetic(gm, b, _bn, _ch):
    xs = [b.hint_felt(random.randrange(P)) for _ in range(8)]
    acc, want = xs[0], xs[0].canonical
    for i in range(1, 8):
        acc = b.mul(b.add(acc, xs[i]), b.sub(acc, xs[i]))
        w = xs[i].canonical
        want = (want + w) * (want - w) % P
    assert acc.canonical == want % P
    d = b.div(xs[1], xs[2])
    assert d.canonical * xs[2].canonical % P == xs[1].canonical


def _ext_mul_div(gm, b, _bn, _ch):
    e1 = b.hint_ext([random.randrange(P) for _ in range(4)])
    e2 = b.hint_ext([random.randrange(P) for _ in range(4)])
    b.assert_eq(b.div(b.mul(e1, e2), e2), e1)


def _exp_reverse_bits(gm, b, _bn, _ch):
    bits_v = [1, 0, 1, 1]
    out = b.exp_reverse_bits(b.hint_felt(12345), [b.num2bits(b.hint_felt(v), 1)[0] for v in bits_v])
    assert out.canonical == pow(12345, 0b1011, P)
    sel = b.select(b.num2bits(b.hint_felt(1), 1)[0], b.hint_felt(3), b.hint_felt(9))
    assert [x.canonical for x in sel] == [9, 3]
    fri = b.batch_fri([b.hint_ext([1, 2, 3, 4])], [b.hint_ext([5, 6, 7, 8])], [b.const_ext((2, 0, 0, 0))])
    assert fri.canonical == (8, 8, 8, 8)


def _challenger(gm, b, _bn, host_cls):
    ch_c, ch_h = gm.OuterCircuitChallenger(b), host_cls()
    seq = [random.randrange(P) for _ in range(17)]
    ch_c.observe_slice([b.hint_felt(v) for v in seq])
    ch_h.observe_slice(seq)
    for _ in range(5):
        assert ch_c.sample().canonical == int(ch_h.sample())
    dig = random.randrange(gm.R)
    ch_c.observe_digest(b.fr.witness(dig, gm.R - 1))
    ch_h.observe_digest(np.array([dig], dtype=object))
    bits = ch_c.sample_bits(18)
    assert sum(int(bit.fr.value) << i for i, bit in enumerate(bits)) == int(ch_h.sample_bits(18))
    w = int(ch_h.clone().grind(4))
    ch_c.check_witness(4, b.hint_felt(w))
    ch_h.check_witness(4, w)
    assert ch_c.sample().canonical == int(ch_h.sample())
    ch_c.sample_ext()


def _hash_compress(gm, b, bn, _ch):
    row = [random.randrange(P) for _ in range(24)]
    assert gm.hash_felts_gadget(b, [b.hint_felt(v) for v in row]).value % gm.R == bn.hash_felts(row)
    assert gm.compress_gadget(b, b.fr.const(5), b.fr.const(7)).value % gm.R == bn.compress(5, 7)


def _canonical_fr_bits(gm, b, _bn, _ch):
    v = gm.R - 1
    fr = b.fr.witness(v, gm.R - 1)
    b.fr.assert_bits_canonical_fr(b.fr.bits_of(gm.FrVal(fr.lc, v, gm.R - 1), 254))


CASES = {
    "permute3": _permute3,
    "split_32": _split_32,
    "kb_arithmetic": _kb_arithmetic,
    "ext_mul_div": _ext_mul_div,
    "exp_reverse_bits_select_batch_fri": _exp_reverse_bits,
    "challenger": _challenger,
    "hash_compress": _hash_compress,
    "canonical_fr_bits": _canonical_fr_bits,
}


def build(case: str, package):
    gm, rm, bn, ch = package
    random.seed(1234)
    cs = rm.ConstraintSystem()
    CASES[case](gm, gm.OuterBuilder(cs), bn, ch)
    return cs


@pytest.mark.parametrize("case", list(CASES))
def test_gadget_systems_equal_the_reference(case):
    cs, jcs = build(case, PORT), build(case, REFERENCE)
    assert cs.is_satisfied()
    assert cs.num_public == jcs.num_public
    assert cs.values == jcs.values
    assert cs.constraints == jcs.constraints


def test_tampered_hint_breaks_satisfaction():
    cs = r1cs.ConstraintSystem()
    x = g.OuterBuilder(cs).hint_felt(5)
    cs.values[max(x.fr.lc)] = P + 5
    assert not cs.is_satisfied()


def test_non_canonical_fr_bits_refused():
    """The 254-bit pattern of R itself holds mod R but is not canonical."""
    cs = r1cs.ConstraintSystem()
    b = g.OuterBuilder(cs)
    fr2 = b.fr.witness(0, g.R - 1)
    bad_bits = []
    for i in range(254):
        bit = (g.R >> i) & 1
        bv = cs.witness(bit)
        cs.enforce(bv, {bv.idx: 1, 0: g.R - 1}, 0)
        bad_bits.append(g.FrVal({bv.idx: 1}, bit, 1))
    b.fr.assert_eq(b.fr.linear([(1 << i, bb) for i, bb in enumerate(bad_bits)]), fr2)
    with pytest.raises(AssertionError):
        b.fr.assert_bits_canonical_fr(bad_bits)


@pytest.mark.gpu
def test_gadgets_hash_a_card_row():
    """Values read back from a card tensor hash in the circuit as the host
    sponge hashes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    row = torch.arange(1, 25, dtype=torch.int32, device="cuda") * 99991 % P
    vals = row.cpu().tolist()
    cs = r1cs.ConstraintSystem()
    b = g.OuterBuilder(cs)
    assert g.hash_felts_gadget(b, [b.hint_felt(v) for v in vals]).value % g.R == bn254.hash_felts(vals)
    assert cs.is_satisfied()

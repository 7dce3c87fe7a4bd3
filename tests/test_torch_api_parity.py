"""The port keeps the reference's public names, and the reference's user
programs have counterparts in the port.

For every module that both ``zkmips_tpu`` and ``zkmips_tpu_torch`` have,
both files are parsed with ``ast`` (nothing is imported): each public
top-level and class-level name the reference defines (functions, classes,
methods, constants) must be bound in the port's module (defined or
imported), or stand in ``NOT_CARRIED`` with the reason it is not.  Every
program of ``examples/`` and ``scripts/sound_ladder.py`` must have a module
of the same name under ``zkmips_tpu_torch/examples/``.  The helpers the
port gained to close the gap are held equal to the reference's on inputs
made from a seed with numpy, at tolerance 0.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import bits as jbits, ext4 as jext4, field as jf, merkle as jmerkle, merkle_bn254 as jmbn
from zkmips_tpu.ops import ntt as jntt, poseidon2 as jp2
from zkmips_tpu.snark import native as jnative
from zkmips_tpu.stark import chip as jchip, domain as jdomain, pcs as jpcs, quotient as jquotient

from zkmips_tpu_torch.ops import bits, ext4, field as f, merkle, merkle_bn254 as mbn, ntt, poseidon2 as p2
from zkmips_tpu_torch.snark import native
from zkmips_tpu_torch.stark import chip, domain, pcs, quotient

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "zkmips_tpu", ROOT / "zkmips_tpu_torch"
P = 0x7F000001

# What the port deliberately does not carry: a module of the reference (its
# path under the package) or one of its names ("path:Name" or
# "path:Class.name"), each with the reason.
NOT_CARRIED = {
    "ops/pallas_p2.py": "the two Pallas kernels; the port's are written by hand in CUDA "
                        "(csrc/poseidon2.cu, bound by ops/poseidon2_cuda.py)",
    "stark/blocks.py": "XLA jit keying and row blocking of the stage kernels; the port computes "
                       "the same values in torch (stark/permutation.py, quotient.py, pcs.py)",
    "stark/jit_util.py": "the cache of XLA compiles; torch compiles nothing",
    "ops/field.py:xp_of": "numpy / jax.numpy dispatch; the port's field functions take tensors "
                          "and numpy arrays alike",
    "recursion/native_runtime.py:available": "a probe for the Python fallback; the port's C "
                                             "runtime raises when it does not build",
    "snark/native.py:available": "a probe for the pure-Python fallback; the port's bn254.c binding "
                                 "raises when it does not build",
    "stark/pcs.py:ProverData.drop_ldes": "frees the LDEs during the quotient on a 16 GiB TPU; the "
                                         "port's widest shard peaks at 32.41 GiB of the card's 80, "
                                         "and it releases traces before the open phase",
    "stark/pcs.py:ProverData.ensure_ldes": "the other half of drop_ldes",
    "stark/machine.py:DEVICE_MIN_ROWS": "routes small chips to the host to spare XLA compiles; the "
                                        "port has no compile and routes nothing by height",
}


def _bound(body, imports: bool) -> set:
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                out |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.If, ast.Try)):
            for block in [node.body, node.orelse, getattr(node, "finalbody", [])] + \
                    [h.body for h in getattr(node, "handlers", [])]:
                out |= _bound(block, imports)
    return out


def public_names(path: Path, imports: bool) -> set:
    """Public top-level names and ``Class.name`` members; a module's imports
    count only where ``imports`` (the port may re-export a name)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = {n for n in _bound(tree.body, imports) if not n.startswith("_")}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out |= {f"{node.name}.{n}" for n in _bound(node.body, imports) if not n.startswith("_")}
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
SHARED = [m for m in REF_MODULES if (PORT / m).exists()]


def test_every_reference_module_is_ported_or_not_carried():
    missing = [m for m in REF_MODULES if not (PORT / m).exists() and m not in NOT_CARRIED]
    assert missing == []
    assert len(SHARED) > 100


@pytest.mark.parametrize("module", SHARED)
def test_public_names_of_the_reference_are_in_the_port(module):
    missing = sorted(public_names(REF / module, False) - public_names(PORT / module, True))
    assert [n for n in missing if f"{module}:{n}" not in NOT_CARRIED] == []


def test_not_carried_lists_only_what_the_port_lacks():
    """Each entry names a module or name of the reference that the port does
    not have, and gives a reason: the list cannot go stale."""
    for key, reason in NOT_CARRIED.items():
        assert len(reason) > 20, key
        module, _, name = key.partition(":")
        assert (REF / module).exists(), key
        if name:
            assert name in public_names(REF / module, False), key
            assert name not in public_names(PORT / module, True), key
        else:
            assert not (PORT / module).exists(), key


PROGRAMS = sorted(p.stem for p in (ROOT / "examples").glob("*.py") if p.name != "_common.py") + ["sound_ladder"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_every_program_has_a_counterpart_in_the_port(name):
    assert len(PROGRAMS) == 17
    path = PORT / "examples" / f"{name}.py"
    assert path.exists()
    assert "main" in public_names(path, False)


# --- the helpers, each against the reference's on seeded inputs (tolerance 0) -------

def _rng(seed: int):
    return np.random.default_rng(seed)


def _monty(rng, shape) -> np.ndarray:
    return jf.to_monty(rng.integers(0, P, size=shape, dtype=np.uint32))


def _ext(rng) -> np.ndarray:
    return _monty(rng, (4,))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _np(t) -> np.ndarray:
    return t.numpy().view(np.uint32) if isinstance(t, torch.Tensor) else np.asarray(t)


def _field_constants():
    assert (f.MONTY_BITS, f.ZERO, f.NEG_ONE) == (jf.MONTY_BITS, int(jf.ZERO), int(jf.NEG_ONE))
    assert p2.ROUNDS_F == jp2.ROUNDS_F


def _exp_int():
    rng = _rng(1)
    for base, e in zip(rng.integers(0, P, 8).tolist(), rng.integers(0, 1 << 40, 8).tolist()):
        assert f.exp_int(base, e) == jf.exp_int(base, e)


def _from_u32():
    x = _rng(2).integers(0, P, size=64, dtype=np.uint32)
    assert np.array_equal(f.from_u32(x), jf.from_u32(x))
    assert np.array_equal(_np(f.from_u32(_t(x))), jf.from_u32(x))


def _ext4_constants_and_neg():
    a = _monty(_rng(3), (16, 4))
    assert ext4.D == jext4.D
    assert np.array_equal(_np(ext4.ONE), jext4.ONE) and np.array_equal(_np(ext4.ZERO), jext4.ZERO)
    assert np.array_equal(_np(ext4.neg(_t(a))), jext4.neg(a))
    assert np.array_equal(_np(ext4.zeros_like(_t(a))), jext4.zeros_like(a))


def _powers_host():
    base = _ext(_rng(4))
    assert np.array_equal(_np(ext4.powers_host(_t(base), 37)), jext4.powers_host(base, 37))


def _powers_np():
    for base, n in ((7, 1), (int(_rng(5).integers(0, P)), 1000)):
        assert np.array_equal(bits.powers_canonical_np(base, n), jbits.powers_canonical_np(base, n))
        assert np.array_equal(bits.powers_monty_np(base, n), jbits.powers_monty_np(base, n))
        assert np.array_equal(_np(bits.powers_monty(base, n)), jbits.powers_monty(base, n, np))


def _domain_points_np():
    for log_n, shift in ((0, 1), (6, 1), (9, 3), (5, int(_rng(6).integers(1, P)))):
        assert np.array_equal(ntt.domain_points_np(log_n, shift), jntt.domain_points_np(log_n, shift))


def _domain_points():
    for log_n, shift in ((4, 1), (7, 3), (3, 123456789)):
        d, jd = domain.Domain(log_n, shift), jdomain.Domain(log_n, shift)
        assert np.array_equal(_np(d.first_point_ext()), jd.first_point_ext())
        assert np.array_equal(_np(d.points_natural()), jd.points_natural())


def _num_rows():
    for mod in (chip, jchip):
        with pytest.raises(NotImplementedError):
            mod.BaseAir().num_rows(None)


def _eval_at_ext_points():
    rng = _rng(7)
    coeffs = _monty(rng, (32, 5))
    pts = [_ext(rng) for _ in range(3)]
    dom, jdom = domain.Domain(5, 3), jdomain.Domain(5, 3)
    got = pcs.eval_at_ext_points(_t(coeffs), dom, [_t(z) for z in pts])
    want = jpcs.eval_at_ext_points(coeffs, jdom, pts)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def _coset_selectors_dev():
    got = quotient.coset_selectors_dev(4, 2, "cpu")
    want = jquotient.coset_selectors_dev(4, 2, np)
    assert set(got) == set(want)  # Selector's int constants and "inv_zeroifier"
    for k, v in want.items():
        assert np.array_equal(_np(got[k]), np.asarray(v)), k


def _pow_mod_vec():
    rng = _rng(8)
    x = rng.integers(0, P, size=50, dtype=np.uint64)
    for e in (0, 1, 5, int(rng.integers(0, 1 << 31))):
        assert np.array_equal(quotient.pow_mod_vec(x, e), jquotient.pow_mod_vec(x, e))


def _merkle_mats(seed):
    rng = _rng(seed)
    return [_monty(rng, (16, 3)), _monty(rng, (16, 2)), _monty(rng, (4, 5))]


def _merkle_open_and_verify():
    mats = _merkle_mats(9)
    tree, jtree = merkle.MerkleTree([_t(m) for m in mats]), jmerkle.MerkleTree(mats)
    dims = [m.shape for m in mats]
    assert np.array_equal(_np(tree.root), jtree.root)
    for index in (0, 5, 15):
        rows, sibs = tree.open(index)
        jrows, jsibs = jtree.open(index)
        assert all(np.array_equal(_np(r), j) for r, j in zip(rows, jrows))
        assert np.array_equal(_np(sibs), jsibs)
        assert merkle.verify_opening(tree.root, index, dims, rows, sibs)
        assert jmerkle.verify_opening(jtree.root, index, dims, jrows, jsibs)
        bad = [r.clone() for r in rows]
        bad[2][0] ^= 1
        assert not merkle.verify_opening(tree.root, index, dims, bad, sibs)
        assert not jmerkle.verify_opening(jtree.root, index, dims, [_np(r) for r in bad], jsibs)


def _merkle_open_many_multi():
    mats_a, mats_b = _merkle_mats(10), _merkle_mats(11)[:2]
    trees = [merkle.MerkleTree([_t(m) for m in mats]) for mats in (mats_a, mats_b)]
    jtrees = [jmerkle.MerkleTree(mats) for mats in (mats_a, mats_b)]
    idx = [[1, 7, 7], [0, 15]]
    for (rows, sibs), (jrows, jsibs) in zip(merkle.open_many_multi(trees, idx),
                                            jmerkle.open_many_multi(jtrees, idx)):
        assert all(np.array_equal(_np(r), j) for r, j in zip(rows, jrows))
        assert np.array_equal(_np(sibs), jsibs)


def _merkle_bn254_open():
    mats = _merkle_mats(12)
    tree, jtree = mbn.MerkleTree([_t(m) for m in mats]), jmbn.MerkleTree(mats)
    for index in (3, 12):
        rows, sibs = tree.open(index)
        jrows, jsibs = jtree.open(index)
        assert all(np.array_equal(_np(r), j) for r, j in zip(rows, jrows))
        assert sibs.shape == jsibs.shape and [int(v) for v in sibs.ravel()] == [int(v) for v in jsibs.ravel()]


def _unpack_fr():
    rng = _rng(13)
    arr = rng.integers(0, np.iinfo(np.uint64).max, size=(9, 4), dtype=np.uint64, endpoint=True)
    assert native.unpack_fr(arr) == jnative.unpack_fr(arr)


HELPERS = {
    "field.constants": _field_constants,
    "field.exp_int": _exp_int,
    "field.from_u32": _from_u32,
    "ext4.constants_zeros_like_neg": _ext4_constants_and_neg,
    "ext4.powers_host": _powers_host,
    "bits.powers": _powers_np,
    "ntt.domain_points_np": _domain_points_np,
    "domain.first_point_ext_points_natural": _domain_points,
    "chip.BaseAir.num_rows": _num_rows,
    "pcs.eval_at_ext_points": _eval_at_ext_points,
    "quotient.coset_selectors_dev": _coset_selectors_dev,
    "quotient.pow_mod_vec": _pow_mod_vec,
    "merkle.open_verify_opening": _merkle_open_and_verify,
    "merkle.open_many_multi": _merkle_open_many_multi,
    "merkle_bn254.open": _merkle_bn254_open,
    "native.unpack_fr": _unpack_fr,
}


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_helper_equals_the_reference(helper):
    HELPERS[helper]()

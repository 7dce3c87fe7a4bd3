"""The port's field layer (zkmips_tpu_torch.ops.field / ext4 / bits) against
the reference's numpy path, bit for bit."""

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import bits as jbits, ext4 as jext4, field as jf
from zkmips_tpu_torch import convert
from zkmips_tpu_torch.ops import bits as tbits, ext4 as text4, field as tf

torch.set_num_threads(2)

T, N = convert.to_torch, convert.to_numpy


def rand_fp(rng, shape):
    return rng.integers(0, jf.P, size=shape, dtype=np.int64).astype(np.uint32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_int32_uint32_interop(rng):
    a = rand_fp(rng, (7, 5))
    t = T(a)
    assert t.dtype == torch.int32 and t.shape == (7, 5)
    assert np.array_equal(N(t), a)
    # the top bit is never set, so the signed view holds the same values
    assert int(t.min()) >= 0 and np.array_equal(t.numpy().astype(np.uint32), a)


def test_constants_match():
    for name in ("P", "MONTY_MU", "R2", "MONTY_ONE", "GENERATOR", "TWO_ADICITY"):
        assert getattr(tf, name) == getattr(jf, name)
    assert tf.HALF == int(jf.HALF) and tf.TWO == int(jf.TWO)


def test_monty_roundtrip(rng):
    x = rand_fp(rng, (1000,))
    assert np.array_equal(N(tf.to_monty(T(x))), jf.to_monty(x))
    assert np.array_equal(N(tf.from_monty(T(x))), jf.from_monty(x))
    assert np.array_equal(N(tf.from_monty(tf.to_monty(T(x)))), x)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops(rng, op):
    a, b = rand_fp(rng, (1000,)), rand_fp(rng, (1000,))
    # include the edges 0 and p - 1
    a[:2], b[:2] = 0, jf.P - 1
    assert np.array_equal(N(getattr(tf, op)(T(a), T(b))), getattr(jf, op)(a, b))


@pytest.mark.parametrize("op", ["neg", "double", "square", "inv"])
def test_unary_ops(rng, op):
    a = rand_fp(rng, (500,))
    a[0] = 0
    assert np.array_equal(N(getattr(tf, op)(T(a))), getattr(jf, op)(a))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 1 << 20, jf.P - 2])
def test_pow_const(rng, e):
    a = rand_fp(rng, (64,))
    assert np.array_equal(N(tf.pow_const(T(a), e)), jf.pow_const(a, e))


def test_batch_powers():
    for base, n in ((3, 1), (3, 37), (jf.two_adic_generator_int(10), 1 << 10)):
        assert np.array_equal(N(tf.batch_powers(base, n)), jf.batch_powers(base, n))


def test_scalar_helpers():
    for x in (0, 1, 12345, jf.P - 1):
        assert tf.to_monty_int(x) == jf.to_monty_int(x)
        assert tf.from_monty_int(jf.to_monty_int(x)) == x
    for b in range(25):
        assert tf.two_adic_generator_int(b) == jf.two_adic_generator_int(b)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_ext4_binary(rng, op):
    a, b = rand_fp(rng, (50, 4)), rand_fp(rng, (50, 4))
    assert np.array_equal(N(getattr(text4, op)(T(a), T(b))), getattr(jext4, op)(a, b))


def test_ext4_inv_frobenius_powers(rng):
    a = rand_fp(rng, (50, 4))
    a[0] = 0
    assert np.array_equal(N(text4.inv(T(a))), jext4.inv(a))
    for k in range(4):
        assert np.array_equal(N(text4.frobenius(T(a), k)), jext4.frobenius(a, k))
    assert np.array_equal(N(text4.powers(T(a[1]), 45)), jext4.powers(a[1], 45))
    assert np.array_equal(N(text4.pow_const(T(a), 1000)), jext4.pow_const(a, 1000))
    b = rand_fp(rng, (50,))
    assert np.array_equal(N(text4.mul_base(T(a), T(b))), jext4.mul_base(a, b))
    assert np.array_equal(N(text4.from_base(T(b))), jext4.from_base(b))
    assert np.array_equal(N(text4.scalar(1, 2, 3, 4)), jext4.scalar(1, 2, 3, 4))


def test_bitrev_and_sum(rng):
    x = rand_fp(rng, (64, 3))
    assert np.array_equal(N(tbits.bitrev_rows(T(x))), jbits.bitrev_rows(x))
    for axis in (0, 1):
        assert np.array_equal(N(tbits.sum_mod(T(x), axis)), jbits.sum_mod(x, axis))

"""The port's Poseidon2 and transcript against the reference's numpy
Poseidon2 (backed by csrc/p2_batch.c), bit for bit.

The plain torch versions run here; each CUDA kernel case has a twin marked
``gpu`` that runs on a card and skips without one."""

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import field as jf, poseidon2 as jp
from zkmips_tpu.stark.challenger import DuplexChallenger as JChallenger
from zkmips_tpu_torch import convert
from zkmips_tpu_torch.ops import poseidon2 as tp
from zkmips_tpu_torch.stark.challenger import DuplexChallenger as TChallenger

torch.set_num_threads(2)

T, N = convert.to_torch, convert.to_numpy
WIDTHS = [1, 8, 13, 64, 88]


def rand_fp(seed, shape):
    return np.random.default_rng(seed).integers(0, jf.P, size=shape, dtype=np.int64).astype(np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def test_constants_are_the_references():
    assert tp.RC_EXT_FIRST == jp.RC_EXT_FIRST.tolist()
    assert tp.RC_INTERNAL == jp.RC_INTERNAL.tolist()
    assert tp.RC_EXT_SECOND == jp.RC_EXT_SECOND.tolist()
    assert tp.DIAG == jp.DIAG.tolist()


def test_diagonal_is_the_one_the_kernels_are_written_for():
    """The CUDA internal round has no table: it computes lane i times
    [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/8, 1/2^24, -1/2^8, -1/8,
    -1/16, -1/2^24] by additions and shifts."""
    p = jf.P
    inv = lambda k: pow(2, -k, p)
    want = [-2, 1, 2, inv(1), 3, 4, -inv(1), -3, -4, inv(8), inv(3), inv(24), -inv(8), -inv(3), -inv(4), -inv(24)]
    assert tp._DIAG_CANON == [v % p for v in want]
    assert tp.DIAG == [int(v) for v in jf.to_monty(np.array(tp._DIAG_CANON, dtype=np.uint32))]
    assert tp.kernel_constants().shape == (21, 16)


@pytest.mark.parametrize("w", WIDTHS)
def test_hash_rows(w):
    m = rand_fp(1, (1024, w))
    assert np.array_equal(N(tp.hash_matrix_rows(T(m))), jp.hash_matrix_rows(m))


def test_hash_rows_unaligned_height_and_empty_width():
    m = rand_fp(2, (1000, 21))  # not a multiple of the TPU kernel's 512-row block
    assert np.array_equal(N(tp.hash_matrix_rows(T(m))), jp.hash_matrix_rows(m))
    e = np.zeros((40, 0), dtype=np.uint32)
    assert np.array_equal(N(tp.hash_matrix_rows(T(e))), jp.hash_matrix_rows(e))
    v = rand_fp(3, (19,))
    assert np.array_equal(N(tp.hash_flat(T(v))), jp.hash_flat(v))


def test_compress():
    l, r = rand_fp(4, (2048, 8)), rand_fp(5, (2048, 8))
    assert np.array_equal(N(tp.compress(T(l), T(r))), jp.compress(l, r))


@pytest.mark.parametrize("n", [64, 4096])
def test_tree_levels(n):
    cur = rand_fp(6, (n, 8))
    cur_t = T(cur)
    while cur.shape[0] > 1:
        cur = jp.compress(cur[0::2], cur[1::2])
        cur_t = tp.compress(cur_t[0::2], cur_t[1::2])
        assert np.array_equal(N(cur_t), cur)


@pytest.mark.parametrize("n", [64, 4096])
def test_compress_layer_down_a_tree(n):
    cur = rand_fp(6, (n, 8))
    cur_t = T(cur)
    while cur.shape[0] > 1:
        cur = jp.compress(cur[0::2], cur[1::2])
        cur_t = tp.compress_layer(cur_t)
        assert np.array_equal(N(cur_t), cur)


# Edge vectors: rows of one edge word each (0, 1, p-1, p-2, (p±1)/2, 2^24-1,
# 2^24, 2^31-2^24) and a seeded mix of those with random words.  The plain
# versions run here and fix the values the kernels are held to on the card.
EDGE_WIDTHS = [1, 8, 13, 85]


def test_edge_words_are_field_elements():
    assert set(tp.EDGE_WORDS) >= {0, 1, jf.P - 1, jf.P - 2, (jf.P - 1) // 2, (jf.P + 1) // 2,
                                  2**24 - 1, 2**24, 2**31 - 2**24}
    m = tp.edge_matrix(16, 0)
    assert m.dtype == np.uint32 and m.max() < jf.P and m.shape == (len(tp.EDGE_WORDS) + 64, 16)
    for i, word in enumerate(tp.EDGE_WORDS):
        assert (m[i] == word).all()


def test_permute_edge_vectors():
    s = tp.edge_matrix(16, 9)
    assert np.array_equal(N(tp.permute(T(s))), jp.permute(s))


@pytest.mark.parametrize("w", EDGE_WIDTHS)
def test_hash_rows_edge_vectors(w):
    m = tp.edge_matrix(w, 10 + w)
    assert np.array_equal(N(tp.hash_matrix_rows(T(m))), jp.hash_matrix_rows(m))


def test_compress_edge_vectors():
    s = tp.edge_matrix(16, 11)
    l, r = np.ascontiguousarray(s[:, :8]), np.ascontiguousarray(s[:, 8:])
    want = jp.compress(l, r)
    assert np.array_equal(N(tp.compress(T(l), T(r))), want)
    assert np.array_equal(N(tp.compress_layer(T(s.reshape(-1, 8)))), want)


def test_permute():
    s = rand_fp(7, (300, 16))
    assert np.array_equal(N(tp.permute(T(s))), jp.permute(s))
    for row in s[:3]:
        assert tp.permute_ints([int(v) for v in row]) == jp.permute(row).tolist()


def test_challenger_transcript():
    jc, tc = JChallenger(), TChallenger()
    digest = rand_fp(8, (8,))
    for c in (jc, tc):
        c.observe_digest(digest if c is jc else T(digest))
        c.observe(123)
        c.observe_slice([1, 2, 3])
    assert np.array_equal(N(tc.sample_ext()), jc.sample_ext())
    assert tc.sample_bits(10) == jc.sample_bits(10)
    tc.observe(7)
    jc.observe(7)
    w = tc.grind(8)
    assert w == jc.grind(8)
    assert tc.state == jc.state.tolist()
    assert tc.check_witness(8, w) and jc.check_witness(8, w)
    assert [tc.sample() for _ in range(12)] == [jc.sample() for _ in range(12)]


def test_grind_returns_the_smallest_witness():
    ch = TChallenger()
    ch.observe(5)
    w = ch.grind(8)
    assert ch.clone().check_witness(8, w)
    assert not any(ch.clone().check_witness(8, v) for v in range(w))


# --- CUDA twins --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("w", WIDTHS)
def test_hash_rows_kernel(cuda, w):
    m = rand_fp(1, (1024, w))
    assert np.array_equal(N(tp.hash_matrix_rows(T(m, cuda))), jp.hash_matrix_rows(m))


@pytest.mark.gpu
def test_compress_kernel(cuda):
    l, r = rand_fp(4, (2048, 8)), rand_fp(5, (2048, 8))
    assert np.array_equal(N(tp.compress(T(l, cuda), T(r, cuda))), jp.compress(l, r))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 4096])
def test_tree_levels_kernel(cuda, n):
    cur = rand_fp(6, (n, 8))
    cur_t = T(cur, cuda)
    while cur.shape[0] > 1:
        cur = jp.compress(cur[0::2], cur[1::2])
        cur_t = tp.compress(cur_t[0::2], cur_t[1::2])
        assert np.array_equal(N(cur_t), cur)


@pytest.mark.gpu
def test_permute_kernel_and_grind(cuda):
    s = rand_fp(7, (300, 16))
    assert np.array_equal(N(tp.permute(T(s, cuda))), jp.permute(s))
    jc, tc = JChallenger(), TChallenger()
    jc.observe(9)
    tc.observe(9)
    assert tc.grind(12, cuda) == jc.grind(12)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 4096])
def test_compress_layer_down_a_tree_kernel(cuda, n):
    cur = rand_fp(6, (n, 8))
    cur_t = T(cur, cuda)
    while cur.shape[0] > 1:
        cur = jp.compress(cur[0::2], cur[1::2])
        cur_t = tp.compress_layer(cur_t)
        assert np.array_equal(N(cur_t), cur)


@pytest.mark.gpu
def test_permute_edge_vectors_kernel(cuda):
    s = tp.edge_matrix(16, 9)
    assert np.array_equal(N(tp.permute(T(s, cuda))), jp.permute(s))


@pytest.mark.gpu
@pytest.mark.parametrize("w", EDGE_WIDTHS)
def test_hash_rows_edge_vectors_kernel(cuda, w):
    m = tp.edge_matrix(w, 10 + w)
    assert np.array_equal(N(tp.hash_matrix_rows(T(m, cuda))), jp.hash_matrix_rows(m))


@pytest.mark.gpu
def test_compress_edge_vectors_kernel(cuda):
    s = tp.edge_matrix(16, 11)
    l, r = np.ascontiguousarray(s[:, :8]), np.ascontiguousarray(s[:, 8:])
    want = jp.compress(l, r)
    assert np.array_equal(N(tp.compress(T(l, cuda), T(r, cuda))), want)
    assert np.array_equal(N(tp.compress_layer(T(s.reshape(-1, 8), cuda))), want)
    # halves read where they lie (rows 16 words apart), and a layout that must be copied
    st = T(s, cuda)
    assert np.array_equal(N(tp.compress(st[:, :8], st[:, 8:])), want)
    assert np.array_equal(N(tp.compress(T(l.T.copy(), cuda).T, st[:, 8:])), want)


# ---- the wrappers' device guard and the constants' lock -----------------------


class _StubLib:
    """Stands in for the built library: records, at each call, which device
    the caller had made current."""

    def __init__(self, current):
        self.current, self.calls, self.constants = current, [], []

    def zkm_p2_error_string(self, err):
        return b"stub"

    def zkm_p2_set_constants(self, ptr):
        import time

        time.sleep(0.05)  # widen the window two threads could both enter
        self.constants.append(self.current[-1])
        return 0

    def zkm_p2_hash_rows(self, *args):
        self.calls.append((self.current[-1], args[-1]))
        return 0


@pytest.fixture
def stub_launch(monkeypatch):
    """The wrappers' CUDA surface replaced by a stub: ``torch.cuda.device``
    pushes its device on ``current``, the library records what was current
    at each call."""
    import contextlib

    from zkmips_tpu_torch.ops import poseidon2_cuda as k

    current = [0]

    @contextlib.contextmanager
    def device(d):
        current.append(d.index if isinstance(d, torch.device) else d)
        try:
            yield
        finally:
            current.pop()

    lib = _StubLib(current)
    monkeypatch.setattr(k, "_LIB", lib)
    monkeypatch.setattr(k, "_CONSTANTS_ON", set())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 1000 + d.index})())
    return k, lib


class _FakeOut:
    def __init__(self, index):
        self.device = torch.device("cuda", index)
        self.shape = (4, 8)

    def data_ptr(self):
        return 4096


def test_launch_makes_the_outputs_device_current(stub_launch):
    """A thread whose current device is 0 launching on card 1's tensor:
    the constants are loaded and the kernel launched with card 1 current,
    on card 1's stream."""
    k, lib = stub_launch
    before = k.LAUNCHES["poseidon2_hash_rows"]
    k._launch("poseidon2_hash_rows", "zkm_p2_hash_rows", _FakeOut(1), 1, 2, 3)
    assert lib.constants == [1]
    assert lib.calls == [(1, 1001)]
    assert k.LAUNCHES["poseidon2_hash_rows"] == before + 1


def test_constants_are_loaded_once_per_device_under_threads(stub_launch):
    import threading

    k, lib = stub_launch
    start = threading.Barrier(6)

    def go(index):
        start.wait()
        k._ready(torch.device("cuda", index))

    threads = [threading.Thread(target=go, args=(i % 2 + 1,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(lib.constants) == [1, 2]
    assert k._CONSTANTS_ON == {1, 2}


@pytest.mark.gpu
def test_hash_rows_on_a_second_card_from_device_0():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    m = rand_fp(12, (1024, 21))
    torch.cuda.set_device(0)
    got = tp.hash_matrix_rows(T(m, torch.device("cuda", 1)))
    assert got.device == torch.device("cuda", 1)
    assert np.array_equal(N(got), jp.hash_matrix_rows(m))

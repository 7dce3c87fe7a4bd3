"""Syscall dispatch (host side).

Mirrors the reference's syscall layer (crates/core/executor/src/syscalls/):
HALT steers next_pc to 0 and carries the exit code (halt.rs); WRITE routes
file descriptors to stdout/stderr/public-values/hint streams and parses
cycle-tracker commands (write.rs); COMMIT records the committed-value digest
words (commit.rs); SYSHINTLEN/SYSHINTREAD stream host inputs into
uninitialized memory (hint.rs).  Precompile syscalls are registered in
``PRECOMPILES`` as they are implemented.

Returns (result_or_None, next_pc, extra_cycles, exit_code).
"""

from __future__ import annotations

from .opcodes import Register, SyscallCode

FD_STDOUT = 1
FD_STDERR = 2
FD_PUBLIC_VALUES = 3
FD_HINT = 4

# syscall code -> callable(executor, code, b, c) -> Optional[int]
PRECOMPILES: dict = {}


def dispatch(ex, code: SyscallCode, b: int, c: int):
    next_pc = ex.next_pc
    exit_code = 0
    extra = code.num_extra_cycles
    if code == SyscallCode.HALT:
        return None, 0, extra, b
    if code == SyscallCode.WRITE:
        _write(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.SYSHINTLEN:
        if ex.input_stream_ptr >= len(ex.input_stream):
            raise _err("hint length requested but input stream is empty")
        return len(ex.input_stream[ex.input_stream_ptr]), next_pc, extra, exit_code
    if code == SyscallCode.SYSHINTREAD:
        _hint_read(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.COMMIT:
        if b >= 8:
            raise _err(f"commit word index {b} out of range")
        ex.committed_value_digest[b] = c
        return None, next_pc, extra, exit_code
    if code == SyscallCode.SHA_EXTEND:
        _sha_extend(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.SHA_COMPRESS:
        _sha_compress(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.POSEIDON2_PERMUTE:
        _poseidon2_permute(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.KECCAK_SPONGE:
        _keccak_sponge(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.ENTER_UNCONSTRAINED:
        ex.enter_unconstrained()
        return 1, next_pc, extra, exit_code
    if code == SyscallCode.EXIT_UNCONSTRAINED:
        # the whole enter..exit block collapses to a single constrained row
        # at the ENTER pc returning 0 (reference syscalls/unconstrained.rs:
        # pc is rewound and next_pc re-derived from the restored state)
        ex.exit_unconstrained()
        return 0, (ex.pc + 4) & 0xFFFFFFFF, extra, exit_code
    if code == SyscallCode.COMMIT_DEFERRED_PROOFS:
        if b >= 8:
            raise _err(f"deferred digest word index {b} out of range")
        ex.deferred_proofs_digest[b] = c
        return None, next_pc, extra, exit_code
    if code == SyscallCode.VERIFY_ZKM_PROOF:
        _verify_proof(ex, b, c)
        return None, next_pc, extra, exit_code
    if code == SyscallCode.SYS_EXT_GROUP:
        _linux_event(ex, code, b, c, 0, a3=0)
        return 0, 0, extra, b
    if code in LINUX_SYSCALLS:
        v0 = LINUX_SYSCALLS[code](ex, code, b, c)
        return v0, next_pc, extra, exit_code
    impl = PRECOMPILES.get(code)
    if impl is not None:
        res = impl(ex, code, b, c)
        return res, next_pc, extra, exit_code
    raise _err(f"unsupported syscall {code!r}")


def _err(msg):
    from .executor import ExecutionError

    return ExecutionError(msg)


def _write(ex, fd: int, buf: int):
    nbytes = ex.register(Register.A2)
    data = bytes(ex.byte(buf + i) for i in range(nbytes))
    if fd == FD_STDOUT:
        try:
            s = data.decode()
            if not _handle_cycle_tracker(ex, s):
                ex.stdout.extend(data)
        except UnicodeDecodeError:
            ex.stdout.extend(data)
    elif fd == FD_STDERR:
        ex.stdout.extend(data)
    elif fd == FD_PUBLIC_VALUES:
        ex.public_values_stream.extend(data)
    elif fd == FD_HINT:
        ex.input_stream.append(data)
    elif fd in ex.hook_registry:
        from .hooks import HookError

        try:
            res = ex.hook_registry[fd](ex, bytes(data))
        except HookError as e:
            raise _err(str(e)) from e
        # splice results at the current read position (write.rs:61-65)
        ptr = ex.input_stream_ptr
        ex.input_stream[ptr:ptr] = res
    # other unknown fds are ignored with a warning, as in the reference


def _handle_cycle_tracker(ex, s: str) -> bool:
    if ":" not in s:
        return False
    command, name = s.split(":", 1)
    name = name.strip()
    if command == "cycle-tracker-start" or command == "cycle-tracker-report-start":
        ex.cycle_tracker[f"_start_{name}"] = ex.global_clk
        return True
    if command == "cycle-tracker-end" or command == "cycle-tracker-report-end":
        start = ex.cycle_tracker.pop(f"_start_{name}", None)
        if start is not None:
            ex.cycle_tracker[name] = ex.cycle_tracker.get(name, 0) + ex.global_clk - start
        return True
    return False


def _hint_read(ex, ptr: int, length: int):
    if ex.input_stream_ptr >= len(ex.input_stream):
        raise _err("hint read requested but input stream is empty")
    data = ex.input_stream[ex.input_stream_ptr]
    ex.input_stream_ptr += 1
    if len(data) != length or ptr % 4 != 0:
        raise _err(f"invalid hint read args ptr={ptr:#x} len={length} data_len={len(data)}")
    for i in range(0, length, 4):
        word = int.from_bytes(data[i : i + 4].ljust(4, b"\x00"), "little")
        addr = ptr + i
        if addr in ex.uninitialized_memory:
            raise _err("hint read address already initialized")
        ex.uninitialized_memory[addr] = word


def _ror(x, r):
    return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF


def _sha_extend(ex, w_ptr: int, arg2: int):
    """SHA-256 message schedule extension (reference sha256/extend.rs)."""
    if arg2 != 0:
        raise _err("sha_extend arg2 must be 0")
    from .events import ShaExtendEvent

    clk0 = ex.clk
    r15, r2, r16, r7, wr = [], [], [], [], []
    for i in range(16, 64):
        ts = clk0 + (i - 16)
        rec = ex._mr(w_ptr + (i - 15) * 4, ts)
        r15.append(rec)
        w15 = rec.value
        s0 = _ror(w15, 7) ^ _ror(w15, 18) ^ (w15 >> 3)
        rec = ex._mr(w_ptr + (i - 2) * 4, ts)
        r2.append(rec)
        w2 = rec.value
        s1 = _ror(w2, 17) ^ _ror(w2, 19) ^ (w2 >> 10)
        rec = ex._mr(w_ptr + (i - 16) * 4, ts)
        r16.append(rec)
        w16 = rec.value
        rec = ex._mr(w_ptr + (i - 7) * 4, ts)
        r7.append(rec)
        w7 = rec.value
        w_i = (s1 + w16 + s0 + w7) & 0xFFFFFFFF
        wr.append(ex._mw(w_ptr + i * 4, w_i, ts))
    ex.record.precompile_events.setdefault("sha_extend", []).append(
        ShaExtendEvent(ex.shard, clk0, w_ptr, arg2, tuple(r15), tuple(r2), tuple(r16), tuple(r7), tuple(wr))
    )


SHA_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


def _sha_compress(ex, w_ptr: int, h_ptr: int):
    """SHA-256 compression (reference sha256/compress.rs)."""
    if w_ptr == h_ptr:
        raise _err("sha_compress: w_ptr must differ from h_ptr")
    from .events import ShaCompressEvent

    clk0 = ex.clk
    h_reads, w_reads, h_writes = [], [], []
    hx = []
    for i in range(8):
        rec = ex._mr(h_ptr + i * 4, clk0)
        h_reads.append(rec)
        hx.append(rec.value)
    a, b, c, d, e, f, g, h = hx
    for i in range(64):
        s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
        ch = ((e & f) ^ ((~e) & g)) & 0xFFFFFFFF
        rec = ex._mr(w_ptr + i * 4, clk0)
        w_reads.append(rec)
        temp1 = (h + s1 + ch + SHA_K[i] + rec.value) & 0xFFFFFFFF
        s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
        maj = ((a & b) ^ (a & c) ^ (b & c)) & 0xFFFFFFFF
        temp2 = (s0 + maj) & 0xFFFFFFFF
        h, g, f, e, d, c, b, a = g, f, e, (d + temp1) & 0xFFFFFFFF, c, b, a, (temp1 + temp2) & 0xFFFFFFFF
    v = [a, b, c, d, e, f, g, h]
    for i in range(8):
        h_writes.append(ex._mw(h_ptr + i * 4, (hx[i] + v[i]) & 0xFFFFFFFF, clk0 + 1))
    ex.record.precompile_events.setdefault("sha_compress", []).append(
        ShaCompressEvent(ex.shard, clk0, w_ptr, h_ptr, tuple(h_reads), tuple(w_reads), tuple(h_writes))
    )


def _poseidon2_permute(ex, state_ptr: int, arg2: int):
    """Permute 16 KoalaBear words in place (reference poseidon2/permute.rs).
    The host permutation on Python ints: a syscall permutes one state."""
    from ..ops import field as ffield, poseidon2 as p2

    if arg2 != 0 or state_ptr % 4 != 0:
        raise _err("poseidon2_permute: bad args")
    clk0 = ex.clk
    pre = [ex.word(state_ptr + 4 * i) for i in range(16)]
    if any(v >= ffield.P for v in pre):
        raise _err("poseidon2_permute: state word out of field range")
    state = [ffield.to_monty_int(v) for v in pre]
    post = [ffield.from_monty_int(x) for x in p2.permute_ints(state)]
    records = [ex._mw(state_ptr + 4 * i, post[i], clk0) for i in range(16)]
    ex.record.precompile_events.setdefault("poseidon2", []).append(
        {"shard": ex.shard, "clk": clk0, "ptr": state_ptr, "pre_state": pre,
         "post_state": post, "records": records}
    )


_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_KECCAK_ROT = [
    [0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56], [27, 20, 39, 8, 14],
]


def keccak_f(state):
    """keccak-f[1600] on a 25-element u64 list (x + 5y indexing)."""
    M = (1 << 64) - 1

    def rol(v, r):
        r %= 64
        return ((v << r) | (v >> (64 - r))) & M if r else v

    for rc in _KECCAK_RC:
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
        state = [state[i] ^ d[i % 5] for i in range(25)]
        bmat = [0] * 25
        for x in range(5):
            for y in range(5):
                bmat[y + 5 * ((2 * x + 3 * y) % 5)] = rol(state[x + 5 * y], _KECCAK_ROT[x][y])
        state = [
            bmat[i] ^ ((~bmat[(i % 5 + 1) % 5 + 5 * (i // 5)]) & M & bmat[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        state[0] ^= rc
    return state


def _keccak_sponge(ex, input_ptr: int, result_ptr: int):
    """Keccak sponge with 18-u64 general blocks (reference keccak/sponge.rs)."""
    clk0 = ex.clk
    rec_len = ex._mr(result_ptr + 16 * 4, clk0)
    input_len = rec_len.value
    if input_len % 36 != 0:
        raise _err("keccak_sponge: input length must be a multiple of 36 u32s")
    reads = [ex._mr(input_ptr + 4 * i, clk0) for i in range(input_len)]
    words = [r.value for r in reads]
    u64s = [words[2 * i] | (words[2 * i + 1] << 32) for i in range(input_len // 2)]
    state = [0] * 25
    xored_states = []
    for blk in range(0, len(u64s), 18):
        for i in range(18):
            state[i] ^= u64s[blk + i]
        xored_states.append(list(state))
        state = keccak_f(state)
    out_words = []
    for i in range(8):
        out_words.append(state[i] & 0xFFFFFFFF)
        out_words.append((state[i] >> 32) & 0xFFFFFFFF)
    writes = [ex._mw(result_ptr + 4 * i, out_words[i], clk0 + 1) for i in range(16)]
    ex.record.precompile_events.setdefault("keccak_sponge", []).append(
        {"shard": ex.shard, "clk": clk0, "input_ptr": input_ptr, "result_ptr": result_ptr,
         "input_len": input_len, "reads": reads, "len_record": rec_len,
         "writes": writes, "xored_states": xored_states,
         "output": out_words}
    )


# --- EC / bigint precompiles (reference events/precompiles/ec.rs,
#     syscalls/precompiles/{weierstrass,edwards,fptower,uint256.rs,
#     u256x2048_mul.rs}) --------------------------------------------------

from . import curves as _cv  # noqa: E402  (late import: keep module header light)


def _mr_slice(ex, ptr: int, n: int, clk: int):
    recs = [ex._mr(ptr + 4 * i, clk) for i in range(n)]
    return recs, [r.value for r in recs]


def _mw_slice(ex, ptr: int, vals, clk: int):
    return [ex._mw(ptr + 4 * i, int(v) & 0xFFFFFFFF, clk) for i, v in enumerate(vals)]


def _slice_unsafe(ex, ptr: int, n: int):
    return [ex.word(ptr + 4 * i) for i in range(n)]


def _push_ec_event(ex, key: str, **fields):
    fields.setdefault("shard", ex.shard)
    ex.record.precompile_events.setdefault(key, []).append(fields)


def _ec_add(curve, key):
    def impl(ex, code, p_ptr, q_ptr):
        clk0 = ex.clk
        n = 2 * curve.nwords
        p_words = _slice_unsafe(ex, p_ptr, n)
        q_recs, q_words = _mr_slice(ex, q_ptr, n, clk0)
        px, py = _cv.words_to_int(p_words[: curve.nwords]), _cv.words_to_int(p_words[curve.nwords:])
        qx, qy = _cv.words_to_int(q_words[: curve.nwords]), _cv.words_to_int(q_words[curve.nwords:])
        if px % curve.p == qx % curve.p:
            # the affine-add AIR has no doubling branch (reference
            # WeierstrassAddAssign semantics): guests must call DOUBLE
            raise _err(f"{key}: operands share an x-coordinate (use DOUBLE)")
        try:
            rx, ry = curve.add((px, py), (qx, qy))
        except ValueError as e:
            raise _err(str(e)) from e
        out = _cv.int_to_words(rx, curve.nwords) + _cv.int_to_words(ry, curve.nwords)
        p_recs = _mw_slice(ex, p_ptr, out, clk0 + 1)
        _push_ec_event(ex, key, clk=clk0, p_ptr=p_ptr, q_ptr=q_ptr, p=p_words, q=q_words,
                       p_records=p_recs, q_records=q_recs)
        return None

    return impl


def _ec_double(curve, key):
    def impl(ex, code, p_ptr, arg2):
        clk0 = ex.clk
        n = 2 * curve.nwords
        p_words = _slice_unsafe(ex, p_ptr, n)
        px, py = _cv.words_to_int(p_words[: curve.nwords]), _cv.words_to_int(p_words[curve.nwords:])
        try:
            rx, ry = curve.double((px, py))
        except ValueError as e:
            raise _err(str(e)) from e
        out = _cv.int_to_words(rx, curve.nwords) + _cv.int_to_words(ry, curve.nwords)
        p_recs = _mw_slice(ex, p_ptr, out, clk0)
        _push_ec_event(ex, key, clk=clk0, p_ptr=p_ptr, arg2=arg2, p=p_words, p_records=p_recs)
        return None

    return impl


def _ec_decompress(curve, key):
    def impl(ex, code, slice_ptr, sign):
        if sign > 1:
            raise _err(f"{key}: sign bit must be 0 or 1")
        clk0 = ex.clk
        nw = curve.nwords
        x_recs, x_words = _mr_slice(ex, slice_ptr + 4 * nw, nw, clk0)
        try:
            x, y = curve.decompress(_cv.words_to_int(x_words), sign)
        except ValueError as e:
            raise _err(str(e)) from e
        y_recs = _mw_slice(ex, slice_ptr, _cv.int_to_words(y, nw), clk0)
        _push_ec_event(ex, key, clk=clk0, ptr=slice_ptr, sign=sign, x=x_words,
                       x_records=x_recs, y_records=y_recs)
        return None

    return impl


def _ed_add(ex, code, p_ptr, q_ptr):
    clk0 = ex.clk
    p_words = _slice_unsafe(ex, p_ptr, 16)
    q_recs, q_words = _mr_slice(ex, q_ptr, 16, clk0)
    p1 = (_cv.words_to_int(p_words[:8]), _cv.words_to_int(p_words[8:]))
    p2 = (_cv.words_to_int(q_words[:8]), _cv.words_to_int(q_words[8:]))
    rx, ry = _cv.ed_add(p1, p2)
    out = _cv.int_to_words(rx, 8) + _cv.int_to_words(ry, 8)
    p_recs = _mw_slice(ex, p_ptr, out, clk0 + 1)
    _push_ec_event(ex, "ed_add", clk=clk0, p_ptr=p_ptr, q_ptr=q_ptr, p=p_words, q=q_words,
                   p_records=p_recs, q_records=q_recs)
    return None


def _ed_decompress(ex, code, slice_ptr, sign):
    if sign > 1:
        raise _err("ed_decompress: sign bit must be 0 or 1")
    clk0 = ex.clk
    y_recs, y_words = _mr_slice(ex, slice_ptr + 32, 8, clk0)
    try:
        x, y = _cv.ed_decompress(_cv.words_to_int(y_words), sign)
    except ValueError as e:
        raise _err(str(e)) from e
    x_recs = _mw_slice(ex, slice_ptr, _cv.int_to_words(x, 8), clk0)
    _push_ec_event(ex, "ed_decompress", clk=clk0, ptr=slice_ptr, sign=sign, y=y_words,
                   x_records=x_recs, y_records=y_recs)
    return None


def _fp_op(field: str, op: str):
    mod, nw = _cv.FP_MOD[field]

    def impl(ex, code, x_ptr, y_ptr):
        clk0 = ex.clk
        x_words = _slice_unsafe(ex, x_ptr, nw)
        y_recs, y_words = _mr_slice(ex, y_ptr, nw, clk0)
        a = _cv.words_to_int(x_words) % mod
        b = _cv.words_to_int(y_words) % mod
        r = (a + b) % mod if op == "add" else (a - b) % mod if op == "sub" else a * b % mod
        x_recs = _mw_slice(ex, x_ptr, _cv.int_to_words(r, nw), clk0 + 1)
        _push_ec_event(ex, f"{field}_fp_{op}", clk=clk0, x_ptr=x_ptr, y_ptr=y_ptr,
                       x=x_words, y=y_words, x_records=x_recs, y_records=y_recs)
        return None

    return impl


def _fp2_op(field: str, op: str):
    mod, nw = _cv.FP_MOD[field]

    def impl(ex, code, x_ptr, y_ptr):
        clk0 = ex.clk
        x_words = _slice_unsafe(ex, x_ptr, 2 * nw)
        y_recs, y_words = _mr_slice(ex, y_ptr, 2 * nw, clk0)
        a0, a1 = _cv.words_to_int(x_words[:nw]), _cv.words_to_int(x_words[nw:])
        b0, b1 = _cv.words_to_int(y_words[:nw]), _cv.words_to_int(y_words[nw:])
        if op == "add":
            c0, c1 = (a0 + b0) % mod, (a1 + b1) % mod
        elif op == "sub":
            c0, c1 = (a0 - b0) % mod, (a1 - b1) % mod
        else:  # (a0 + a1*u)(b0 + b1*u) with u^2 = -1
            c0 = (a0 * b0 - a1 * b1) % mod
            c1 = (a0 * b1 + a1 * b0) % mod
        x_recs = _mw_slice(ex, x_ptr, _cv.int_to_words(c0, nw) + _cv.int_to_words(c1, nw), clk0 + 1)
        _push_ec_event(ex, f"{field}_fp2_{op}", clk=clk0, x_ptr=x_ptr, y_ptr=y_ptr,
                       x=x_words, y=y_words, x_records=x_recs, y_records=y_recs)
        return None

    return impl


def _uint256_mul(ex, code, x_ptr, y_ptr):
    clk0 = ex.clk
    x_words = _slice_unsafe(ex, x_ptr, 8)
    y_recs, y_words = _mr_slice(ex, y_ptr, 8, clk0)
    m_recs, m_words = _mr_slice(ex, y_ptr + 32, 8, clk0)
    m = _cv.words_to_int(m_words) or (1 << 256)
    r = _cv.words_to_int(x_words) * _cv.words_to_int(y_words) % m
    x_recs = _mw_slice(ex, x_ptr, _cv.int_to_words(r, 8), clk0 + 1)
    _push_ec_event(ex, "uint256_mul", clk=clk0, x_ptr=x_ptr, y_ptr=y_ptr, x=x_words,
                   y=y_words, modulus=m_words, x_records=x_recs, y_records=y_recs,
                   modulus_records=m_recs)
    return None


def _u256x2048_mul(ex, code, a_ptr, b_ptr):
    clk0 = ex.clk
    lo_rec = ex._mr(Register.A2, clk0)
    hi_rec = ex._mr(Register.A3, clk0)
    lo_ptr, hi_ptr = lo_rec.value, hi_rec.value
    a_recs, a_words = _mr_slice(ex, a_ptr, 8, clk0)
    b_recs, b_words = _mr_slice(ex, b_ptr, 64, clk0)
    r = _cv.words_to_int(a_words) * _cv.words_to_int(b_words)
    lo, hi = r % (1 << 2048), r >> 2048
    lo_recs = _mw_slice(ex, lo_ptr, _cv.int_to_words(lo, 64), clk0 + 1)
    hi_recs = _mw_slice(ex, hi_ptr, _cv.int_to_words(hi, 8), clk0 + 1)
    _push_ec_event(ex, "u256x2048_mul", clk=clk0, a_ptr=a_ptr, b_ptr=b_ptr, a=a_words,
                   b=b_words, lo_ptr=lo_ptr, hi_ptr=hi_ptr, lo_ptr_record=lo_rec,
                   hi_ptr_record=hi_rec, a_records=a_recs, b_records=b_recs,
                   lo_records=lo_recs, hi_records=hi_recs)
    return None


C = SyscallCode
PRECOMPILES.update({
    C.SECP256K1_ADD: _ec_add(_cv.SECP256K1, "secp256k1_add"),
    C.SECP256K1_DOUBLE: _ec_double(_cv.SECP256K1, "secp256k1_double"),
    C.SECP256K1_DECOMPRESS: _ec_decompress(_cv.SECP256K1, "secp256k1_decompress"),
    C.SECP256R1_ADD: _ec_add(_cv.SECP256R1, "secp256r1_add"),
    C.SECP256R1_DOUBLE: _ec_double(_cv.SECP256R1, "secp256r1_double"),
    C.SECP256R1_DECOMPRESS: _ec_decompress(_cv.SECP256R1, "secp256r1_decompress"),
    C.BN254_ADD: _ec_add(_cv.BN254, "bn254_add"),
    C.BN254_DOUBLE: _ec_double(_cv.BN254, "bn254_double"),
    C.BLS12381_ADD: _ec_add(_cv.BLS12381, "bls12381_add"),
    C.BLS12381_DOUBLE: _ec_double(_cv.BLS12381, "bls12381_double"),
    C.BLS12381_DECOMPRESS: _ec_decompress(_cv.BLS12381, "bls12381_decompress"),
    C.ED_ADD: _ed_add,
    C.ED_DECOMPRESS: _ed_decompress,
    C.BLS12381_FP_ADD: _fp_op("bls12381", "add"),
    C.BLS12381_FP_SUB: _fp_op("bls12381", "sub"),
    C.BLS12381_FP_MUL: _fp_op("bls12381", "mul"),
    C.BLS12381_FP2_ADD: _fp2_op("bls12381", "add"),
    C.BLS12381_FP2_SUB: _fp2_op("bls12381", "sub"),
    C.BLS12381_FP2_MUL: _fp2_op("bls12381", "mul"),
    C.BN254_FP_ADD: _fp_op("bn254", "add"),
    C.BN254_FP_SUB: _fp_op("bn254", "sub"),
    C.BN254_FP_MUL: _fp_op("bn254", "mul"),
    C.BN254_FP2_ADD: _fp2_op("bn254", "add"),
    C.BN254_FP2_SUB: _fp2_op("bn254", "sub"),
    C.BN254_FP2_MUL: _fp2_op("bn254", "mul"),
    C.UINT256_MUL: _uint256_mul,
    C.U256XU2048_MUL: _u256x2048_mul,
})



# --- Linux o32 syscall emulation (reference syscalls/precompiles/sys_linux/:
#     brk/mmap/clone/fcntl/read/write return v0 and clear $a3; unknown-but-
#     harmless calls are no-ops; exit_group halts) ------------------------

MIPS_EBADF = 9
FD_STDIN = 0


def _linux_event(ex, code, a0, a1, v0, a3, io=None):
    out = ex._mw(int(Register.A3), a3, ex.clk)
    ex.record.precompile_events.setdefault("sys_linux", []).append(
        {"shard": ex.shard, "clk": ex.clk, "code": int(code), "a0": a0, "a1": a1,
         "v0": v0, "a3": a3, "out": out, "io": io}
    )


def _sys_brk(ex, code, a0, a1):
    io = ex._mr(int(Register.BRK), ex.clk)
    brk = io.value
    v0 = a0 if a0 > brk else brk
    _linux_event(ex, code, a0, a1, v0, a3=0, io=io)
    return v0


_SYS_PAGE = 1 << 12


def _sys_mmap(ex, code, a0, a1):
    size = a1
    if size & (_SYS_PAGE - 1):
        size = (size + _SYS_PAGE - (size & (_SYS_PAGE - 1))) & 0xFFFFFFFF
    io = None
    if a0 == 0:
        v0 = ex.register(Register.HEAP)
        io = ex._mw(int(Register.HEAP), (v0 + size) & 0xFFFFFFFF, ex.clk)
    else:
        v0 = a0
    _linux_event(ex, code, a0, a1, v0, a3=0, io=io)
    return v0


def _sys_clone(ex, code, a0, a1):
    _linux_event(ex, code, a0, a1, 1, a3=0)
    return 1


def _sys_read(ex, code, a0, a1):
    if a0 != FD_STDIN:
        _linux_event(ex, code, a0, a1, 0xFFFFFFFF, a3=MIPS_EBADF)
        return 0xFFFFFFFF
    _linux_event(ex, code, a0, a1, 0, a3=0)
    return 0


def _sys_write(ex, code, a0, a1):
    io = ex._mr(int(Register.A2), ex.clk)
    v0 = io.value
    _write(ex, a0, a1)
    _linux_event(ex, code, a0, a1, v0, a3=0, io=io)
    return v0


def _sys_fcntl(ex, code, a0, a1):
    if a1 == 3:  # F_GETFL
        if a0 == FD_STDIN:
            v0, a3 = 0, 0  # O_RDONLY
        elif a0 in (FD_STDOUT, FD_STDERR):
            v0, a3 = 1, 0  # O_WRONLY
        else:
            v0, a3 = 0xFFFFFFFF, MIPS_EBADF
    elif a1 == 1:  # F_GETFD
        if a0 in (FD_STDIN, FD_STDOUT, FD_STDERR):
            v0, a3 = a0, 0
        else:
            v0, a3 = 0xFFFFFFFF, MIPS_EBADF
    else:
        v0, a3 = 0xFFFFFFFF, MIPS_EBADF
    _linux_event(ex, code, a0, a1, v0, a3=a3)
    return v0


def _sys_nop(ex, code, a0, a1):
    _linux_event(ex, code, a0, a1, 0, a3=0)
    return 0


LINUX_SYSCALLS = {
    C.SYS_BRK: _sys_brk,
    C.SYS_MMAP: _sys_mmap,
    C.SYS_MMAP2: _sys_mmap,
    C.SYS_CLONE: _sys_clone,
    C.SYS_READ: _sys_read,
    C.SYS_WRITE: _sys_write,
    C.SYS_FCNTL: _sys_fcntl,
}
for _c in (C.SYS_OPEN, C.SYS_CLOSE, C.SYS_MUNMAP, C.SYS_RT_SIGACTION,
           C.SYS_RT_SIGPROCMASK, C.SYS_SIGALTSTACK, C.SYS_FSTAT64, C.SYS_MADVISE,
           C.SYS_GETTID, C.SYS_SCHED_GETAFFINITY, C.SYS_CLOCK_GETTIME,
           C.SYS_OPENAT, C.SYS_PRLIMIT64):
    LINUX_SYSCALLS[_c] = _sys_nop



def _verify_proof(ex, vkey_ptr: int, pv_digest_ptr: int):
    """VERIFY_ZKM_PROOF (reference syscalls/verify.rs): pop a (proof, vk)
    from the host-provided proof stream and check it against the vkey and
    public-values digests the guest points at."""
    if vkey_ptr % 4 or pv_digest_ptr % 4:
        raise _err("verify_zkm_proof: pointers must be word-aligned")
    vkey = [ex.word(vkey_ptr + 4 * i) for i in range(8)]
    pv_digest = [ex.word(pv_digest_ptr + 4 * i) for i in range(8)]
    if ex.proof_stream_ptr >= len(ex.proof_stream):
        raise _err("verify_zkm_proof: not enough proofs in the proof stream")
    proof, proof_vk = ex.proof_stream[ex.proof_stream_ptr]
    ex.proof_stream_ptr += 1
    if ex.subproof_verifier is not None:
        ex.subproof_verifier(proof, proof_vk, vkey, pv_digest)
    ex.record.deferred_proof_digests.append((list(vkey), list(pv_digest)))

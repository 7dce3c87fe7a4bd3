"""The port's mesh step (``parallel/kernels.py``) against the reference, on
the CPU (shard placement, ``MipsMachine.prove(devices=...)``, is
``test_torch_placement.py``).

The mesh is a grid of CPU devices (``["cpu"] * 8`` as 4 x 2, and 1 x 1):
the port's mesh is single-process, so a grid may repeat a device.  The
traces are the reference's (``__graft_entry__._real_shard_traces``: a fib
guest in four 64-cycle shards, real chip traces, Global digests and public
values), padded to an even width as ``tests/test_multichip.py`` pads them.
The reference's XLA step compiles for the better part of an hour on the Cpu
chip, so its numpy ``host_stage_reference`` is what the port's step is held
to, on the Branch chip and the Cpu chip.  Everything is integer data and is
compared exactly (tolerance 0).  The port's replay's openings at zeta also
go through the verifier's constraint check, which must accept them and
reject a flipped LogUp or quotient opening.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from zkmips_tpu.ops import field as jf
from zkmips_tpu.parallel import kernels as jk
from zkmips_tpu.stark.challenger import DuplexChallenger as JChallenger

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.machine.machine import MipsMachine
from zkmips_tpu_torch.machine.pv import NUM_PV
from zkmips_tpu_torch.ops import ext4, field as f
from zkmips_tpu_torch.parallel import kernels as tk
from zkmips_tpu_torch.stark.chip import Chip
from zkmips_tpu_torch.stark.machine import VerificationError, _verify_chip_constraints

torch.set_num_threads(2)
N = convert.to_numpy

MESHES = {"4x2": [["cpu"] * 2] * 4, "1x1": [["cpu"]]}
KEYS = (("main_roots", "main_root"), ("perm_roots", "perm_root"), ("quotient_roots", "quotient_root"),
        ("fold_roots", "fold_roots"), ("final_polys", "final_poly"), ("cum_sums", "cum_sum"))


@functools.lru_cache(maxsize=None)
def shards(chip_name: str):
    """The reference's four real shards of ``chip_name``, padded to an even
    width, and the reference's host replay of each."""
    traces, digests, pvs, jchip = graft._real_shard_traces(4, chip_name=chip_name)
    s, h, w = traces.shape
    if w % 2:
        traces = np.concatenate([traces, np.zeros((s, h, 1), dtype=np.uint32)], axis=2)
    refs = [jk.host_stage_reference(jchip, traces[i], pvs[i]) for i in range(s)]
    return traces, digests, pvs, refs


@functools.lru_cache(maxsize=None)
def port_chip(chip_name: str) -> Chip:
    air = next(a for a in MipsMachine().airs if a.name == chip_name)
    return Chip(air, num_public_values=NUM_PV)


@functools.lru_cache(maxsize=None)
def mesh_out(chip_name: str, mesh: str):
    traces, digests, pvs, _refs = shards(chip_name)
    states0 = torch.stack([tk.transcript_prefix_state(pv) for pv in pvs])
    step = tk.make_multichip_step(MESHES[mesh], chip=port_chip(chip_name))
    return step(traces, digests, pvs, states0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("chip_name", ["Branch", "Cpu"])
def test_mesh_step_equals_the_reference(chip_name, mesh):
    traces, digests, _pvs, refs = shards(chip_name)
    out = mesh_out(chip_name, mesh)
    assert traces.shape[0] == 4 and out["main_roots"].shape == (4, 8)
    assert np.array_equal(N(out["all_digests"]), digests)
    assert tk.septic_identity_host(out["all_digests"])
    for i, ref in enumerate(refs):
        for key, ref_key in KEYS:
            assert np.array_equal(N(out[key][i]), ref[ref_key]), f"{ref_key} differs in shard {i}"
    assert out["fold_roots"].shape[1] == traces.shape[1].bit_length() - 1


@pytest.mark.parametrize("chip_name", ["Branch", "Cpu"])
def test_states_equal_a_reference_challenger_replay(chip_name):
    """The final sponge states against the reference's DuplexChallenger
    replaying the protocol over the reference's own roots and sums."""
    _traces, _digests, pvs, refs = shards(chip_name)
    out = mesh_out(chip_name, "4x2")
    for i, ref in enumerate(refs):
        ch = JChallenger()
        ch.observe_slice(pvs[i])
        if ch.input_buffer:
            ch._duplexing()
        ch.observe_digest(ref["main_root"])
        ch.sample_ext(), ch.sample_ext()
        ch.observe_digest(ref["perm_root"])
        ch.observe_slice(jf.from_monty(ref["cum_sum"]))
        ch.sample_ext()
        ch.observe_digest(ref["quotient_root"])
        ch.sample_ext(), ch.sample_ext()
        for r in ref["fold_roots"]:
            ch.observe_digest(r)
            ch.sample_ext()
        assert np.array_equal(N(out["states"][i]), ch.state), f"state differs in shard {i}"


@pytest.mark.parametrize("chip_name", ["Branch", "Cpu"])
def test_port_host_replay_equals_the_reference(chip_name):
    traces, _digests, pvs, refs = shards(chip_name)
    got = tk.host_stage_reference(port_chip(chip_name), traces[0], pvs[0])
    for _key, ref_key in KEYS:
        assert np.array_equal(N(got[ref_key]), refs[0][ref_key]), ref_key
    for name, value in refs[0]["challenges"].items():
        assert np.array_equal(N(got["challenges"][name]), value), name
    assert np.array_equal(N(got["state"]), N(mesh_out(chip_name, "1x1")["states"][0]))


@functools.lru_cache(maxsize=None)
def port_replays(chip_name: str) -> list:
    traces, _digests, pvs, _refs = shards(chip_name)
    return [tk.host_stage_reference(port_chip(chip_name), traces[i], pvs[i]) for i in range(len(pvs))]


def zeta_check(chip_name: str, i: int, opened=None):
    """The verifier's constraint check at zeta over shard ``i``'s replay
    openings (or ``opened``); raises ``VerificationError`` on a mismatch."""
    ref, c = port_replays(chip_name)[i], port_replays(chip_name)[i]["challenges"]
    pv_monty = f.to_monty(convert.to_torch(shards(chip_name)[2][i]).reshape(-1))
    _verify_chip_constraints(port_chip(chip_name), ref["opened"] if opened is None else opened,
                             c["zeta"], c["alpha_q"], [c["alpha"], c["beta"]], pv_monty)


@pytest.mark.parametrize("chip_name", ["Branch", "Cpu"])
def test_zeta_check_accepts_the_replays_openings(chip_name):
    """Each shard's openings of the matrices the replay committed (its roots
    the reference's) satisfy the chip's constraints at zeta."""
    _traces, _digests, _pvs, refs = shards(chip_name)
    for i, (got, ref) in enumerate(zip(port_replays(chip_name), refs)):
        for _key, ref_key in KEYS:
            assert np.array_equal(N(got[ref_key]), ref[ref_key]), f"{ref_key} differs in shard {i}"
        ov = got["opened"]
        assert ov.log_degree == _traces.shape[1].bit_length() - 1
        assert len(ov.quotient) == port_chip(chip_name).quotient_chunks
        zeta_check(chip_name, i)


@pytest.mark.parametrize("part", ["perm_local", "quotient"])
@pytest.mark.parametrize("chip_name", ["Branch", "Cpu"])
def test_zeta_check_rejects_a_tampered_opening(chip_name, part):
    """One ext element of the LogUp opening, or of one quotient chunk's,
    moved by one: the check at zeta rejects it."""
    ov = port_replays(chip_name)[1]["opened"]
    if part == "perm_local":
        t = ov.perm_local.clone()
        t[0] = ext4.add(t[0], ext4.one())
        bad = dataclasses.replace(ov, perm_local=t)
    else:
        q = [c.clone() for c in ov.quotient]
        q[0][0] = ext4.add(q[0][0], ext4.one())
        bad = dataclasses.replace(ov, quotient=q)
    with pytest.raises(VerificationError, match="constraint identity failed at zeta"):
        zeta_check(chip_name, 1, bad)
    zeta_check(chip_name, 1)  # the untouched openings still pass


@pytest.mark.gpu
def test_host_replay_launches_no_kernel_on_the_card():
    """On a card the host replay (its trees hashed by the plain Poseidon2)
    launches neither K1 nor K2 and equals the step, whose commits and fold
    roots launch both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zkmips_tpu_torch.ops import poseidon2_cuda

    traces, digests, pvs, _refs = shards("Branch")
    chip = port_chip("Branch")
    poseidon2_cuda.reset_launches()
    states0 = torch.stack([tk.transcript_prefix_state(pv) for pv in pvs])
    out = tk.make_multichip_step([["cuda"] * 2] * 4, chip=chip)(traces, digests, pvs, states0)
    assert poseidon2_cuda.LAUNCHES["poseidon2_hash_rows"] and poseidon2_cuda.LAUNCHES["poseidon2_compress"]
    poseidon2_cuda.reset_launches()
    got = tk.host_stage_reference(chip, convert.to_torch(traces[0]).cuda(), pvs[0])
    assert not any(poseidon2_cuda.LAUNCHES.values())
    for key, ref_key in KEYS:
        assert torch.equal(out[key][0].cpu(), got[ref_key].cpu()), ref_key


def test_commit_step_without_a_chip():
    traces, digests, _pvs, _refs = shards("Cpu")
    out = tk.make_multichip_step(MESHES["4x2"])(traces, digests)
    assert set(out) == {"main_roots", "all_digests"}
    for i in range(traces.shape[0]):
        assert np.array_equal(N(out["main_roots"][i]), jk.commit_root(traces[i]))


@pytest.mark.parametrize("shape", [(64, 10), (16, 3), (256, 1)])
def test_commit_root_equals_the_reference(shape):
    m = np.random.default_rng(shape[1]).integers(0, jf.P, size=shape, dtype=np.int64).astype(np.uint32)
    assert np.array_equal(N(tk.commit_root(m)), np.asarray(jk.commit_root(m)))
    assert np.array_equal(N(tk.commit_root(convert.to_torch(m))), np.asarray(jk.commit_root(m)))


@pytest.mark.parametrize("npv", [1, 8, 16, 61])
def test_transcript_prefix_state_equals_the_reference(npv):
    pv = np.random.default_rng(npv).integers(0, jf.P, size=npv, dtype=np.int64).astype(np.uint32)
    assert np.array_equal(N(tk.transcript_prefix_state(pv)), jk.transcript_prefix_state(pv))


def test_septic_identity_accepts_genuine_and_rejects_tampered_digests():
    _traces, digests, _pvs, _refs = shards("Branch")
    assert tk.septic_identity_host(digests) and jk.septic_identity_host(digests)
    assert tk.septic_identity_host(convert.to_torch(digests))
    bad = np.array(digests)
    bad[1, 3] = jf.to_monty_int(12345)
    assert not tk.septic_identity_host(bad) and not jk.septic_identity_host(bad)
    assert not tk.septic_identity_host(digests[:3]) and not jk.septic_identity_host(digests[:3])


def test_mesh_must_be_a_grid():
    with pytest.raises(ValueError):
        tk.make_multichip_step([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError):
        tk.make_multichip_step([])

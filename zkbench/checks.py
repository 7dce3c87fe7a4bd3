"""The comparison that decides ``correct``.

Every job of the window is judged once the window has closed:

* ``answer_mismatches``: jobs whose proof does not carry the plain
  reference's outcome (``reference.mips`` on the same ELF image and stdin):
  the public-values stream, the eight committed digest words as the proof's
  own public values hold them (the last core shard's, or the compressed
  proof's aggregated record), a zero exit code and a halt (next pc 0), and
  the cycles the program's executor counts for the job;
* ``rejected_proofs``: jobs whose proof the program's verifier refuses
  (``ProverClient.verify``: every shard, the shard chain and the global
  septic sum; for a compressed proof the recursion proof and its record);
* ``config_mismatches``: proofs whose FRI shape departs from what the
  configuration states: the number of queries, and the log blowup read off
  the main commitment's Merkle paths.

Each is a count with the limit 0.  The public-values layouts below are
Ziren's (``PublicValues`` and ``RecursionPublicValues``) as the program
lays them out; nothing here imports the program.
"""

from __future__ import annotations

from .reference import mips

# core shard public values
PV_START_PC, PV_NEXT_PC, PV_EXIT_CODE, PV_DIGEST = 2, 3, 4, 5
# the recursion record
REC_DIGEST, REC_START_PC, REC_NEXT_PC, REC_EXIT_CODE = 0, 24, 25, 26

LIMITS = {"answer_mismatches": 0, "rejected_proofs": 0, "config_mismatches": 0}


def digest_words(halves: list) -> list:
    return [int(halves[2 * i]) | (int(halves[2 * i + 1]) << 16) for i in range(8)]


def core_outcome(proofs: list) -> dict:
    pvs = [[int(x) for x in p.public_values.tolist()] for p in proofs]
    return {"start_pc": pvs[0][PV_START_PC], "next_pc": pvs[-1][PV_NEXT_PC],
            "exit_code": max(pv[PV_EXIT_CODE] for pv in pvs),
            "digest": digest_words(pvs[-1][PV_DIGEST:PV_DIGEST + 16])}


def compressed_outcome(cp) -> dict:
    rec = [int(x) for x in cp.proof.public_values.tolist()]
    return {"start_pc": rec[REC_START_PC], "next_pc": rec[REC_NEXT_PC],
            "exit_code": rec[REC_EXIT_CODE], "digest": digest_words(rec[REC_DIGEST:REC_DIGEST + 16])}


def shard_proofs(proof) -> list:
    """The STARK proofs a job's container holds."""
    return [proof.proofs[0].proof] if proof.mode == "compressed" else list(proof.proofs)


def fri_shape_ok(p, fri: dict) -> bool:
    """The proof has the configuration's number of queries, and its main
    commitment's paths are as long as its tallest chip at the stated
    blowup."""
    qps = p.fri_proof.query_proofs
    if len(qps) != fri["num_queries"]:
        return False
    main_round = int(any(ov.preprocessed_local is not None for ov in p.opened))  # after the preprocessed
    depth = qps[0].input_openings[main_round][1].shape[0]
    return depth == max(int(ov.log_degree) for ov in p.opened) + fri["log_blowup"]


def judge(jobs: list, program_elf: bytes, fri: dict, entry_pc: int, verify, executed_cycles) -> dict:
    """Counts over ``jobs`` ([{stdin, proof}]); ``verify(proof)`` and
    ``executed_cycles(stdin)`` are the program's, the rest is plain."""
    counts = dict.fromkeys(LIMITS, 0)
    for job in jobs:
        want = mips.run(program_elf, job["stdin"])
        proof = job["proof"]
        got = compressed_outcome(proof.proofs[0]) if proof.mode == "compressed" \
            else core_outcome(proof.proofs)
        right = (got == {"start_pc": entry_pc, "next_pc": 0, "exit_code": want["exit_code"],
                         "digest": want["digest"]}
                 and bytes(proof.public_values) == want["public_values"]
                 and executed_cycles(job["stdin"]) == want["cycles"])
        counts["answer_mismatches"] += not right
        job["cycles"] = want["cycles"]
        try:
            accepted = bool(verify(proof))
        except Exception:  # noqa: BLE001 - any refusal of the verifier is a rejection
            accepted = False
        counts["rejected_proofs"] += not accepted
        counts["config_mismatches"] += sum(not fri_shape_ok(p, fri) for p in shard_proofs(proof))
    return counts

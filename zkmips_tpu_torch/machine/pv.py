"""Public values layout for the MIPS core machine.

Full analog of the reference's PublicValues (crates/stark/src/air/
public_values.rs:11-56): shard + execution-shard ids, pc chaining endpoints,
exit code, the committed-value digest (8 u32 words as 16-bit limb pairs), the
deferred-proofs digest (8 KoalaBear elements), and the previous/last global
memory init/finalize address endpoints.

Addresses are carried as (lo16, hi16) limb pairs rather than the reference's
32 bit columns: the memory endpoint chips compare addresses with 16-bit
limb-difference range checks (memory_bridge.py), so two limbs per address is
the natural encoding here.
"""

PV_SHARD = 0
PV_EXECUTION_SHARD = 1
PV_START_PC = 2
PV_NEXT_PC = 3
PV_EXIT_CODE = 4
PV_DIGEST = 5  # 16 limbs: word i -> limbs (PV_DIGEST + 2i, PV_DIGEST + 2i + 1)
PV_DEFERRED_DIGEST = 21  # 8 KoalaBear field elements
PV_PREV_INIT_ADDR = 29  # (lo16, hi16)
PV_LAST_INIT_ADDR = 31
PV_PREV_FINALIZE_ADDR = 33
PV_LAST_FINALIZE_ADDR = 35
NUM_PV = 37

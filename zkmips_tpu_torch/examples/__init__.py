"""The repository's example programs on the port: the counterparts of
``examples/*.py`` and ``scripts/sound_ladder.py``.

Each module has ``main(argv=None)``, which runs the example and returns a
dict of what it printed (with the proof objects a caller checks), and runs
as ``python -m zkmips_tpu_torch.examples.<name> [--sound] [--cpu]``.  The
examples prove on the CUDA card; ``--cpu`` proves on the CPU instead, and
without a card and without ``--cpu`` they raise.

Quick: ``fibonacci``, ``io``, ``is_prime``, ``large_sum``,
``sha256_precompile``, ``keccak_precompile``, ``poseidon2_precompile``,
``uint256_mul``, ``cycle_tracking``, ``unconstrained``, ``elf_build``,
``real_guest``.  The recursion ladder and the SNARK link: ``compressed``,
``aggregation``, ``groth16``, ``plonk``, ``sound_ladder``.
"""

QUICK = ("fibonacci", "io", "is_prime", "large_sum", "sha256_precompile", "keccak_precompile",
         "poseidon2_precompile", "uint256_mul", "cycle_tracking", "unconstrained", "elf_build",
         "real_guest")
LADDER = ("compressed", "aggregation", "groth16", "plonk", "sound_ladder")

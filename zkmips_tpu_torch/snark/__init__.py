"""The SNARK link: the outer verifier circuit over BN254 (``outer_circuit``,
``gadgets``, ``r1cs``), Groth16 and PLONK (``groth16``, ``plonk``), the
curve and pairing on Python ints (``bn254_curve``) and the C backend of the
MSMs and Fr FFTs (``native``).  All of it is host code."""

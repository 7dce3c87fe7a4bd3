"""Proof bytes and the byte-API verifier (``stark_codec``)."""

"""Sequence encoding and k-mer hashing."""

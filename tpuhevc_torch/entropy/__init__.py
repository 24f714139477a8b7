"""Entropy coding of the port: CABAC, the syntax writer and parser,
headers, SEI and bit I/O (copies of the reference's host code), the
native coder's binding, and the table bit estimate of a TU
(`bitest.tu_bits`, a kernel) with its host tables."""

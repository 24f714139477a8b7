"""Shared utilities: normative tables, YUV I/O, picture hashing, metrics."""

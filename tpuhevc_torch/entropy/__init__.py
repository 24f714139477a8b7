"""Entropy-side estimates of the port: the table bit estimate of a TU
(`bitest.tu_bits`), with tpuhevc's CABAC tables as tensors."""

"""Codec engines of the port: the LD-P device scan and its chunk loop
(LdpScanDriver). The host side (IDR decision, decision walk, CABAC,
decoder) is tpuhevc's."""

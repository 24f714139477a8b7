"""Codec engines of the port: the open-loop intra decision and the
intra picture encode (`intra_decide`, `intra_qt`), the LD-P device scan
and its chunk loop (`inter_batch`, `encoder.LdpScanDriver`). The host side
(intra coding walk, P decision walk, CABAC, decoder) is tpuhevc's."""

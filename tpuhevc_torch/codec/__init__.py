"""Codec engines of the port: the open-loop intra decision and the
intra picture encode (`intra_decide`, `intra_qt`), fixed-8x8 intra
pictures on the device (`intra_frame`), the LD-P device scan
and its chunk loop (`inter_batch`, `encoder.LdpScanDriver`), the B step
(`inter_b`) and the per-frame P stage (`inter_enc`) of random access,
and the host side they feed, copied from the reference: parameters, the
intra coding walk, the P and B decision walks, the GOP-table driver,
in-loop filter decisions and the decoder."""

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit); a run reports the card's limit beside
its shares."""

BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores, dense
HBM_BYTES = 3.35e12  # HBM3 bandwidth, bytes/s

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), at its full power limit of 700 W; a card set below it runs slower,
so every result line carries the card's power limit beside them."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    "bf16_flops_per_s": 989e12,
    "fp32_flops_per_s": 67e12,
}

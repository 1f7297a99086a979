"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit).

Every share of a peak or a roofline in this benchmark divides floating work
by the dense bf16 tensor rate, 989 TFLOP/s, whatever precision the program
computes in. The reason: K1 already builds its f32 results from TF32 tensor
products, and no product that meets the f32 tolerance can run faster than
the fastest floating tensor rate, so a share against this rate cannot pass
100% whatever a later change implements. A card set below 700 W runs slower
than these rates; each run prints the card's power limit beside its shares.
"""

PEAK_FLOPS = 989e12   # dense bf16 / fp16 tensor FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

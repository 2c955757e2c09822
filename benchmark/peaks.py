"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its
700 W limit: NVIDIA's data sheet. A card held below 700 W reaches less;
every result names the card's power limit beside its shares."""

HBM_BYTES_PER_S = 3.35e12
FLOAT32_FLOPS = 67e12          # outside the tensor cores; the recipe's TF32 is off
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time for the work: its bytes at the HBM rate or its
    operations at `peak`, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)

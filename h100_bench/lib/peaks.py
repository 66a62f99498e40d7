"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). The float32 engine's products run on the
tensor cores in TF32 arithmetic (3xTF32), so its model work is held
against the dense TF32 rate, each operation counted once whatever
implements it."""

PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_TF32_FLOPS
            ) -> float:
    """Least seconds the card could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)

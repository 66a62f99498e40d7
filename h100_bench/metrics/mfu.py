"""The whole model's share of the card's peak: each returned clip's model
operations at its own length (padding not counted; lib/counts/model.py),
summed over the untraced window's calls, over its host seconds and the
dense TF32 peak (lib/peaks.py)."""

from h100_bench.lib.peaks import PEAK_TF32_FLOPS


def read(run):
    if run.window_s <= 0 or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / run.window_s / PEAK_TF32_FLOPS

"""Block 1's share of its roofline: the bound of every stem launch the
traced window's calls made (lib/counts/stem.py at the launched shapes,
each operation counted once, against lib/peaks.py), over the device time
of the stem kernels (csrc/stem_band.cu, csrc/stem.cu) in the trace."""

from h100_bench.lib.roofline import share


def match(name: str) -> bool:
    return "stem_band" in name or "stem_pool" in name


def read(run):
    return share(run, "stem", match)

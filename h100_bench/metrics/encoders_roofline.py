"""The encoder kernels' share of their roofline: the bound of every
attention and FFN sublayer and XLM-R stack launch the traced window's
calls made (lib/counts/encoders.py at the launched shapes), over the
device time of their kernels in the trace (csrc/gemm.cuh's products and
row passes, csrc/encoder.cuh's attention core)."""

from h100_bench.lib.roofline import share

KERNELS = ("gemm_tc_kernel", "gemm_wg_kernel", "row_epilogue_kernel",
           "row_norm_bf16_kernel", "attention_core")


def match(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    return share(run, "encoders", match)

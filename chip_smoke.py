#!/usr/bin/env python3
"""Build the port's CUDA kernels, drive its `vta` extraction on raw and
planar frames, one clip and in batches, its training and a long clip on
one card.

    python3 chip_smoke.py             # from the repository root, one CUDA card
    python3 chip_smoke.py --encoders  # phases 1-3's encoder kernels only
    python3 chip_smoke.py --stems     # phases 1-3's and 6a's stem kernels

`--encoders` checks and times the attention, FFN and stack kernels as
phase 3 does, with each launch's device kernels, reports what it finds
without holding it to this design's counts, and prints no `ok` line.
`--stems` checks and times both stem kernels on both entries (and block
2) as phases 3 and 6a do, and prints no `ok` line. Both run on an older
tree too (copy this script into its checkout), for a comparison of
designs.

Phases, in order; any failed check raises, so the script exits non-zero:

 1. the card's name and power limit (nvidia-smi), and TF32 switched off for
    matmuls and cuDNN convolutions (the port computes in float32);
 2. every kernel under jegal_torch/csrc/ built with nvcc (one process per
    source, all started together), timed;
 3. each kernel held against its plain PyTorch twin at the main paths'
    shapes, then timed (CUDA events, median of 20 warm launches, each
    queued while the device sleeps so that the host's queueing is not
    timed) beside its bound, its plain twin and one PyTorch yardstick call
    (`library_ms`):
    stem: a T=128 bucket, 152 padded frames; attention and FFN sublayers:
    the window head's 2688 rows in 21-row segments, post-norm, the gesture
    encoder's 128 rows, pre-norm with a partial key mask, and the text
    encoder's 32 rows at d 768 (8 heads of 96), pre-norm with the text's
    pad tail masked; encoder stack (XLM-R, 12 post-norm GELU layers): the
    12-word text's 32 rows, and 256 rows of two 128-token texts, one half
    padded; for each shape of the attention, FFN and stack kernels (on the
    shared 3xTF32 GEMM of csrc/gemm.cuh) the plan of each product, the
    achieved rate, the bound share, and a second launch that must be
    bit-identical with the first, their timings with the 50 MB L2 flushed
    before each launch (each layer of the real path brings new weights);
    for each attention and stack shape, one launch profiled
    (torch.profiler): its device kernels by name and ms, their count held
    to the design's (4 at the window head, 5 at the gesture and text
    encoders, a stack layer's from its plans), and the attention core's
    device ms beside its own 3xTF32 bound (Q, K and V, or the split QKV
    partials it sums, read once, the output written) and the share of it
    achieved; the core's registers, spills and blocks an SM; flash
    attention: the training step's gesture (8, 8, 128, 64)
    and text (8, 8, 32, 96) shapes, with a pad tail in every batch row and
    one batch row fully masked, and the long clip's (1, 8, 1024, 64) with
    its 24-frame pad tail masked, then a ragged (2, 3, 100, 96) checked and
    not timed, each with two launches bit-identical; then one backward
    through FlashAttention against the plain twin's autograd;
 4. `JegalEngine.extract(modalities="vta", frames=...)` at full width on a
    5 s clip (125 frames of 270x480, chin rows, a 12-word text, 80,000
    samples of 16 kHz audio, 12 word boundaries). Every extract and
    extract_many call replays a CUDA graph per (key, shape signature),
    captured at its first call: each driven path runs as the first call
    of its graphs, with every launch counter set to 0 just before and read
    just after; the graphs it replayed must launch the path's kernels
    (band stem 1, block-2 kernel 1, attention 15, FFN 15, stack 1, every
    other kernel 0: the launches recorded at capture), and the counters
    read twice that (the eager run before the capture, and the capture;
    a replay counts nothing). Then the graph against an eager run of its
    forward on the same inputs: outputs bit-identical, and one profiled
    replay's device kernels the eager run's by name and count, each
    counter's kernel as often as the capture counted it; unit-norm finite
    rows of the right shapes; warm ms/clip (median and quartiles of 30,
    host clock), a torch.profiler breakdown of one clip's device time
    (with the attention core's device ms and the `row_epilogue_kernel`
    launches), and the host's time by engine step (prep, frame staging,
    upload and replay, the rest with the wait); then the `va` timing of
    the same clip as before;
 5. the same weights on a 16-frame, 4-word clip: `vta` on the card against
    the port on the CPU (full-width XLM-R copied to the CPU);
 6. planar frames, the stems, block 2 and extract_many: (a) at phase
    3's T=128 bucket, the window stem's planar entry on the (152, 90, 27,
    160) uint8 frames of the same pixels, the band stem on the float and
    the planar frames, and block 2 on the stem's (148, 43, 78, 64) output,
    each against its twin (and the stems against the window stem on the
    float frames), two launches of each bit-identical, each stem's
    registers, spills, shared memory and blocks an SM, then timed as in
    phase 3; (b) phase 4's clip repacked
    by jegal_torch.ops.video.s2d_repack with its chin rows, `extract(
    modalities="vta", frames=planar)` under the tower's defaults (launches:
    band stem 1, block-2 kernel 1, attention 15, FFN 15, stack 1, every
    other kernel 0), with stem_impl="window" (the window stem's planar
    entry 1 instead of the band stem) and with conv2_impl="dense" (cuDNN's
    block 2, no block-2 kernel), the latter two also on phase 4's raw
    clip, each within abs 1e-4 and min row cosine 0.99999 of phase 4's
    raw-frame embeddings, with its graph checked as in phase 4, warm
    ms/clip and a profile; (c) `extract_many` over eight planar `vta`
    clips (T = 100, 110, 120, 125, 125, 128 and 200, 250: two T buckets;
    batch_size 4 and the ladder: chunks of 4, 2 and 2) under the three
    settings: launches checked as in phase 4 against the count the chunks
    imply (a tower launch per padded clip and 160-frame piece, 10 in all;
    15 attention, 15 FFN and 1 stack a chunk), every result within the
    same bars of the single-clip `extract` of its sample, warm clips/s
    (median of 5 calls) with a profile of one call, the host's waits for
    the card in the pipeline's settles over one call, and (defaults) the
    host's time by step; (d) warm start on a new engine: `warmup_all`
    over the main path's buckets and `warmup(frames_kind=...)` for the
    fused graphs of (b) and (c) and a raw clip at T bucket 512, each with
    the memory its capture added; then the raw and planar clips and
    extract_many again, which must capture nothing (counters 0, no new
    graph);
 7. training, full-width JEGAL with the frozen XLM-R base: (a) the entry
    point, `training.loop.train`, for 10 steps at batch 8 with warmup and
    cosine over a synthetic 16-clip corpus written to a temporary
    directory, then again to step 12, resuming from its step-10
    checkpoint; (b) 23 `train_step`s on one fixed collated batch (B 8, T
    bucket 128, S bucket 32, both modalities kept): launches per step
    (flash 9, stack 1, sublayers 0), warm ms/step (host clock, median and
    quartiles of 20), one step's device busy time (torch.profiler), and a
    falling loss; (c) one step of the same weights and batch on the card
    against the port on the CPU, loss and every gradient leaf;
 8. a long clip: `JegalEngine.extract(modalities="v", visual_feats=...)`
    with T = 1000 (bucket 1024, past the fused gate's 512): 6 flash
    launches and no sublayer launch, and the card against the CPU;
 9. a `training` JSON line, one `kernels` JSON line, the card line, and
    last the `ok` JSON line.

In the `kernels` line, the attention, FFN and stack rows are per clip:
each shape's per-launch time times the launches a T=125 `vta` clip makes at
that shape (6 layers in the window head, 6 in the gesture encoder, 3 in the
text encoder, one XLM-R stack), with each shape's own numbers under
`per_launch` (a shape with 0 launches per clip is checked and timed, and
adds nothing). `launches` is the count from phase 4. The flash attention
row is per training step in the same way (6 gesture and 3 text launches);
its `launches` is the count of one step of phase 7(b), and its long-clip
shape, 0 launches a step, carries its 6 launches a clip from phase 8. The
stem and block-2 rows take their launches from the run of the path that
takes each (`path`): the band stem (the default) from phase 4's raw clip,
its time at the float entry (the planar entry's numbers under
`per_launch`) and block 2 (the default) from phase 4's raw clip, its
time from phase 6(a); the window stem's float and planar entries from
phase 6(b)'s clips under stem_impl="window", their times from phases 3
and 6(a). Their library yardsticks are phase
3's `F.conv3d` stem on the float frames of the same pixels, and
`F.conv2d` + `F.batch_norm` + ReLU for block 2. The
stem (both kernels, both entries), attention, FFN, stack, flash
attention and conv2 rows, whose products run in 3xTF32 on the tensor
cores, state the 3xTF32 bound (`bound_ms`; a stem's planar entry in two
passes, its integer pixels being exact in TF32) and the all-float32 one
(`bound_f32_ms`) beside it; the attention, FFN and stack rows' per-shape
rows carry each product's plan, the achieved rate and the bound share.

Weights are random, drawn from a seeded torch.Generator with randomized
BatchNorm statistics and LayerNorm parameters; nothing is downloaded. The
real xlm-roberta-base vocabulary is not here, and the card machine has no
`tokenizers` wheel, so the text is tokenized by `PieceTokenizer` below, a
backend with the duck-typed interface of jegal_torch.text.WordTokenizer.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SEED = 0
# 12 words, as many as the 5 s clip's word boundaries; 21 tokens with <s>
# and </s> under PieceTokenizer, so the S bucket is 32
SMOKE_TEXT = "the quick brown fox jumps over the lazy dog and then sleeps"

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, TF32 on the tensor cores (dense), and HBM3 bandwidth. The products
# of the stems, the encoder kernels, flash attention and block 2 run in
# 3xTF32 (three TF32 products per float32 one; two for a stem's planar
# entry); everything else computes in float32 on CUDA cores.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# Kernel vs plain twin on the card, max abs error: the twin sums the same
# 147..2048-term float32 products in cuDNN's / cuBLAS's order; observed
# errors are ~1e-5 on outputs of order 1-10, a wrong index is order 1.
KERNEL_ATOL = 1e-4
# Card vs CPU on the whole slice, unit-norm rows: a conv tower, two 6-layer
# transformers and the audio CNN summed in another order on each device.
SLICE_ATOL = 1e-4
SLICE_MIN_COS = 0.99999
# Training step, card vs CPU (phase 6c): the loss within rel 1e-5, and each
# gradient leaf within cosine 0.9999 of the CPU's: both are sums of the same
# float32 products in another order through ~30 layers forward and back,
# which moves a leaf's direction by ~1e-6 (a wrong index or a dropped term
# moves it by far more). A leaf whose gradient is zero
# in exact arithmetic (the key bias: softmax ignores a per-row shift; the
# unused align heads) is rounding noise on both devices, whose cosine means
# nothing: it must stay below 1e-6 of the largest leaf norm on both.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_MIN_COS = 0.9999
TRAIN_NOISE_NORM = 1e-6
# Stack kernel vs its twin: 12 post-norm layers of the same float32 sums in
# another order. Every layer ends in a LayerNorm, which rescales the
# rounding the layer before left to the output's own scale (order 1-5), so
# the error grows about linearly in depth from one layer's ~1e-6..1e-5.
STACK_ATOL = 2e-4


class PieceTokenizer:
    """A minimal tokenizer backend for the smoke text: each word splits into
    pieces of at most 3 characters (offsets inside the word), each piece's
    id is a fixed function of its text in [3, 250002) (crc32), and
    <s>=0 / </s>=2 wrap the sequence, XLM-R's special ids. It has the
    duck-typed interface jegal_torch.text.WordTokenizer needs
    (`enable_padding`, `encode_batch(..., is_pretokenized=True)`)."""

    VOCAB = 250002

    def __init__(self):
        self.pad_id, self.length = 1, None

    def enable_padding(self, pad_id, pad_token, length=None):
        self.pad_id, self.length = pad_id, length

    def encode_batch(self, batch, is_pretokenized=True):
        assert is_pretokenized
        rows = []
        for words in batch:
            ids, offs = [0], [(0, 0)]
            for w in words:
                for i in range(0, len(w), 3):
                    piece = w[i:i + 3]
                    ids.append(3 + zlib.crc32(piece.encode()) % (self.VOCAB - 3))
                    offs.append((i, i + len(piece)))
            rows.append((ids + [2], offs + [(0, 0)]))
        s = max([len(ids) for ids, _ in rows] + [self.length or 0])
        return [SimpleNamespace(
            ids=ids + [self.pad_id] * (s - len(ids)),
            attention_mask=[1] * len(ids) + [0] * (s - len(ids)),
            offsets=offs + [(0, 0)] * (s - len(ids))) for ids, offs in rows]


def word_tokenizer():
    from jegal_torch.text.tokenizer import WordTokenizer

    return WordTokenizer(PieceTokenizer())


def log(*a):
    print(*a, flush=True)


_L2_FLUSH = []


def flush_l2():
    """Overwrite a buffer twice the H100's 50 MB L2 cache."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(25 << 20, device="cuda"))
    _L2_FLUSH[0].zero_()


_CYCLES_PER_MS = []


def device_sleep(ms: float):
    """Keep the device busy for about `ms` (torch.cuda._sleep, calibrated
    once against CUDA events)."""
    import torch

    if not _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(1e7 / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def cuda_ms(fn, reps: int = 20, cold: bool = False) -> float:
    """Median device time of `fn` over `reps` warm runs (CUDA events).
    Before each run the device sleeps for twice the host's time to queue
    `fn`, so that the events time the device's work and not the host's
    queueing (which a chain of small launches would otherwise measure).
    cold: the L2 cache flushed before each run (outside the timing)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            flush_l2()
        device_sleep(2 * host_ms + 0.05)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it."""
    t_op, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem else "bytes")


def bound_3xtf32(flops: float, nbytes: float, passes: int = 3):
    """Bound of a kernel whose products run in 3xTF32 on the tensor cores
    (3 TF32 operations per float32 one at 495 TFLOP/s; `passes` 2 where
    one operand is exact in TF32): (ms, what sets it, the all-float32
    bound's ms beside it)."""
    t_op = passes * flops / PEAK_TF32_FLOPS
    t_mem = nbytes / PEAK_BYTES
    f32_ms, _ = bound(flops, nbytes)
    return (1e3 * max(t_op, t_mem),
            "operations" if t_op >= t_mem else "bytes", f32_ms)


def relaunch_identical(fn, what: str):
    """Two launches of the same inputs must give identical bits (no
    kernel sums with atomics)."""
    import torch

    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{what}: two launches of the same inputs "
                             f"differ")
    log(f"  {what}: two launches bit-identical")


def stem_info(planar: bool, impl: str):
    """The stem kernel's registers, spills, shared memory and blocks an SM
    (stem.kernel_info), None where an older tree cannot say (its
    kernel_info reports the window kernel only)."""
    import inspect

    from jegal_torch.ops.kernels import stem as S

    if "impl" in inspect.signature(S.kernel_info).parameters:
        return S.kernel_info(planar, impl=impl)
    return S.kernel_info(planar) if impl == "window" else None


def gemm_kernel_stats(fn, products, flops: float, nbytes: float, row):
    """Phase 3's lines for a kernel on the shared GEMM: the plan of each
    product (M, N, K) -> (BM, BN, splits), the achieved rate against what
    bounds it, the bound share, and a second launch bit-identical with the
    first (the split-K sums run in a fixed order)."""
    import torch

    from jegal_torch.ops.kernels import gemm_plan as GP

    sms = GP.sm_count(torch.device("cuda"))
    plans = [dict(mnk=[m, n, k], plan=list(GP.plan(m, n, k, sms)))
             for m, n, k in products]
    relaunch_identical(fn, "the kernel")
    ms = row["ms"]
    if row["bound_by"] == "bytes":
        rate, unit = nbytes / ms / 1e6, "GB/s"
    else:
        rate, unit = flops / ms / 1e9, "TFLOP/s (float32 operations)"
    share = row["bound_ms"] / ms
    shown = ", ".join(f"{p['mnk']} -> {tuple(p['plan'])}" for p in plans)
    log(f"  plans (M, N, K) -> (BM, BN, splits): {shown}; {rate:.1f} "
        f"{unit}, {100 * share:.1f} % of its bound ({row['bound_by']}), "
        f"float32 bound {row['bound_f32_ms']:.4f} ms")
    if share > 1:
        raise AssertionError(f"the kernel ran faster than its bound "
                             f"{row['bound_ms']:.4f} ms: the bound is wrong")
    return dict(plans=plans, achieved=rate, achieved_unit=unit,
                bound_share=share, bit_identical=True)


# Phase 3 asserts each encoder shape's count of device kernels a launch;
# `--encoders` (a tree whose design may differ, such as a parent's) only
# reports them.
CHECK_KERNEL_COUNTS = True


def kernel_breakdown(fn, what: str, want: int | None = None):
    """The device kernels of one warm call of `fn` in launch order
    (torch.profiler): [(name, ms)], logged by name. want: the count the
    design launches (checked under CHECK_KERNEL_COUNTS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(name, us / 1e3) for name, us in device_events(prof)]
    by_name: dict = {}
    for name, ms in kernels:
        short = name.split("(")[0].replace("void ", "")
        n, total = by_name.get(short, (0, 0.0))
        by_name[short] = (n + 1, total + ms)
    log(f"  device kernels of one {what}: {len(kernels)}, "
        f"{sum(ms for _, ms in kernels):.4f} ms")
    for short, (n, ms) in by_name.items():
        log(f"    {ms:8.4f} ms  x{n:<3d} {short[:80]}")
    if CHECK_KERNEL_COUNTS and want is not None and len(kernels) != want:
        raise AssertionError(f"{what}: {len(kernels)} device kernels a "
                             f"launch, the design launches {want}")
    return kernels


def sublayer_kernels(plans, prenorm: bool) -> int:
    """Device kernels of one attention sublayer under the plans of its QKV
    and output products: the pre-LN, the QKV product (whose split
    partials the attention core sums), the core, and the output product
    with its split-K reduction or post-LN."""
    return int(prenorm) + 3 + int(plans[1][2] > 1 or not prenorm)


def stack_layer_kernels(plans, prenorm: bool) -> int:
    """Device kernels of one layer of the stack kernel (plans: QKV, output,
    W1, W2): the attention sublayer's, then the pre-LN, W1 and its
    reduction, W2 and its reduction or post-LN."""
    return (sublayer_kernels(plans[:2], prenorm) + int(prenorm) + 2
            + int(plans[2][2] > 1) + int(plans[3][2] > 1 or not prenorm))


def core_row(kernels, r: int, d: int, heads: int, seg: int,
             qkv_splits: int, masked: bool, layers: int = 1):
    """The attention core's row of a breakdown: its device ms, its own bound
    and the share of that bound achieved. Bytes: Q, K and V read once (the
    QKV product's split partials and its bias, where the core sums them),
    the key mask, and the output written; operations: both products, in
    3xTF32."""
    core = [ms for name, ms in kernels if is_core(name)]
    ms = sum(core)
    folded = any("attention_core" in name for name, _ in kernels)
    reads = (qkv_splits * r * 3 * d + 3 * d if folded and qkv_splits > 1
             else 3 * r * d)
    nbytes = 4.0 * layers * (reads + r * d + (r if masked else 0))
    flops = layers * 4.0 * (r // seg) * heads * seg * seg * (d // heads)
    b_ms, b_by, _ = bound_3xtf32(flops, nbytes)
    source = (f"the QKV product's {qkv_splits} partials"
              if folded and qkv_splits > 1 else "the QKV rows")
    log(f"  attention core: {ms:.4f} ms over {len(core)} launches, bound "
        f"{b_ms:.4f} ({b_by}, 3xTF32), {100 * b_ms / ms:.1f} % of it; reads "
        f"{source}")
    return dict(ms=ms, launches=len(core), bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms)


def stem_flops(t_in: int, h: int, w: int) -> float:
    """Operations the fused stem must do on (t_in, h, w) frames: the
    5x7x7x3 products of each conv position the pooled output reads,
    (2 J + 1) x (2 Wp + 1) a frame (the 3x3/2 pool never reads a trailing
    odd conv row or column), for all 64 channels."""
    from jegal_torch.ops.kernels import stem as S

    t_out, j, wp, c = S.pooled_shape(t_in, h, w)
    return 2.0 * t_out * (2 * j + 1) * (2 * wp + 1) * c * (5 * 7 * 7 * 3)


def max_err(got, want, what: str, atol: float) -> float:
    import torch

    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    ok = bool(torch.isfinite(got).all()) and err <= atol
    log(f"  {what}: max abs err {err:.3e}, max rel err {rel:.3e} "
        f"(tolerance abs {atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain twin")
    return err


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_stem(gp, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from jegal_torch.core.layers import f32_convs
    from jegal_torch.ops.kernels import stem as S
    from jegal_torch.ops.video import mask_frames_device

    rng = np.random.default_rng(SEED + 1)
    u8 = torch.from_numpy(rng.integers(0, 256, (128, 270, 480, 3),
                                       dtype=np.uint8)).to(dev)
    chin = torch.from_numpy(rng.integers(90, 200, 128)).to(dev)
    frames = mask_frames_device(u8, chin)                  # (152, 270, 480, 3)
    blk = gp["net_vid"][0]
    ops = S.stem_kernel_params(blk)
    log(f"stem: frames {tuple(frames.shape)} -> "
        f"{S.pooled_shape(*frames.shape[:3])}")
    err = max_err(S.stem_pool(frames, *ops, impl="window"),
                  S.stem_pool_plain(frames, *ops), "stem_pool", KERNEL_ATOL)

    xc = frames.permute(3, 0, 1, 2)[None].contiguous()    # NCDHW
    wc = blk["conv"]["kernel"].permute(4, 3, 0, 1, 2).contiguous()
    bn = blk["bn"]

    def library():
        with f32_convs():
            y = F.conv3d(xc, wc, blk["conv"]["bias"], stride=(1, 3, 3))
        y = F.relu(F.batch_norm(y, bn["mean"], bn["var"], bn["scale"],
                                bn["bias"], False, 0.0, 1e-5))
        return F.max_pool3d(y, (1, 3, 3), (1, 2, 2))

    def kern():
        return S.stem_pool(frames, *ops, impl="window")

    relaunch_identical(kern, "stem_pool")
    log(f"  stem_pool kernel: {stem_info(False, 'window')}")
    t_in, h, w = frames.shape[:3]
    t_out, j, wp, c = S.pooled_shape(t_in, h, w)
    nbytes = 4.0 * (frames.numel() + ops[0].numel() + 2 * c
                    + t_out * j * wp * c)
    b_ms, b_by, f32_ms = bound_3xtf32(stem_flops(t_in, h, w), nbytes)
    row = dict(ms=cuda_ms(kern),
               plain_ms=cuda_ms(lambda: S.stem_pool_plain(frames, *ops)),
               library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
               bound_f32_ms=f32_ms, max_abs_err=err)
    log(f"  stem_pool ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
        f"library {row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}, 3xTF32; "
        f"float32 {f32_ms:.4f}), {100 * b_ms / row['ms']:.1f} % of it")
    return row, (u8, chin, frames, library)


def _sublayer_cases(gp, jp, dev, text_mask):
    """(label, layer weights, rows, seg, prenorm, ln kind, kmask, launches
    per clip, device kernels an attention launch) at the main path's shapes
    for a T=125 clip and the 12-word text (text_mask: its (32,) key
    validity)."""
    import torch

    from jegal_torch.ops.kernels.fused_layer import fused_weights

    g = torch.Generator().manual_seed(SEED + 2)
    win = torch.randn(128 * 21, 512, generator=g).to(dev)
    ges = torch.randn(128, 512, generator=g).to(dev)
    txt = torch.randn(32, 768, generator=g).to(dev)
    kmask = torch.zeros(128, device=dev)
    kmask[:125] = 1.0
    return (
        ("window head R=2688 seg=21 post-norm std-LN",
         fused_weights(gp["transformer"]["layers"][0]), win, 21, False,
         "std", None, 6, 4),
        ("gesture encoder R=128 seg=128 pre-norm ref-LN masked",
         fused_weights(jp["encoder_rgb"]["layers"][0]), ges, 128, True,
         "ref", kmask, 6, 5),
        ("text encoder R=32 seg=32 d=768 (8 heads of 96) pre-norm ref-LN "
         "masked", fused_weights(jp["encoder_text"]["layers"][0]), txt, 32,
         True, "ref", text_mask.to(dev), 3, 5),
    )


def _library_attn(x, w, seg, heads, prenorm, kmask):
    """F.linear + F.scaled_dot_product_attention + F.linear (+ LN): the
    yardstick of one attention sublayer (F.layer_norm stands in for the
    reference LayerNorm of the pre-norm case)."""
    import torch.nn.functional as F

    r, d = x.shape
    n, dk = r // seg, d // heads
    h = F.layer_norm(x, (d,), w["g1"], w["be1"], 1e-5) if prenorm else x
    qkv = F.linear(h, w["wqkv_t"], w["bqkv"])
    q, k, v = qkv.view(n, seg, 3, heads, dk).permute(2, 0, 3, 1, 4)
    mask = None if kmask is None else (kmask.view(n, 1, 1, seg) != 0)
    a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    y = x + F.linear(a.transpose(1, 2).reshape(r, d), w["wo_t"], w["bo"])
    return y if prenorm else F.layer_norm(y, (d,), w["g1"], w["be1"], 1e-5)


def _library_ffn(x, w, prenorm):
    import torch.nn.functional as F

    d = x.shape[1]
    h = F.layer_norm(x, (d,), w["g2"], w["be2"], 1e-5) if prenorm else x
    y = x + F.linear(F.relu(F.linear(h, w["w1_t"], w["b1"])), w["w2_t"],
                     w["b2"])
    return y if prenorm else F.layer_norm(y, (d,), w["g2"], w["be2"], 1e-5)


def check_sublayers(gp, jp, dev, text_mask):
    from jegal_torch.config import NUM_HEADS
    from jegal_torch.ops.kernels import fused_layer as FL
    from jegal_torch.ops.kernels import gemm_plan as GP

    rows = {"attn_sublayer": [], "ffn_sublayer": []}
    sms = GP.sm_count(dev)
    for label, w, x, seg, pre, kind, km, per_clip, n_kern in _sublayer_cases(
            gp, jp, dev, text_mask):
        log(f"sublayers: {label}")
        for name in ("wqkv", "wo", "w1", "w2"):
            w[name + "_t"] = w[name].t().contiguous()
        r, d = x.shape
        dff, heads = w["w1"].shape[1], NUM_HEADS
        n, dk = r // seg, d // heads

        def attn():
            return FL.attn_sublayer(x, w, seg, heads, prenorm=pre,
                                    ln_kind=kind, kmask=km)

        def attn_plain():
            return FL.attn_sublayer_plain(x, w, seg, heads, prenorm=pre,
                                          ln_kind=kind, kmask=km)

        def ffn():
            return FL.ffn_sublayer(x, w, prenorm=pre, ln_kind=kind)

        def ffn_plain():
            return FL.ffn_sublayer_plain(x, w, prenorm=pre, ln_kind=kind)

        e_a = max_err(attn(), attn_plain(), "attn_sublayer", KERNEL_ATOL)
        e_f = max_err(ffn(), ffn_plain(), "ffn_sublayer", KERNEL_ATOL)
        attn_gemm = 2.0 * r * d * 4 * d
        attn_other = 4.0 * n * heads * seg * seg * dk
        attn_bytes = 4.0 * (2 * r * d + 4 * d * d + 6 * d
                            + (r if km is not None else 0))
        ffn_flops = 4.0 * r * d * dff
        ffn_bytes = 4.0 * (2 * r * d + 2 * d * dff + dff + 3 * d)
        products = FL.stack_products(r, d, dff)
        for name, fn, plain, lib, err, gf, of, nb, prods in (
                ("attn_sublayer", attn, attn_plain,
                 lambda: _library_attn(x, w, seg, heads, pre, km), e_a,
                 attn_gemm, attn_other, attn_bytes, products[:2]),
                ("ffn_sublayer", ffn, ffn_plain,
                 lambda: _library_ffn(x, w, pre), e_f, ffn_flops, 0.0,
                 ffn_bytes, products[2:])):
            b_ms, b_by, f32_ms = bound_3xtf32(gf + of, nb)
            row = dict(shape=label, launches_per_clip=per_clip,
                       ms=cuda_ms(fn, cold=True),
                       plain_ms=cuda_ms(plain, cold=True),
                       library_ms=cuda_ms(lib, cold=True), bound_ms=b_ms,
                       bound_by=b_by, bound_f32_ms=f32_ms, max_abs_err=err)
            log(f"  {name} ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
                f"library {row['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
            row.update(gemm_kernel_stats(fn, prods, gf + of, nb, row))
            if name == "attn_sublayer":
                plans = [GP.plan(*p, sms) for p in prods]
                want = sublayer_kernels(plans, pre)
                if CHECK_KERNEL_COUNTS and want != n_kern:
                    raise AssertionError(f"{label}: the plans {plans} give "
                                         f"{want} device kernels, not "
                                         f"{n_kern}")
                kernels = kernel_breakdown(fn, "attn_sublayer launch", want)
                row.update(device_kernels=len(kernels), attention_core=core_row(
                    kernels, r, d, heads, seg, plans[0][2], km is not None))
            rows[name].append(row)
    return rows


def _library_stack(x, ops, lt, seg, heads, kmask):
    """Per layer F.linear + F.scaled_dot_product_attention + F.linear +
    F.layer_norm + F.linear + F.gelu + F.linear + F.layer_norm: the
    yardstick of the XLM-R stack. lt: per layer, the products' weights
    transposed for F.linear."""
    import torch.nn.functional as F

    r, d = x.shape
    n, dk = r // seg, d // heads
    mask = kmask.view(n, 1, 1, seg) != 0
    for l, t in enumerate(lt):
        qkv = F.linear(x, t["wqkv"], ops["bqkv"][l])
        q, k, v = qkv.view(n, seg, 3, heads, dk).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        a = F.linear(a.transpose(1, 2).reshape(r, d), t["wo"], ops["bo"][l])
        x = F.layer_norm(x + a, (d,), ops["g1"][l], ops["be1"][l], 1e-5)
        f = F.linear(F.gelu(F.linear(x, t["w1"], ops["b1"][l])), t["w2"],
                     ops["b2"][l])
        x = F.layer_norm(x + f, (d,), ops["g2"][l], ops["be2"][l], 1e-5)
    return x


def check_stack(rp, dev, ids32, mask32, train_batch):
    """The encoder-stack kernel on XLM-R's 12 layers: the smoke text's 32
    rows (what phase 4 launches once), the fixed training batch's 8 texts
    of 32 tokens (what a training step launches once), and 256 rows of two
    128-token texts (the second half padded), over the embeddings of their
    token ids."""
    import torch

    from jegal_torch.models import roberta as R
    from jegal_torch.ops.kernels import fused_layer as FL
    from jegal_torch.ops.kernels import gemm_plan as GP

    cfg = R.XLMR_BASE
    d, heads, dff = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    ops = R.stack_layers(rp)["fused_ops"]
    lt = [{k: ops[k][l].t().contiguous() for k in ("wqkv", "wo", "w1", "w2")}
          for l in range(cfg.num_layers)]
    g = torch.Generator().manual_seed(SEED + 5)
    ids256 = torch.randint(3, cfg.vocab_size, (2, 128), generator=g)
    ids256[1, 64:] = R.PAD_TOKEN_ID
    rows = []
    for label, ids, mask, per_clip_n, per_step_n in (
            ("XLM-R R=32 seg=32 (the 12-word text, S_b 32) masked",
             ids32, mask32, 1, 0),
            ("XLM-R R=256 seg=32 (the training step's 8 texts, S_b 32) "
             "masked", train_batch["input_ids"], train_batch["text_mask"],
             0, 1),
            ("XLM-R R=256 seg=128 (two texts, one half padded) masked",
             ids256, (ids256 != R.PAD_TOKEN_ID).float(), 0, 0)):
        b, seg = ids.shape
        r = b * seg
        x = R.embeddings(rp["embeddings"], ids.to(dev), cfg).reshape(r, d)
        km = mask.to(dev).reshape(-1)
        log(f"encoder stack: {label}")

        def kern():
            return FL.encoder_stack(x, ops, seg, heads, prenorm=False,
                                    ln_kind="std", activation="gelu",
                                    kmask=km)

        def plain():
            return FL.encoder_stack_plain(x, ops, seg, heads, prenorm=False,
                                          ln_kind="std", activation="gelu",
                                          kmask=km)

        err = max_err(kern(), plain(), "encoder_stack", STACK_ATOL)
        n, dk = r // seg, d // heads
        gemm_flops = cfg.num_layers * (2.0 * r * d * 4 * d
                                       + 4.0 * r * d * dff)
        attn_flops = cfg.num_layers * 4.0 * n * heads * seg * seg * dk
        nbytes = 4.0 * (sum(t.numel() for t in ops.values()) + 2 * r * d + r)
        b_ms, b_by, f32_ms = bound_3xtf32(gemm_flops + attn_flops, nbytes)
        row = dict(shape=label, launches_per_clip=per_clip_n,
                   launches_per_step=per_step_n,
                   ms=cuda_ms(kern, cold=True),
                   plain_ms=cuda_ms(plain, cold=True),
                   library_ms=cuda_ms(
                       lambda: _library_stack(x, ops, lt, seg, heads, km),
                       cold=True),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                   max_abs_err=err)
        log(f"  encoder_stack ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
            f"library {row['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
        products = FL.stack_products(r, d, dff)
        row.update(gemm_kernel_stats(kern, products, gemm_flops + attn_flops,
                                     nbytes, row))
        plans = [GP.plan(*p, GP.sm_count(dev)) for p in products]
        kernels = kernel_breakdown(
            kern, "encoder_stack launch",
            cfg.num_layers * stack_layer_kernels(plans, False))
        row.update(device_kernels=len(kernels), attention_core=core_row(
            kernels, r, d, heads, seg, plans[0][2], True, cfg.num_layers))
        rows.append(row)
    return rows


def _library_flash(q, k, v, mask):
    """F.scaled_dot_product_attention with the additive -1e9 key mask: the
    yardstick of the flash kernel (timed only)."""
    import torch.nn.functional as F

    add = (mask[:, None, None, :] == 0).to(q.dtype) * -1e9
    return F.scaled_dot_product_attention(q, k, v, attn_mask=add)


def check_flash(dev):
    """The flash attention kernel at the training step's two shapes and
    the long clip's, forward against its twin and timed, and at a ragged
    (2, 3, 100, 96), checked only; then one backward through
    FlashAttention against the twin's autograd."""
    import torch

    from jegal_torch.ops.kernels import flash_attention as FA

    g = torch.Generator().manual_seed(SEED + 6)
    rows = []
    for label, (b, h, t, d), valid, per_step, per_long in (
            ("gesture encoder, training (8, 8, 128, 64)", (8, 8, 128, 64),
             100, 6, 0),
            ("text encoder, training (8, 8, 32, 96)", (8, 8, 32, 96), 21,
             3, 0),
            ("gesture encoder, long clip (1, 8, 1024, 64)",
             (1, 8, 1024, 64), 1000, 0, 6),
            ("ragged (2, 3, 100, 96), untimed", (2, 3, 100, 96), 77, None,
             None)):
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dev)
                   for _ in range(3))
        mask = torch.zeros(b, t)
        mask[:, :valid] = 1.0
        if b > 1:
            mask[-1] = 0.0                 # one batch row fully masked
        mask = mask.to(dev)
        log(f"flash attention: {label}, {valid} valid keys"
            + (", last batch row fully masked" if b > 1 else ""))

        def kern():
            return FA.flash_attention(q, k, v, mask)

        def plain():
            return FA.flash_attention_plain(q, k, v, mask)

        err = max_err(kern(), plain(), "flash_attention", KERNEL_ATOL)
        relaunch_identical(kern, "flash_attention")
        if per_step is None:
            continue
        # products only: the softmax's few operations a score add < 2 %
        b_ms, b_by, f32_ms = bound_3xtf32(4.0 * b * h * t * t * d,
                                          4.0 * (4 * b * h * t * d + b * t))
        row = dict(shape=label, launches_per_step=per_step,
                   launches_per_long_clip=per_long, ms=cuda_ms(kern),
                   plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(lambda: _library_flash(q, k, v, mask)),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                   max_abs_err=err)
        rows.append(row)
        log(f"  flash_attention ms {row['ms']:.4f} plain "
            f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
            f"{b_ms:.4f} ({b_by}, 3xTF32; float32 {f32_ms:.4f})")

    q, k, v = (torch.randn(8, 8, 128, 64, generator=g).to(dev)
               for _ in range(3))
    mask = torch.ones(8, 128, device=dev)
    mask[:, 100:] = 0.0
    gout = torch.randn(8, 8, 128, 64, generator=g).to(dev)
    grads = []
    for fn in (FA.flash_attention_diff, FA.flash_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves, mask).backward(gout)
        grads.append([x.grad for x in leaves])
    for name, a, b_ in zip(("dq", "dk", "dv"), *grads):
        max_err(a, b_, f"FlashAttention backward {name} (8, 8, 128, 64)",
                KERNEL_ATOL)
    return rows


def per_clip(rows, key="launches_per_clip"):
    """Sum one kernel's per-launch numbers over its launches in one run of
    its path (`key` names the count: per clip, or per training step)."""
    out = {k: sum(r[k] * r[key] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_f32_ms") if k in rows[0]}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"]
                          * r[key])["bound_by"]
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["per_launch"] = rows
    return out


# ---------------------------------------------------------------------------
# Phases 4-5: the slice
# ---------------------------------------------------------------------------

def clip(t: int, n_words: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    edges = np.linspace(0, t, n_words + 1).astype(int)
    return dict(
        frames=rng.integers(0, 256, (t, 270, 480, 3), dtype=np.uint8),
        chin_rows=rng.integers(90, 200, t),
        wav=(rng.standard_normal(t * 640) * 3000).astype(np.float32),
        word_boundaries=[[f"w{i}", int(edges[i]), int(edges[i + 1]) - 1]
                         for i in range(n_words)],
        fname=f"smoke_t{t}")


def check_embeddings(res, t: int, w: int):
    import numpy as np

    for key, n in (("gesture_emb", t), ("content_emb", w)):
        e = res[key]
        if e is None or e.shape != (n, 512) or e.dtype != np.float32:
            raise AssertionError(f"{key}: got {None if e is None else e.shape}"
                                 f", want ({n}, 512) float32")
        if not np.isfinite(e).all():
            raise AssertionError(f"{key} has non-finite values")
        norms = np.linalg.norm(e, axis=-1)
        if np.abs(norms - 1).max() > 1e-5:
            raise AssertionError(f"{key} rows are not unit-norm: "
                                 f"{norms.min()}..{norms.max()}")


def profile_clip(engine, sample, modalities):
    """Device time of one warm clip by kernel name (torch.profiler)."""
    return profile_run(lambda: engine.extract(modalities=modalities,
                                              **sample),
                       f"warm {modalities} clip")


def device_events(prof):
    """(name, us) of each device kernel a torch.profiler run recorded, in
    launch order. A user annotation on the device timeline (the
    optimizer's "Optimizer.step#AdamW.step") spans kernels counted on
    their own, and is left out."""
    import torch

    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


# the attention core's device kernel: this design's, and the FFMA kernel it
# replaced, so that a breakdown of the parent tree (`--encoders`) reads too
CORE_NAMES = ("attention_core", "segment_attention")


def is_core(name: str) -> bool:
    return any(c in name for c in CORE_NAMES)


def profile_run(fn, what: str):
    """Device time of one call of `fn` by kernel name (torch.profiler); `fn`
    must end in a host fetch or a synchronize. Also the attention core's
    device ms and the split-K reductions' launches in the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict = {}
    for name, us in device_events(prof):
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + us)
    busy = sum(us for _, us in by_name.values())
    log(f"profile of one {what}: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{sum(n for n, _ in by_name.values())} device events")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    core = [v for k, v in by_name.items() if is_core(k)]
    core_ms = sum(us for _, us in core) / 1e3
    core_n = sum(n for n, _ in core)
    reductions = sum(n for k, (n, _) in by_name.items()
                     if "row_epilogue_kernel" in k)
    log(f"  attention core {core_ms:.3f} ms over {core_n} launches; "
        f"row_epilogue_kernel {reductions} launches")
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                attention_core_ms=core_ms, attention_core_launches=core_n,
                row_epilogue_launches=reductions)


def counts(**want):
    """Every kernel's launch count: 0 unless given."""
    from jegal_torch.ops.kernels import _build

    return dict({k: 0 for k in _build.LAUNCHES}, **want)


def replayed(fn):
    """Run `fn` with every graph replay of the engine recorded: -> (fn's
    result, the launches of the graphs it replayed, summed: what the card
    ran, each graph's `_build.LAUNCHES` delta recorded at its capture)."""
    from jegal_torch import api
    from jegal_torch.ops.kernels import _build

    total = dict.fromkeys(_build.LAUNCHES, 0)
    call = api._Graph.__call__

    def counted(self, *a, **kw):
        for k, n in self.launches.items():
            total[k] += n
        return call(self, *a, **kw)

    api._Graph.__call__ = counted
    try:
        out = fn()
    finally:
        api._Graph.__call__ = call
    return out, total


def drive_call(fn, want, what: str):
    """One call of the engine that captures the graph of each key it runs
    (the first of each key on its engine), with every launch counter set to
    0 just before and read just after. The graphs it replayed must launch
    `want` (every other kernel none); the counters read twice that: each
    capture's eager run before it and the capture itself count one a
    launch, and a replay adds nothing. -> (fn's result, the replayed
    launches)."""
    from jegal_torch.ops.kernels import _build

    want = counts(**want)
    _build.reset_launches()
    res, ran = replayed(fn)
    counted = dict(_build.LAUNCHES)
    log(f"  launches on {what}: graphs replayed {ran}; counters (eager "
        f"runs and captures) {counted}")
    if ran != want:
        raise AssertionError(f"{what}: the graphs replayed launch {ran}, "
                             f"want {want}")
    if counted != {k: 2 * n for k, n in want.items()}:
        raise AssertionError(f"{what}: counters {counted}, want twice "
                             f"{want} (the run before each capture, and the "
                             f"capture)")
    return res, ran


def drive(engine, sample, modalities, want, what=None):
    """`drive_call` on one clip's extraction."""
    return drive_call(lambda: engine.extract(modalities=modalities, **sample),
                      want, what or f"the {modalities} path")


# a counter's kernel among a profile's device events (its name holds all
# the parts); `attn_sublayer` by the attention core, which the stack also
# launches once a layer
SIGNATURES = {"stem_band": ("stem_band_kernel",),
              "stem_pool": ("stem_pool_kernel", "FloatFrames"),
              "stem_pool_planar": ("stem_pool_kernel", "PlanarU8"),
              "conv2": ("conv2_kernel",),
              "attn_sublayer": ("attention_core",),
              "flash_attention": ("flash_attention_fwd",)}


def device_kernels(fn):
    """One call of `fn` under torch.profiler -> (its result, {device event
    name: count}). A memset's or memcpy's memory kinds are left out of its
    name: in a graph the profiler sees them as "Unknown"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for name, _ in device_events(prof):
        if name.startswith(("Memset", "Memcpy")):
            name = name.split(" (")[0]
        counts[name] = counts.get(name, 0) + 1
    return result, counts


def replay_check(engine, what: str, xlmr_layers: int = 12):
    """The graph of the engine's last call, against an eager run of its
    forward on the same static inputs: the outputs bit for bit, and the
    device kernels of one profiled replay by name and count against the
    eager run's and against the launches recorded at its capture (each
    counter's kernel as often as counted)."""
    import torch

    entry = engine._graphs[engine.cached_graphs[-1]]
    with torch.inference_mode():
        _, replay = device_kernels(entry.graph.replay)
        out = entry.out.clone()
        eager_out, eager = device_kernels(lambda: entry.fn(**entry.inputs))
        same = torch.equal(eager_out, out)
    launches = {k: n for k, n in entry.launches.items() if n}
    log(f"  graph of {what}: {sum(replay.values())} device events a replay "
        f"({sum(eager.values())} eager), launches at capture {launches}; "
        f"replay and eager outputs {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{what}: the replay differs from the eager run")
    if replay != eager:
        diff = {k: (replay.get(k, 0), eager.get(k, 0))
                for k in set(replay) | set(eager)
                if replay.get(k, 0) != eager.get(k, 0)}
        raise AssertionError(f"{what}: replay vs eager device kernels "
                             f"differ (replay, eager): {diff}")
    for k, parts in SIGNATURES.items():
        want = entry.launches[k]
        if k == "attn_sublayer":
            want += xlmr_layers * entry.launches["encoder_stack"]
        got = sum(n for name, n in replay.items()
                  if all(p in name for p in parts))
        if got != want:
            raise AssertionError(f"{what}: {got} {parts[0]} in a replay, "
                                 f"the capture counted {want}")
    return dict(device_events=sum(replay.values()), launches=launches)


def warm_ms(engine, sample, modalities, reps: int = 30):
    """Host-clock ms/clip of warm extractions: median and quartiles."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.extract(modalities=modalities, **sample)
        walls.append(1e3 * (time.perf_counter() - t0))
    q1, ms, q3 = statistics.quantiles(walls, n=4)
    log(f"  warm {modalities} extraction: {ms:.3f} ms/clip (median of {reps}, "
        f"quartiles {q1:.3f} / {q3:.3f}, min {min(walls):.3f} max "
        f"{max(walls):.3f}), {1e3 / ms:.3f} clips/s")
    return dict(ms_per_clip=ms, ms_q1=q1, ms_q3=q3, clips_per_s=1e3 / ms)


# the engine's host steps timed by `host_split`: (class, method); extract's
# prep runs in the calling thread, extract_many's in its prep pool
HOST_STEPS = {"prepare sample": ("JegalEngine", "_prepare_sample"),
              "prep pool": ("JegalEngine", "_prep_map"),
              "fill frames": ("JegalEngine", "_fill_frames"),
              "stage": ("_Graph", "stage"),
              "upload + replay": ("_Graph", "__call__"),
              "fetch wait": ("JegalEngine", "_finish_fetch")}


def host_split(fn, what: str, reps: int = 10) -> dict:
    """Where the host's time goes in a warm call of `fn`: host-clock ms in
    each engine step (HOST_STEPS; median over `reps` calls), and the rest
    of the call (for `extract`, the wait for the card's result is in it).
    A step that runs inside another (the samples' prep inside the prep
    pool) is not subtracted twice."""
    import inspect
    import threading

    from jegal_torch import api

    lock = threading.Lock()
    spent: dict = {}
    saved = {}
    for step, (cls_name, name) in HOST_STEPS.items():
        cls = getattr(api, cls_name)
        raw = inspect.getattr_static(cls, name)
        saved[step] = (cls, name, raw)
        func = raw.__func__ if isinstance(raw, staticmethod) else raw

        def timed(*a, _step=step, _func=func, **kw):
            t0 = time.perf_counter()
            try:
                return _func(*a, **kw)
            finally:
                with lock:
                    spent[_step] = spent.get(_step, 0.0) \
                        + 1e3 * (time.perf_counter() - t0)

        setattr(cls, name, staticmethod(timed)
                if isinstance(raw, staticmethod) else timed)
    calls = []
    try:
        for _ in range(reps):
            spent.clear()
            t0 = time.perf_counter()
            fn()
            total = 1e3 * (time.perf_counter() - t0)
            calls.append(dict(spent, total=total))
    finally:
        for cls, name, raw in saved.values():
            setattr(cls, name, raw)
    out = {k: statistics.median(c.get(k, 0.0) for c in calls)
           for k in ("total", *HOST_STEPS)}
    nested = {"prepare sample"} if out["prep pool"] else set()
    out["rest"] = out["total"] - sum(out[k] for k in HOST_STEPS
                                     if k not in nested)
    log(f"  host split of a warm {what} (median of {reps}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items() if v))
    return out


def run_slice(gp, jp, rp):
    import numpy as np

    from jegal_torch.api import JegalEngine

    engine = JegalEngine(jp, gp, roberta_params=rp,
                         tokenizer=word_tokenizer())       # device="cuda"
    sample = dict(clip(125, 12, SEED + 3), text=SMOKE_TEXT)
    log(f"slice: vta on {sample['frames'].shape} uint8 frames, "
        f"{len(SMOKE_TEXT.split(' '))} words of text, "
        f"{sample['wav'].shape[0]} samples, "
        f"{len(sample['word_boundaries'])} word boundaries")
    # the main path: vta, its first call capturing its graph
    t0 = time.perf_counter()
    res, launches = drive(engine, sample, "vta", VTA_LAUNCHES)
    log(f"  first clip (the graph's capture) "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    check_embeddings(res, 125, 12)
    log(f"  gesture_emb {res['gesture_emb'].shape} content_emb "
        f"{res['content_emb'].shape}: finite, unit-norm rows")
    graph = replay_check(engine, "the raw vta clip")
    vta = dict(warm_ms(engine, sample, "vta"),
               **profile_clip(engine, sample, "vta"), graph=graph,
               host=host_split(lambda: engine.extract("vta", **sample),
                               "raw vta clip"))

    # the va path of the first slice, timed as before
    res_va, _ = drive(engine, sample, "va", dict(
        stem_band=1, conv2=1, attn_sublayer=12, ffn_sublayer=12))
    check_embeddings(res_va, 125, 12)
    va = dict(warm_ms(engine, sample, "va"),
              **profile_clip(engine, sample, "va"))

    small = dict(clip(16, 4, SEED + 4), text="the quick brown fox")
    on_card = engine.extract(modalities="vta", **small)
    on_cpu = JegalEngine(jp, gp, device="cpu", roberta_params=rp,
                         tokenizer=word_tokenizer()).extract(
                             modalities="vta", **small)
    check_embeddings(on_card, 16, 4)
    check_embeddings(on_cpu, 16, 4)
    for key in ("gesture_emb", "content_emb"):
        a, b = on_card[key], on_cpu[key]
        err = float(np.abs(a - b).max())
        cos = float((a * b).sum(-1).min())
        ok = err <= SLICE_ATOL and cos >= SLICE_MIN_COS
        log(f"  card vs CPU, vta, 16-frame 4-word clip, {key}: max abs err "
            f"{err:.3e} (tolerance {SLICE_ATOL:g}), min row cosine "
            f"{cos:.8f} (tolerance {SLICE_MIN_COS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{key}: the card disagrees with the CPU")
    return launches, dict(vta=vta, va=va), engine, sample, res


# ---------------------------------------------------------------------------
# Phase 6: planar frames, the band stem, block 2, and extract_many
# ---------------------------------------------------------------------------

# launches of one `vta` clip (phase 4) with the default tower settings
VTA_LAUNCHES = dict(stem_band=1, conv2=1, attn_sublayer=15, ffn_sublayer=15,
                    encoder_stack=1)
# the tower settings of phase 6: the defaults (the band stem, the block-2
# kernel), the window stem and the block-2 kernel, and the band stem and
# cuDNN's block 2
SETTINGS = (("defaults", {}),
            ("window + kernel", dict(stem_impl="window")),
            ("band + dense", dict(conv2_impl="dense")))


def tower_launches(kw: dict, n: int, planar: bool) -> dict:
    """The stem and block-2 launches of `n` tower launches under the tower
    settings `kw`."""
    if kw.get("stem_impl", "band") == "band":
        want = {"stem_band": n}
    else:
        want = {"stem_pool_planar" if planar else "stem_pool": n}
    if kw.get("conv2_impl", "kernel") == "kernel":
        want["conv2"] = n
    return want


def check_planar_kernels(gp, dev, u8, chin, frames, stem_library):
    """Phase 6a: the planar entry of the window stem, the band stem on both
    entries, and block 2, each against its twin at the main path's shapes
    (a T = 128 bucket: 152 padded frames, the planar frames the same pixels
    as phase 3's float frames), then timed beside its bound, its twin and a
    library yardstick. -> {kernel: [row per shape]}."""
    import torch
    import torch.nn.functional as F

    from jegal_torch.core.layers import f32_convs
    from jegal_torch.ops.kernels import conv2 as C2
    from jegal_torch.ops.kernels import stem as S
    from jegal_torch.ops.video import edge_pad, s2d_repack

    planar = edge_pad(torch.from_numpy(s2d_repack(u8.cpu().numpy(),
                                                  chin.cpu().numpy()))).to(dev)
    ops = S.stem_kernel_params(gp["net_vid"][0])
    t_in, h, w = frames.shape[:3]
    t_out, n_j, wp, c = S.pooled_shape(t_in, h, w)
    flops = stem_flops(t_in, h, w)
    param_bytes = 4.0 * (ops[0].numel() + 2 * c)
    out_bytes = 4.0 * t_out * n_j * wp * c
    log(f"planar stem: planar {tuple(planar.shape)} uint8 -> "
        f"{(t_out, n_j, wp, c)}; band stem on frames {tuple(frames.shape)} "
        f"and on the planar frames")
    rows: dict = {"stem_pool_planar": [], "stem_band": [], "conv2": []}
    reference = S.stem_pool(frames, *ops, impl="window")
    for name, entry, impl, x, in_bytes in (
            ("stem_pool_planar", "planar", "window", planar, planar.numel()),
            ("stem_band", "float", "band", frames, 4.0 * frames.numel()),
            ("stem_band", "planar", "band", planar, planar.numel())):
        if entry == "planar":
            def kern(x=x, impl=impl):
                return S.stem_pool_planar(x, *ops, impl=impl)

            def plain(x=x):
                return S.stem_pool_planar_plain(x, *ops)
        else:
            def kern(x=x, impl=impl):
                return S.stem_pool(x, *ops, impl=impl)

            def plain(x=x):
                return S.stem_pool_plain(x, *ops)
        label = f"{name} ({entry} frames)"
        err = max_err(kern(), plain(), label, KERNEL_ATOL)
        max_err(kern(), reference, f"{label} vs the window stem on the "
                f"float frames", KERNEL_ATOL)
        nbytes = in_bytes + param_bytes + out_bytes
        relaunch_identical(kern, label)
        log(f"  {label} kernel: {stem_info(entry == 'planar', impl)}")
        # 3xTF32; two passes on the planar entry's exact pixels
        passes = 2 if entry == "planar" else 3
        b_ms, b_by, f32_ms = bound_3xtf32(flops, nbytes, passes=passes)
        row = dict(shape=f"{entry} frames {tuple(x.shape)}",
                   ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(stem_library), bound_ms=b_ms,
                   bound_by=b_by, bound_f32_ms=f32_ms, max_abs_err=err)
        rows[name].append(row)
        log(f"  {label} ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
            f"library {row['library_ms']:.4f} (on the float frames) bound "
            f"{b_ms:.4f} ({b_by}, 3xTF32 in {passes} passes; float32 "
            f"{f32_ms:.4f}), {100 * b_ms / row['ms']:.1f} % of it")

    blk2 = gp["net_vid"][1]
    c2 = C2.conv2_kernel_params(blk2)
    x = reference
    xc = x.permute(0, 3, 1, 2).contiguous()                    # NCHW
    w2 = blk2["conv"]["kernel"][0].permute(3, 2, 0, 1).contiguous()
    bn = blk2["bn"]

    def library():
        with f32_convs():
            y = F.conv2d(xc, w2, blk2["conv"]["bias"], stride=2)
        return F.relu(F.batch_norm(y, bn["mean"], bn["var"], bn["scale"],
                                   bn["bias"], False, 0.0, 1e-5))

    t2, j2, wp2, c_out = C2.out_shape(*x.shape[:3])
    log(f"conv2: {tuple(x.shape)} -> {(t2, j2, wp2, c_out)}")
    err = max_err(C2.conv2_bn_relu(x, *c2), C2.conv2_bn_relu_plain(x, *c2),
                  "conv2", KERNEL_ATOL)
    max_err(C2.conv2_bn_relu(x, *c2), library().permute(0, 2, 3, 1),
            "conv2 vs F.conv2d + F.batch_norm + ReLU", KERNEL_ATOL)
    relaunch_identical(lambda: C2.conv2_bn_relu(x, *c2), "conv2")
    b_ms, b_by, f32_ms = bound_3xtf32(
        2.0 * t2 * j2 * wp2 * c_out * 25 * 64,
        4.0 * (x.numel() + c2[0].numel() + 2 * c_out
               + t2 * j2 * wp2 * c_out))
    row = dict(shape=f"{tuple(x.shape)}",
               ms=cuda_ms(lambda: C2.conv2_bn_relu(x, *c2)),
               plain_ms=cuda_ms(lambda: C2.conv2_bn_relu_plain(x, *c2)),
               library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
               bound_f32_ms=f32_ms, max_abs_err=err)
    rows["conv2"].append(row)
    log(f"  conv2 ms {row['ms']:.4f} plain {row['plain_ms']:.4f} library "
        f"{row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}, 3xTF32; "
        f"float32 {f32_ms:.4f})")
    return rows


def compare(a, b, what: str):
    """Embeddings of one sample from two runs: max abs err and min row
    cosine of each output against SLICE_ATOL / SLICE_MIN_COS."""
    import numpy as np

    worst = dict(err=0.0, cos=1.0)
    for key in ("gesture_emb", "content_emb"):
        x, y = a[key], b[key]
        if x.shape != y.shape:
            raise AssertionError(f"{what}, {key}: shapes {x.shape} vs "
                                 f"{y.shape}")
        err = float(np.abs(x - y).max())
        cos = float((x * y).sum(-1).min())
        ok = err <= SLICE_ATOL and cos >= SLICE_MIN_COS
        log(f"  {what}, {key}: max abs err {err:.3e} (tolerance "
            f"{SLICE_ATOL:g}), min row cosine {cos:.8f} (tolerance "
            f"{SLICE_MIN_COS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}, {key}: the runs disagree")
        worst = dict(err=max(worst["err"], err), cos=min(worst["cos"], cos))
    return worst


def many_samples():
    """Phase 6c's eight planar `vta` samples: T = 100, 110, 120, 125, 125,
    128 (bucket 128) and 200, 250 (bucket 256), each with the smoke text
    and the same 5 s wav and 12 word boundaries, so only the T bucket sets
    the groups."""
    import numpy as np

    from jegal_torch.ops.video import s2d_repack

    base = clip(125, 12, SEED + 3)
    out = []
    for i, t in enumerate((100, 110, 120, 125, 125, 128, 200, 250)):
        rng = np.random.default_rng(SEED + 20 + i)
        frames = rng.integers(0, 256, (t, 270, 480, 3), dtype=np.uint8)
        out.append(dict(frames=s2d_repack(frames, rng.integers(90, 200, t)),
                        text=SMOKE_TEXT, wav=base["wav"],
                        word_boundaries=base["word_boundaries"],
                        fname=f"many_t{t}_{i}"))
    return out


def many_launches(samples, batch_size: int, kw: dict):
    """The launches extract_many must make: per chunk (of one T bucket)
    one tower launch per padded clip and 160-frame piece, and one JEGAL
    forward (15 attention and FFN sublayers, one XLM-R stack)."""
    from jegal_torch.data.bucketing import T_BUCKETS, batch_ladder, next_bucket

    groups: dict = {}
    for s in samples:
        b = next_bucket(s["frames"].shape[0], T_BUCKETS)
        groups[b] = groups.get(b, 0) + 1
    tower = chunks = 0
    for bucket, n in groups.items():
        pieces = -(-(bucket + 20) // 160)
        for lo in range(0, n, batch_size):
            tower += batch_ladder(min(batch_size, n - lo), batch_size) * pieces
            chunks += 1
    want = dict(tower_launches(kw, tower, True),
                attn_sublayer=15 * chunks, ffn_sublayer=15 * chunks,
                encoder_stack=chunks)
    return want, chunks


def settle_waits(eng, samples, busy_ms: float):
    """How far extract_many's pipeline overlaps the host with the card: the
    host's waits for the card in settle (the fetch of each chunk), summed
    over one warm call. Without overlap the card would work only while the
    host waits, so the device busy time (`busy_ms`, one profiled call) past
    the waits ran beside the host's own work."""
    waits = []
    finish = eng._finish_fetch

    def timed(fetch):
        t0 = time.perf_counter()
        out = finish(fetch)
        waits.append(1e3 * (time.perf_counter() - t0))
        return out

    eng._finish_fetch = timed
    t0 = time.perf_counter()
    try:
        eng.extract_many(samples, "vta", batch_size=4)
    finally:
        del eng._finish_fetch
    wall = 1e3 * (time.perf_counter() - t0)
    wait = sum(waits)
    log(f"  pipeline: the host waited {wait:.3f} ms for the card in "
        f"{len(waits)} settles of a {wall:.3f} ms call (waits "
        f"{', '.join(f'{w:.3f}' for w in waits)}); device busy beyond the "
        f"waits {busy_ms - wait:.3f} ms")
    return dict(settle_wait_ms=wait, settle_waits_ms=waits,
                overlapped_device_ms=busy_ms - wait)


def run_planar(gp, jp, engine, sample, raw_res):
    """Phase 6b-c: the `vta` clip of phase 4 as planar frames, and
    extract_many over eight planar clips, each under the tower's default
    settings, with the window stem and the block-2 kernel, and with the
    band stem and the block-2 kernel (and phase 4's raw clip under the
    latter two too), every call replaying its graph."""
    import torch

    from jegal_torch.api import JegalEngine
    from jegal_torch.ops.video import s2d_repack

    planar = dict(sample, frames=s2d_repack(sample["frames"],
                                            sample["chin_rows"]))
    del planar["chin_rows"]
    log(f"planar slice: vta on {planar['frames'].shape} uint8 planar "
        f"frames (phase 4's clip, repacked with its chin rows)")
    samples = many_samples()
    want_many = {}
    stats: dict = {}
    launches: dict = {}
    for label, kw in SETTINGS:
        eng = JegalEngine(jp, gp, roberta_params=engine.roberta_params,
                          tokenizer=engine.tokenizer, **kw)
        want = dict(VTA_LAUNCHES, stem_band=0, conv2=0)
        want.update(tower_launches(kw, 1, planar=True))
        res, got = drive(eng, planar, "vta", want,
                         f"the planar vta path ({label})")
        launches[label] = got
        check_embeddings(res, 125, 12)
        graph = replay_check(eng, f"the planar vta clip ({label})")
        vs_raw = compare(res, raw_res, f"planar ({label}) vs raw frames "
                         f"(defaults), T = 125 vta clip")
        stats[label] = dict(vs_raw, **warm_ms(eng, planar, "vta"),
                            **profile_clip(eng, planar, "vta"), graph=graph)
        if not kw:
            stats[label]["host"] = host_split(
                lambda: eng.extract("vta", **planar), "planar vta clip")
        if kw:   # phase 4's raw clip: this setting's float entries
            raw = f"{label} (raw frames)"
            want = dict(VTA_LAUNCHES, stem_band=0, conv2=0)
            want.update(tower_launches(kw, 1, planar=False))
            res, launches[raw] = drive(eng, sample, "vta", want,
                                       f"the raw vta path ({label})")
            compare(res, raw_res, f"raw frames ({label}) vs raw frames "
                    f"(defaults), T = 125 vta clip")
            stats[raw] = dict(warm_ms(eng, sample, "vta"),
                              **profile_clip(eng, sample, "vta"))

        log(f"extract_many ({label}): 8 planar vta clips, T = "
            f"{[s['frames'].shape[0] for s in samples]}, batch_size 4, "
            f"ladder on")
        singles = [eng.extract(modalities="vta", **s) for s in samples]
        want_many, n_chunks = many_launches(samples, 4, kw)
        # each of the call's chunks is the first of its key (padded batches
        # 4 and 2 at T bucket 128, 2 at 256)
        results, got_many = drive_call(
            lambda: eng.extract_many(samples, "vta", batch_size=4),
            want_many, f"one extract_many call ({label}, {n_chunks} chunks)")
        many_graph = replay_check(eng, f"the last extract_many chunk "
                                  f"({label})")
        worst = dict(err=0.0, cos=1.0)
        for s, r, one in zip(samples, results, singles):
            check_embeddings(r, s["frames"].shape[0], 12)
            w = compare(r, one, f"extract_many vs extract, {s['fname']}")
            worst = dict(err=max(worst["err"], w["err"]),
                         cos=min(worst["cos"], w["cos"]))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.extract_many(samples, "vta", batch_size=4)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        prof = profile_run(lambda: eng.extract_many(samples, "vta",
                                                    batch_size=4),
                           f"extract_many call ({label})")
        log(f"  warm extract_many ({label}): {wall * 1e3:.3f} ms a call "
            f"(median of 5, min {min(walls) * 1e3:.3f} max "
            f"{max(walls) * 1e3:.3f}), {len(samples) / wall:.3f} clips/s")
        overlap = settle_waits(eng, samples, prof["device_busy_ms"])
        if not kw:
            overlap["host"] = host_split(
                lambda: eng.extract_many(samples, "vta", batch_size=4),
                "extract_many call", reps=5)
        stats[f"extract_many ({label})"] = dict(
            launches=got_many, graph=many_graph, chunks=n_chunks,
            ms_per_call=wall * 1e3,
            clips_per_s=len(samples) / wall, max_abs_err=worst["err"],
            min_row_cos=worst["cos"], **prof, **overlap)
        eng.close()
    torch.cuda.synchronize()
    return launches, stats


def run_graphs(gp, jp, rp, sample):
    """Phase 6d, warm start: on a new engine, `warmup_all` over the main
    path's buckets (T 128, S 32, W 16, mel 512; the two-stage graphs of
    vta, va and v), then `warmup(frames_kind=...)` for the fused graphs
    that phases 4 and 6 run (the raw and the planar clip at T bucket 128,
    extract_many's chunks of 4 and 2 at 128 and of 2 at 256) and for a raw
    clip at T bucket 512, the largest single-clip graph; each with the
    seconds it took and what its capture added to the memory the caching
    allocator holds, its cache emptied before and after (all of an
    engine's graphs share one pool). Then
    live calls at the warmed buckets: no capture (every launch counter
    stays 0), no new ledger entry, and the replays' launches."""
    import torch

    from jegal_torch.api import JegalEngine
    from jegal_torch.ops.kernels import _build
    from jegal_torch.ops.video import s2d_repack

    eng = JegalEngine(jp, gp, roberta_params=rp, tokenizer=word_tokenizer())
    warmup, added = eng.warmup, []

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # what is held, not what is cached
        return torch.cuda.memory_reserved()

    def measured(**kw):
        before = reserved()
        t0 = time.perf_counter()
        warmup(**kw)
        seconds = time.perf_counter() - t0
        added.append(dict(kw, seconds=seconds,
                          reserved_mib=(reserved() - before) / 2 ** 20))
        log(f"  warmup {kw}: {added[-1]['seconds']:.3f} s, reserved "
            f"+{added[-1]['reserved_mib']:.1f} MiB")

    eng.warmup = measured
    log("warm start: warmup_all over the main path's buckets")
    try:
        records = eng.warmup_all(combos=("vta", "va", "v"), t_buckets=(128,),
                                 s_buckets=(32,), w_buckets=(16,),
                                 mel_buckets=(512,))
        for rec, mem in zip(records, added):
            log(f"  warmup_all record {rec}: reserved "
                f"+{mem['reserved_mib']:.1f} MiB")
        log("warm start: the fused graphs of phases 4 and 6, and a raw clip "
            "at T bucket 512")
        content = dict(modalities="vta", s=32, w=16, mel=512)
        for kw in (dict(t=128, frames_kind="raw"),
                   dict(t=128, frames_kind="planar"),
                   dict(t=128, batch=4, frames_kind="planar"),
                   dict(t=128, batch=2, frames_kind="planar"),
                   dict(t=256, batch=2, frames_kind="planar"),
                   dict(t=512, frames_kind="raw")):
            measured(**content, **kw)
    finally:
        del eng.warmup
    n = len(eng.cached_graphs)
    planar = dict(sample, frames=s2d_repack(sample["frames"],
                                            sample["chin_rows"]))
    del planar["chin_rows"]
    samples = many_samples()
    live = {}
    for what, fn in (
            ("the raw vta clip", lambda: eng.extract("vta", **sample)),
            ("the planar vta clip", lambda: eng.extract("vta", **planar)),
            ("extract_many", lambda: eng.extract_many(samples, "vta",
                                                      batch_size=4))):
        _build.reset_launches()
        _, ran = replayed(fn)
        counted = {k: v for k, v in _build.LAUNCHES.items() if v}
        live[what] = {k: v for k, v in ran.items() if v}
        log(f"  {what} after warmup: graphs replayed {live[what]}, "
            f"counters {counted}, {len(eng.cached_graphs)} graphs")
        if counted or len(eng.cached_graphs) != n:
            raise AssertionError(f"{what}: a live call after warmup "
                                 f"captured a graph")
    total = reserved() / 2 ** 20
    log(f"  {n} graphs cached; the caching allocator holds {total:.1f} MiB "
        f"in all (this engine's and the earlier phases' live tensors)")
    return dict(warmup_all=records, warmups=added, live_launches=live,
                graphs=n, reserved_mib=total)


# ---------------------------------------------------------------------------
# Phases 7-8: training and a long clip
# ---------------------------------------------------------------------------

# words of 4-6 characters: 2 PieceTokenizer pieces each, so a 10-word text is
# 22 tokens with <s> and </s>, in the S = 32 bucket
CORPUS_WORDS = ("quick", "brown", "jumps", "over", "lazy", "sleeps", "under",
                "warm", "while", "birds", "sing", "softly", "near", "river")


def write_corpus(root: Path, n_clips: int = 16, n_words: int = 30):
    """A synthetic training corpus under `root` in the reference's formats:
    per clip a transcript (four header lines, then WORD, START, END, SCORE
    rows), a 16 kHz int16 wav and a (T, 1024) float32 feature file; and
    the corpus CSV. -> (csv path, feature dir)."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(SEED + 7)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    lines = ["filename,text_path,audio_path"]
    for i in range(n_clips):
        words = rng.choice(CORPUS_WORDS, n_words)
        rows, t = [], 0.0
        for w in words:
            dur = float(rng.uniform(0.15, 0.3))
            rows.append(f"{w}, {t:.2f}, {t + dur:.2f}, 0.95")
            t += dur + float(rng.uniform(0.02, 0.08))
        text = root / f"clip{i}.txt"
        text.write_text("\n".join([f"Text: {' '.join(words)}", "Lang: en",
                                   "", "WORD, START, END, SCORE", *rows])
                        + "\n")
        wav = root / f"clip{i}.wav"
        wavfile.write(wav, 16000, (rng.standard_normal(int(t * 16000) + 3200)
                                   * 3000).astype(np.int16))
        np.save(feat_dir / f"clip{i}.npy", rng.standard_normal(
            (int(t * 25) + 2, 1024), dtype=np.float32))
        lines.append(f"clip{i},{text},{wav}")
    csv = root / "corpus.csv"
    csv.write_text("\n".join(lines) + "\n")
    return csv, feat_dir


def fixed_batch(tokenizer):
    """One collated batch of 8 clips of 72..128 frames with 10-word texts:
    T bucket 128, S bucket 32, W bucket 16 (CPU tensors)."""
    import numpy as np

    from jegal_torch.training.data import collate_training_batch

    rng = np.random.default_rng(SEED + 9)
    samples = []
    for i in range(8):
        t, n = 128 - 8 * i, 10
        edges = np.linspace(0, t, n + 1).astype(int)
        words = [str(w) for w in rng.choice(CORPUS_WORDS, n)]
        samples.append(dict(
            visual_feats=rng.standard_normal((t, 1024), dtype=np.float32),
            text=" ".join(words),
            wav=(rng.standard_normal(t * 640) * 3000).astype(np.float32),
            word_boundaries=[[w, int(edges[j]), int(edges[j + 1]) - 1]
                             for j, w in enumerate(words)]))
    batch = collate_training_batch(samples, tokenizer)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    if shapes["visual_feats"] != (8, 128, 1024) \
            or shapes["input_ids"] != (8, 32):
        raise AssertionError(f"the fixed batch has shapes {shapes}")
    return batch


def _grads(jp, rp, batch):
    """Loss and every gradient leaf of one step's loss (gates 1, 1) at the
    weights `jp` on their device."""
    import torch

    from jegal_torch.models.roberta import XLMR_BASE
    from jegal_torch.training import trainer as TR

    state = TR.init_state(jp, TR.make_optimizer())
    leaves = TR.param_leaves(state.params)
    loss = TR.loss_fn(state.params, rp, batch, (1.0, 1.0), XLMR_BASE)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


def train_card_vs_cpu(jp, rp, batch):
    """Phase 7c: one step's loss and gradients, card against CPU."""
    import torch

    from jegal_torch.convert import tree_to_torch

    loss_d, g_d = _grads(jp, rp, {k: v.cuda() for k, v in batch.items()})
    rp_cpu = tree_to_torch({"embeddings": rp["embeddings"],
                            "layers": rp["layers"]}, "cpu")
    loss_c, g_c = _grads(tree_to_torch(jp, "cpu"), rp_cpu, batch)
    rel = abs(loss_d - loss_c) / abs(loss_c)
    norms = [g.norm().item() for g in g_c]
    floor = TRAIN_NOISE_NORM * max(norms)
    worst_cos, worst_leaf, noise, max_abs = 1.0, -1, 0, 0.0
    for i, (a, b) in enumerate(zip(g_d, g_c)):
        a = a.cpu()
        max_abs = max(max_abs, (a - b).abs().max().item())
        if norms[i] <= floor:
            noise += 1
            if a.norm().item() > floor:
                raise AssertionError(f"gradient leaf {i}: zero on the CPU, "
                                     f"{a.norm().item():.3e} on the card")
            continue
        cos = (torch.dot(a.reshape(-1).double(), b.reshape(-1).double())
               / (a.double().norm() * b.double().norm())).item()
        if cos < worst_cos:
            worst_cos, worst_leaf = cos, i
    ok = rel <= TRAIN_LOSS_RTOL and worst_cos >= TRAIN_GRAD_MIN_COS
    log(f"  card vs CPU, one training step: loss {loss_d:.7f} vs "
        f"{loss_c:.7f} (rel err {rel:.3e}, tolerance {TRAIN_LOSS_RTOL:g}); "
        f"{len(g_c)} gradient leaves, min cosine {worst_cos:.8f} (leaf "
        f"{worst_leaf}, tolerance {TRAIN_GRAD_MIN_COS}), {noise} leaves zero "
        f"up to rounding on both, max abs err {max_abs:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training step: the card disagrees with the CPU")
    return dict(loss_card=loss_d, loss_cpu=loss_c, loss_rel_err=rel,
                min_grad_cos=worst_cos, noise_leaves=noise,
                grad_max_abs_err=max_abs)


def _jsonl(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def run_training(jp, rp, batch):
    """Phase 7: the training entry point, steady steps on a fixed batch
    (`fixed_batch`), and card against CPU. rp: XLM-R with its stack
    operands (the engine's copy)."""
    import math
    import tempfile

    import torch

    from jegal_torch.models.roberta import XLMR_BASE
    from jegal_torch.ops.kernels import _build
    from jegal_torch.parallel.checkpoint import checkpoint_steps
    from jegal_torch.training import loop as TL
    from jegal_torch.training import trainer as TR

    tok = word_tokenizer()
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        csv, feat_dir = write_corpus(root)
        ckpt, metrics = root / "ckpt", root / "train.jsonl"
        kw = dict(batch_size=8, lr=1e-4, warmup_steps=2, cosine_decay=True,
                  ckpt_dir=str(ckpt), ckpt_every=10, log_path=str(metrics),
                  seed=SEED)
        for steps, want_run, want_ckpts in ((10, 10, [10]),
                                            (12, 2, [10, 12])):
            log(f"training: loop.train to step {steps} over 16 synthetic "
                f"clips, batch 8")
            _build.reset_launches()
            t0 = time.perf_counter()
            res = TL.train(str(csv), str(feat_dir), jp, rp, XLMR_BASE, tok,
                           steps=steps, **kw)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            lines = _jsonl(metrics)
            losses = [x["loss"] for x in lines]
            log(f"  {res['steps']} steps in {wall:.2f} s, losses "
                f"{losses}, launches {launches}, checkpoints "
                f"{checkpoint_steps(str(ckpt))}")
            if res["steps"] != want_run or [x["step"] for x in lines] != \
                    list(range(1, steps + 1)):
                raise AssertionError(f"loop.train ran {res['steps']} steps, "
                                     f"logged {[x['step'] for x in lines]}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"non-finite training loss: {losses}")
            if checkpoint_steps(str(ckpt)) != want_ckpts:
                raise AssertionError(f"checkpoints "
                                     f"{checkpoint_steps(str(ckpt))}, want "
                                     f"{want_ckpts}")
            if launches != counts(encoder_stack=want_run,
                                  flash_attention=9 * want_run):
                raise AssertionError(f"loop.train launches {launches}")
            out[f"loop_to_{steps}"] = dict(steps_run=res["steps"],
                                           wall_s=wall, losses=losses)

    log("training: 23 steps on one fixed batch (B 8, T 128, S 32), gates "
        "(1, 1)")
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    opt = TR.make_optimizer(lr=1e-4)
    state = TR.init_state(jp, opt)
    losses = []

    def step():
        nonlocal state
        state, loss = TR.train_step(state, dev_batch, (1.0, 1.0),
                                    roberta_params=rp, roberta_cfg=XLMR_BASE,
                                    optimizer=opt)
        losses.append(loss)
        torch.cuda.synchronize()

    _build.reset_launches()
    step()
    launches = dict(_build.LAUNCHES)
    log(f"  launches in one training step: {launches}")
    want = counts(encoder_stack=1, flash_attention=9)
    if launches != want:
        raise AssertionError(f"training step: launches {launches}, want "
                             f"{want}")
    step()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        walls.append(1e3 * (time.perf_counter() - t0))
    q1, ms, q3 = statistics.quantiles(walls, n=4)
    prof = profile_run(step, "training step")
    losses = [x.item() for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"  warm training step: {ms:.3f} ms/step (median of 20, quartiles "
        f"{q1:.3f} / {q3:.3f}); device busy {prof['device_busy_ms']:.3f} ms "
        f"of one step; loss {losses[0]:.5f} -> {losses[-1]:.5f} (mean of "
        f"first 5 {first:.5f}, last 5 {last:.5f})")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"the loss does not fall on a fixed batch: "
                             f"{losses}")
    out.update(launches_per_step=launches, ms_per_step=ms, ms_q1=q1,
               ms_q3=q3, step_wall_ms_profiled=prof["wall_ms"],
               device_busy_ms=prof["device_busy_ms"],
               device_idle_share=1 - prof["device_busy_ms"] / ms,
               losses=losses)
    out["card_vs_cpu"] = train_card_vs_cpu(jp, rp, batch)
    return out, launches


def run_long_clip(engine, jp):
    """Phase 8: a 1000-frame clip (bucket 1024) past the fused gate: the
    gesture encoder's layer loop on the flash kernel."""
    import numpy as np

    from jegal_torch.api import JegalEngine

    feats = np.random.default_rng(SEED + 8).standard_normal(
        (1000, 1024), dtype=np.float32)
    log("long clip: v on (1000, 1024) visual features, T bucket 1024")
    res, launches = drive(engine, dict(visual_feats=feats), "v", dict(
        stem_pool=0, attn_sublayer=0, ffn_sublayer=0, encoder_stack=0,
        flash_attention=6))
    replay_check(engine, "the long clip")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.extract(modalities="v", visual_feats=feats)
        walls.append(1e3 * (time.perf_counter() - t0))
    on_cpu = JegalEngine(jp, device="cpu").extract(modalities="v",
                                                   visual_feats=feats)
    a, b = res["gesture_emb"], on_cpu["gesture_emb"]
    for e in (a, b):
        if e.shape != (1000, 512) or not np.isfinite(e).all():
            raise AssertionError(f"long clip gesture_emb {e.shape}")
    err = float(np.abs(a - b).max())
    cos = float((a * b).sum(-1).min())
    ok = err <= SLICE_ATOL and cos >= SLICE_MIN_COS
    log(f"  warm long clip {statistics.median(walls):.3f} ms (median of 5); "
        f"card vs CPU: max abs err {err:.3e} (tolerance {SLICE_ATOL:g}), "
        f"min row cosine {cos:.8f} (tolerance {SLICE_MIN_COS}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("long clip: the card disagrees with the CPU")
    return launches, dict(ms_per_clip=statistics.median(walls),
                          max_abs_err=err, min_row_cos=cos)


def smoke_text_ids():
    """The smoke text as the engine tokenizes it: (1, 32) ids padded to its
    S bucket, and the (1, 32) key mask."""
    import torch

    from jegal_torch.data.bucketing import S_BUCKETS, next_bucket

    batch = word_tokenizer().encode_words([SMOKE_TEXT])
    s_nat = batch.input_ids.shape[1]
    s_b = next_bucket(s_nat, S_BUCKETS)
    log(f"smoke text: {len(batch.words[0])} words, S_nat {s_nat}, S_b {s_b}")
    if not (17 <= s_nat <= 32 and s_b == 32):
        raise AssertionError(f"the smoke text should tokenize to 17-32 "
                             f"tokens, got {s_nat}")
    ids = torch.ones(1, s_b, dtype=torch.int64)           # pad id 1
    ids[0, :s_nat] = torch.from_numpy(batch.input_ids[0]).long()
    return ids, (ids != 1).float()


def main() -> int:
    global CHECK_KERNEL_COUNTS
    mode = sys.argv[1:]
    if mode not in ([], ["--encoders"], ["--stems"]):
        print(f"usage: {sys.argv[0]} [--encoders | --stems]",
              file=sys.stderr)
        return 2
    if not (ROOT / "jegal_torch").is_dir():
        print(f"chip_smoke.py: no jegal_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from jegal_torch.convert import (
        init_gestsync_params,
        init_jegal_params,
        init_roberta_params,
    )
    from jegal_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    gp = init_gestsync_params(g, dev)
    if mode == ["--stems"]:   # phases 3's and 6a's stems, reported, no more
        stem, stem_inputs = check_stem(gp, dev)
        rows = check_planar_kernels(gp, dev, *stem_inputs)
        log(json.dumps({"stems": dict(rows, stem_pool=[stem])}))
        return 0
    jp = init_jegal_params(g, dev)
    t0 = time.perf_counter()
    rp = init_roberta_params(g, device=dev)                # xlm-roberta-base
    log(f"XLM-R base drawn in {time.perf_counter() - t0:.2f} s")
    ids32, mask32 = smoke_text_ids()
    train_batch = fixed_batch(word_tokenizer())

    if mode == ["--encoders"]:   # phase 3's encoder kernels, reported
        CHECK_KERNEL_COUNTS = False
        sub = check_sublayers(gp, jp, dev, mask32[0])
        stack = check_stack(rp, dev, ids32, mask32, train_batch)
        log(json.dumps({"encoders": dict(sub, encoder_stack=stack)}))
        return 0
    from jegal_torch.ops.kernels import fused_layer as FL

    for dk in FL.HEAD_DIMS:
        for packed in (True, False):
            info = FL.attention_info(dk, packed)
            log(f"attention core, dk {dk}, "
                f"{'packed' if packed else 'streamed'}: {info}")
            if info["spill_bytes"]:
                raise AssertionError(f"the attention core spills: {info}")
    stem, stem_inputs = check_stem(gp, dev)
    sub = check_sublayers(gp, jp, dev, mask32[0])
    stack = check_stack(rp, dev, ids32, mask32, train_batch)
    flash = check_flash(dev)
    launches, slice_stats, engine, sample, raw_res = run_slice(gp, jp, rp)
    log("slice: " + json.dumps(slice_stats))
    planar_rows = check_planar_kernels(gp, dev, *stem_inputs)
    planar_launches, planar_stats = run_planar(gp, jp, engine, sample,
                                               raw_res)
    log("planar: " + json.dumps(planar_stats))
    log("graphs: " + json.dumps(run_graphs(gp, jp, engine.roberta_params,
                                           sample)))
    training, step_launches = run_training(jp, engine.roberta_params,
                                           train_batch)
    long_launches, training["long_clip"] = run_long_clip(engine, jp)
    launches["flash_attention"] = step_launches["flash_attention"]

    rows = {"attn_sublayer": per_clip(sub["attn_sublayer"]),
            "ffn_sublayer": per_clip(sub["ffn_sublayer"]),
            "encoder_stack": per_clip(stack),
            "flash_attention": per_clip(flash, "launches_per_step")}
    where = {
        "attn_sublayer": ("jegal_torch/csrc/fused_layer.cu",
                          "jegal_tpu/ops/pallas/fused_layer.py:104"),
        "ffn_sublayer": ("jegal_torch/csrc/fused_layer.cu",
                         "jegal_tpu/ops/pallas/fused_layer.py:173"),
        "encoder_stack": ("jegal_torch/csrc/encoder_stack.cu",
                          "jegal_tpu/ops/pallas/fused_layer.py:221"),
        "flash_attention": ("jegal_torch/csrc/flash_attention.cu",
                            "jegal_tpu/ops/pallas/flash_attention.py:30"),
    }
    kernels = []
    for name, row in rows.items():
        key = ("launches_per_step" if name == "flash_attention"
               else "launches_per_clip")
        want = sum(r[key] for r in row["per_launch"] or [{key: 1}])
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches on its "
                                 f"path, the timed shapes assume {want}")
        source, replaces = where[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], per_launch=row["per_launch"],
            **({"bound_f32_ms": row["bound_f32_ms"]}
               if "bound_f32_ms" in row else {})))
    # the stems and block 2: launches from the clip whose path takes each
    # (one a clip), times at that clip's entry (the band stem's planar
    # entry under per_launch)
    window = SETTINGS[1][0]
    for name, source, replaces, shapes, got, path in (
            ("stem_band", "jegal_torch/csrc/stem_band.cu",
             "jegal_tpu/ops/pallas/stem.py:219", planar_rows["stem_band"],
             launches, "the raw vta clip (defaults)"),
            ("stem_pool", "jegal_torch/csrc/stem.cu",
             "jegal_tpu/ops/pallas/stem.py:80", [stem],
             planar_launches[f"{window} (raw frames)"],
             f"the raw vta clip ({window})"),
            ("stem_pool_planar", "jegal_torch/csrc/stem.cu",
             "jegal_tpu/ops/pallas/stem.py:80",
             planar_rows["stem_pool_planar"], planar_launches[window],
             f"the planar vta clip ({window})"),
            ("conv2", "jegal_torch/csrc/conv2.cu",
             "jegal_tpu/ops/pallas/conv2.py:76", planar_rows["conv2"],
             launches, "the raw vta clip (defaults)")):
        if got[name] != 1:
            raise AssertionError(f"{name}: {got[name]} launches on {path}, "
                                 f"the timed shapes assume 1")
        row = shapes[0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=got[name],
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            path=path, per_launch=shapes if len(shapes) > 1 else None,
            bound_f32_ms=row["bound_f32_ms"]))
    step_want = sum(r["launches_per_step"] for r in stack)
    if step_launches["encoder_stack"] != step_want:
        raise AssertionError(f"encoder_stack: {step_launches} in a training "
                             f"step, the timed shapes assume {step_want}")
    long_want = sum(r["launches_per_long_clip"] for r in flash)
    if long_launches["flash_attention"] != long_want:
        raise AssertionError(f"flash_attention: {long_launches} on the long "
                             f"clip, the timed shapes assume {long_want}")
    log(json.dumps({"training": training}))
    log(json.dumps({"kernels": kernels}))
    log(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

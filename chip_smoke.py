#!/usr/bin/env python3
"""Build the port's CUDA kernels, drive its `vta` extraction on raw and
planar frames, one clip and in batches, its training, a long clip,
reference-format checkpoints through an engine, forward_validation, the
eval, the CLI's device subcommands and the HTTP server on one card.

    python3 chip_smoke.py             # from the repository root, one CUDA card
    python3 chip_smoke.py --encoders  # phases 1-3's encoder kernels only
    python3 chip_smoke.py --stems     # phases 1-3's and 6a's stem kernels
    python3 chip_smoke.py --profiler  # torch.profiler's window, probed
    python3 chip_smoke.py --cli       # phase 10 (the CLI) alone
    python3 chip_smoke.py --serve     # phase 11 (serving) alone
    python3 chip_smoke.py --bf16      # phase 12 (the bf16 engine) alone
    python3 chip_smoke.py --mesh-cards  # training and inference on meshes
                                        # of 4 cards
    python3 chip_smoke.py [--bf16] --against DIR   # 12a also times kernel
                                      # 1b as checkout DIR builds it

`--encoders` checks and times the attention, FFN and stack kernels as
phase 3 does, with each launch's device kernels, reports what it finds
without holding it to this design's counts, and prints no `ok` line.
`--stems` checks and times both stem kernels on both entries (and block
2) as phases 3 and 6a do, and prints no `ok` line. Both run on an older
tree too (copy this script into its checkout), for a comparison of
designs. `--profiler` profiles a CUDA graph's replay and the same forward
eager, a few hundred times with and without `profiled()`'s idle settle,
logs how often their device kernel counts differ, and prints no `ok`
line. `--cli` runs phase 10 alone on phase 4's weights and engine, and
prints its `cli` line and no `ok` line; `--serve` runs phase 11 alone the
same way and prints its `serve` line; `--bf16` runs phase 12 alone after
phase 4's raw clip and prints its `bf16` and `kernels` lines (the bf16
rows only). `--against DIR` (with no mode or `--bf16`) builds DIR's
jegal_torch/csrc/stem.cu (REPLACED_SOURCES: the kernels this tree
redesigned; another checkout, say the commit before the redesign,
unpacked with `git archive` into a directory that .gitignore lists) and
has 12a time its bf16 entries in turns with this tree's kernel 1b (both
entries) on the same inputs (replaced, new, new, replaced; `replaced_ms`
in their rows), failing if the new kernel is not the faster in both
pairs. `--mesh-cards` (a machine with 4 cards) runs phase 7d's step over
NCCL, one rank a card, at meshes (4, 1), (2, 2) and (1, 4), each against
the one-rank step on card 0 at 7d's bars, then times 20 steps a rank
beside 20 one-rank steps; then data-parallel inference at (4, 1) over
NCCL (phase 7e's code, `run_mesh_cards_infer`): extract_many of 32
planar 5 s clips (batch 16, 4 rows a rank) in float32 and in bf16, every
rank's results bit-equal and within the bars of card 0's one-rank call
(float32 abs 1e-4 and min row cosine 0.99999; bf16 min row cosine
0.9999, tests/bf16_bars.py), clips/s of both (host clock, median of 5
calls in turns), and 48 binary planar `vta` requests from 16 threads
served on one card and at (4, 1) in turns (one, mesh, mesh, one;
requests/s), every answer within the bars of `extract`; and it prints a
`mesh_cards` line (the inference under `infer`) and no `ok` line.

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
    against the port on the CPU, loss and every gradient leaf; (d)
    training on a (data, model) mesh (jegal_torch/parallel/mesh.py), each
    step with every launch counter set to 0 just before and read just
    after, from a fresh AdamW state at gates (1, 1) on (b)'s batch: (i) a
    one-rank NCCL group at mesh (1, 1), whose loss, gradients and
    parameters after the step equal the step's without a group bit for
    bit (both under cuDNN's deterministic algorithms: the audio CNN's
    backward otherwise sums in a varying order), launches stack 1 and
    flash 9; (ii) four child processes of this script (`--mesh-rank`) on
    this card over gloo (NCCL takes one rank a card) at mesh (2, 2), each
    drawing the weights from SEED again (checked by a digest) and stepping
    once: a rank's launches flash 21 (6 gesture, 3 text and XLM-R's 12 on
    the Megatron layer loop) and stack 0, every rank's global loss the
    same, and the loss, the gathered gradient and the parameters after
    the step against the one-rank step (loss rel 1e-5, gradient cosine
    0.9999 and norm rel 1e-5, parameters abs 1e-5 where both gradients
    have one sign and exceed 10 eps, and within 2 lr elsewhere); a rank
    that fails or outlives MESH_TIMEOUT_S fails the phase and every rank
    is killed; then kernel 6 at a (2, 2) rank's shapes (4, 4, 128, 64),
    (4, 4, 32, 96) and (4, 6, 32, 64) against its twin (abs 1e-4) and
    timed as in phase 3;
    7e. data-parallel inference (parallel/mesh.py; phase 6c's eight planar
    clips, batch_size 4): (i) a one-rank NCCL group at mesh (1, 1), whose
    extract_many(mesh=) equals the call without a group bit for bit; (ii)
    two child processes of this script (`--infer-rank`) on this card over
    gloo at (2, 1), each drawing the weights from SEED again (checked by a
    digest): extract_many(mesh=), each rank's replays launching its rows'
    kernels 2, 7, 3, 4 and 5 (per chunk its share of the padded batch:
    band stem and block 2 5 each, attention and FFN 45, stack 3), both
    ranks' results bit-equal and within abs 1e-4 and min row cosine
    0.99999 of the one-rank call; then a two-rank server (rank 0 serves,
    rank 1 follows; batch window 50 ms, batch 4) answering 4 binary
    planar `vta` requests within the same bars of `extract`; a rank that
    fails or outlives INFER_TIMEOUT_S fails the phase;
 8. a long clip: `JegalEngine.extract(modalities="v", visual_feats=...)`
    with T = 1000 (bucket 1024, past the fused gate's 512): 6 flash
    launches and no sublayer launch, and the card against the CPU;
 9. checkpoints, validation and eval, in a temporary directory under
    build/ that is removed afterwards: (a) phase 4's trees (GestSync with
    a seeded audio branch) written in the reference's formats by
    tests/torch_ref_state_dicts.py, the GestSync and JEGAL `.pth`
    ({"state_dict": ...}, `module.` prefixes) and XLM-R base as an HF
    directory (model.safetensors where safetensors imports, else
    pytorch_model.bin), each loaded by jegal_torch.convert.checkpoints
    (MB, seconds) and held to the trees written, leaf for leaf and bit for
    bit, then written to `.npz` and read back the same way; (b) a
    `JegalEngine` built from the loaded trees extracts phase 4's raw `vta`
    clip (launches as phase 4's) within abs 1e-4 and min row cosine
    0.99999 of phase 4's embeddings; (c) `forward_validation` under
    no_grad at phase 7b's training batch: launches (attention 9, FFN 9,
    stack 1, flash 0), card against its CPU run on the same batch
    (L2-normalized rows, the same bars), warm ms (host clock with a
    synchronize, median and quartiles of 20) and one call's device busy
    ms, and on phase 5's small clip card against CPU too; (d) the torch
    log-mel on phase 4's 80,000 samples against the host's numpy copy
    (rtol 2e-4, atol 2e-3), and the audio branch on (1, 80, 500, 1): its
    whole (1, 1024, 1, 13) map against its CPU run, `forward_aud` (the
    first column) timed (CUDA events); (e) phase 6c's eight planar clips,
    each with audio of its own, written by `extract_to_pkl`, the even
    clips with a planted spotting hit, and evaluated on the card by
    retrieval, spotting (each video's predicted frame and score against
    `spot_word`'s, and the hits at its thresholds) and ASD (each clip a
    query, the other seven its negatives), each with the same ranks, hits
    and counts as its numpy path and rates within 1e-6; then
    `compute_metrics_device` on 5,000 seeded 512-d pairs with spread ranks
    (R@1 about 0.2), checked and timed against numpy;
10. the CLI (`jegal_torch.cli.main.main(argv)` in-process, in a temporary
    directory under build/, on phase 4's weights written as in phase 9a),
    each subcommand with every launch counter set to 0 just before and
    read just after: (a) the libav decoder built from
    jegal_torch/host/csrc/decoder.cc, four synthetic 270x480 clips (T 125,
    125, 200, 200) with 16 kHz audio written by `encode_av`, each with its
    .wav and transcript, verify's two 50-frame samples, and the CSV;
    where the card machine has no libav the decoder does not build, and
    `_decode_for_features` is replaced at the host boundary by the numpy
    repack of the same frames (a log line says so); (b) `convert` of the
    .pth files and the HF directory to .npz, leaves bit for bit; (c)
    `infer --modalities vta --profile_dir` on the first clip: launches as
    phase 4's, the .pkl within abs 1e-4 and min row cosine 0.99999 of
    `JegalEngine.extract` on the same planar frames, and the band stem's
    kernel in the trace; (d) `extract-feats --batch_size 4
    --decode_workers 2`: each .npy within the same bars of
    `gestsync_features`, every clip stacked on the card from the decode
    threads' uploads, band stem and block 2 6 launches each (attention and
    FFN 12, the window head's 6 a chunk), wall seconds
    and clips/s, then a run that skips all four; (e) `extract-embs
    --batch_size 4` on those features against `extract_many`, info equal
    to the CSV row; (f) `eval-retrieval`, `eval-spotting` and `eval-asd`
    with and without `--on_device`: equal counts and ranks, rates within
    1e-6; (g) `verify` on goldens the engine wrote: exit 0, and exit 1
    with one golden row negated; (h) `warmup` at the main path's buckets;
    (i) `train --steps 3` on phase 7a's corpus: a finite loss, stack 3 and
    flash 27 launches;
11. serving (jegal_torch/serving.py), on phase 4's weights: (a) `python
    -m jegal_torch serve --port 0 --warmup_combos vta,ta --warmup_frames
    planar --batch_window_ms 5 --max_batch 8` in a child process on phase
    9's reference-format files (its tokenizer file resolving to
    PieceTokenizer, as in phase 10): the first line's URL, /healthz, a
    JSON `ta`, a binary planar `vta` and a binary raw `vta` request (the
    raw frames repacked by the C++ repack, host/csrc/repack.cc, in the
    server), each within abs 1e-4 and min row cosine 0.99999 of
    `JegalEngine.extract` on the same sample, a 422 sample and a 400
    frames shape, /healthz's graph count unchanged by them (they fall in
    the buckets serve warms), then the server stopped; (b) in-process, a
    new engine warmed by the same `serving.warmup` call (T 128, S 64, W
    16, mel 512, batch 8; the MiB each capture adds) behind
    `create_server` with the batcher, decode_binary and the repack first
    timed alone on one clip: 80 binary `vta` clips (T 100 and 125, every
    fifth raw frames) then 128 JSON `ta` requests from 8 threads of a
    client process, once with every graph replay recorded (requests/s,
    p50, p99 and max ms, the batch sizes the batcher formed, the host ms
    in decode_binary and the repack a request) and once profiled (the
    device busy ms and idle share over each kind's window): every launch
    counter stays 0 and the engine's graphs do not grow (no capture
    inside a request), the replayed graphs launch kernels 2, 7, 3, 4 and
    5, and every answer equals `extract` at the bars above; (c) a
    200-frame clip (T bucket 256, not warmed) sent while 7 client threads
    are mid-request: it captures one graph and answers within the bars,
    and so do the others; 8 more such clips then replay it, capturing
    nothing;
12. the bf16 engine (`JegalEngine(dtype=torch.bfloat16)`): (a) the bf16
    variants of kernels 2 and 1 (both entries each, at phase 3's T = 128
    bucket), 7 (on the band stem's bf16 output), 3 and 4 (phase 3's three
    shapes), 5 (the clip's 32 XLM-R rows and an extract_many chunk's 128,
    each launch's device kernels counted) and 6 (the bf16 long clip's (1,
    8, 1024, 64) with 1000 valid keys, and a text shape at head width 96,
    (8, 8, 128, 96)), each against its bf16 twin (2 bf16 ulps an
    element, 4 for the 12-layer stack, min row cosine 0.9999:
    tests/bf16_bars.py) and against its float32 kernel on the same bf16
    values (min row cosine 0.9999), two launches bit-identical, registers
    and spills (2b, 6b and 7b: none, and a block an SM), then timed (CUDA
    events, median of 20) beside the float32
    kernel, the twin and one bf16 PyTorch call chain (for kernel 6 bf16
    SDPA with an additive -1e9 mask), with the bf16 bound
    (bytes at 3.35 TB/s, or operations at 989 TFLOP/s dense bf16); (b) a
    bf16 and a new float32 engine side by side: phase 4's raw clip (the
    first call captures: launches band stem, block 2, attention 15, FFN
    15 and stack 1, all bf16, and the MiB the capture adds; the replay
    against an eager run bit for bit) and its planar frames, held to the
    float32 engine (min row cosine 0.9995), warm ms/clip in turns (float32,
    bf16, bf16, float32), profiles (device busy, the median of 5 replays
    with their spread, idle share) and the
    host's time by step; `extract_many` over phase 6c's eight planar clips
    (launches, capture MiB, clips/s, a profile), each bf16 result held to
    the float32 one; a served load (after `serving.warmup` as `serve`
    runs it: 16 binary planar `vta` and 16 JSON `ta` requests from 4
    threads; requests/s, device busy and idle share; no capture inside a
    request; every bf16 answer float32 on the wire and held to the float32
    engine's `extract`); phase 5's small clip, the bf16 engine on the
    card against the bf16 engine on the CPU (min row cosine 0.999); a
    bf16 engine with stem_impl="window" on phase 4's raw and planar clip
    (kernel 1b's entry launched once a clip in place of 2b, the raw
    clip's replay against an eager run), held to the float32 engine and
    to the bf16 band engine (0.9995), and 1b's pooled output on the clip
    equal to 2b's bit for bit on both entries; and phase 8's 1000-frame clip
    through the bf16 engine (kernel 6b 6 launches, the replay against an
    eager run, warm ms beside the float32 engine's in turns), held to the
    float32 engine (0.9995) and to a bf16 engine on the CPU (0.999);
13. a `training` JSON line (with phase 7d under `mesh`), an `infer_mesh`
    JSON line (phase 7e), a `checkpoints`
    JSON line, a `cli` JSON line
    (each subcommand's wall seconds and launches, whether the decoder was
    real), a `serve` JSON line, a `bf16` JSON line, one `kernels` JSON
    line (the bf16 variants' rows after the float32 kernels'), the card
    line, and last the `ok` JSON line.

In the `kernels` line, the attention, FFN and stack rows are per clip:
each shape's per-launch time times the launches a T=125 `vta` clip makes at
that shape (6 layers in the window head, 6 in the gesture encoder, 3 in the
text encoder, one XLM-R stack), with each shape's own numbers under
`per_launch` (a shape with 0 launches per clip is checked and timed, and
adds nothing). `launches` is the count from phase 4, and
`launches_validation` that of one forward_validation (phase 9c),
`launches_cli` each CLI subcommand's (phase 10), and `launches_serve` the
launches of the graphs phase 11b's served batches replayed. The flash
attention row is per training step in the same way (6 gesture and 3 text
launches); its `launches` is the count of one step of phase 7(b), and its
long-clip shape, 0 launches a step, carries its 6 launches a clip from
phase 8. The flash attention and stack rows carry a rank's launches in a
step at each mesh of phase 7d (`launches_mesh`), and the flash row phase
7d's (2, 2) shapes (`mesh_shapes`). Every float32 row carries a (2, 1)
rank's launches in phase 7e's extract_many call (`launches_mesh_infer`). The
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
The bf16 rows (`dtype` bfloat16) take their launches from phase 12b: the
band stem, block 2, attention, FFN and stack from the bf16 engine's raw
clip, the window stem's float and planar entries (`stem_pool_bf16`,
`stem_pool_planar_bf16`) from the window engine's raw and planar clip,
and the flash attention from the bf16 long clip, whose time it sums
(`launches_per_clip` of each timed shape, 6 at the long clip's), and each
bf16 row its bound share (`bound_share`, bound_ms / ms). The bf16
attention and FFN rows' per-shape rows also carry each launch's split
(12a, torch.profiler after an L2 flush): its device operations, each
product's plan (gemm_plan.plan_bf16), device ms and bound share, the
bf16 attention core's and the row passes' device ms. A bf16 row whose
design is its own, not the float32 kernel's on bf16 rows, says so
(`design`).

Weights are random, drawn from a seeded torch.Generator with randomized
BatchNorm statistics and LayerNorm parameters; nothing is downloaded. The
real xlm-roberta-base vocabulary is not here, and the card machine has no
`tokenizers` wheel, so the text is tokenized by `PieceTokenizer` below, a
backend with the duck-typed interface of jegal_torch.text.WordTokenizer.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
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

    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
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

def stem_frames(dev):
    """Phase 3's stem input: 128 random 270x480 frames (uint8) and their
    chin rows, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    u8 = torch.from_numpy(rng.integers(0, 256, (128, 270, 480, 3),
                                       dtype=np.uint8)).to(dev)
    chin = torch.from_numpy(rng.integers(90, 200, 128)).to(dev)
    return u8, chin


def check_stem(gp, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from jegal_torch.core.layers import f32_convs
    from jegal_torch.ops.kernels import stem as S
    from jegal_torch.ops.video import mask_frames_device

    u8, chin = stem_frames(dev)
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


def flash_rows(dev, g, shapes):
    """The flash attention kernel at each (label, (B, H, T, D), valid keys,
    launch counts or None) of `shapes`: random q, k, v from `g` with the
    first `valid` keys of every batch row valid and the last batch row
    fully masked (B > 1), forward against its twin and relaunched
    bit-identical; then, where launch counts are given, timed beside its
    twin, SDPA and its 3xTF32 bound -> those rows."""
    import torch

    from jegal_torch.ops.kernels import flash_attention as FA

    rows = []
    for label, (b, h, t, d), valid, launches in shapes:
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
        if launches is None:
            continue
        # products only: the softmax's few operations a score add < 2 %
        b_ms, b_by, f32_ms = bound_3xtf32(4.0 * b * h * t * t * d,
                                          4.0 * (4 * b * h * t * d + b * t))
        row = dict(shape=label, **launches, ms=cuda_ms(kern),
                   plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(lambda: _library_flash(q, k, v, mask)),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                   max_abs_err=err)
        rows.append(row)
        log(f"  flash_attention ms {row['ms']:.4f} plain "
            f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
            f"{b_ms:.4f} ({b_by}, 3xTF32; float32 {f32_ms:.4f})")
    return rows


def check_flash(dev):
    """The flash attention kernel at the training step's two shapes and
    the long clip's, forward against its twin and timed, and at a ragged
    (2, 3, 100, 96), checked only; then one backward through
    FlashAttention against the twin's autograd."""
    import torch

    from jegal_torch.ops.kernels import flash_attention as FA

    g = torch.Generator().manual_seed(SEED + 6)
    rows = flash_rows(dev, g, (
        ("gesture encoder, training (8, 8, 128, 64)", (8, 8, 128, 64),
         100, dict(launches_per_step=6, launches_per_long_clip=0)),
        ("text encoder, training (8, 8, 32, 96)", (8, 8, 32, 96), 21,
         dict(launches_per_step=3, launches_per_long_clip=0)),
        ("gesture encoder, long clip (1, 8, 1024, 64)",
         (1, 8, 1024, 64), 1000,
         dict(launches_per_step=0, launches_per_long_clip=6)),
        ("ragged (2, 3, 100, 96), untimed", (2, 3, 100, 96), 77, None)))

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


# host seconds the profiler's window is held open, idle, before and after
# the profiled work: torch.profiler keeps only device events whose time,
# mapped onto the host clock, falls inside the window, and a kernel that
# starts within microseconds of the window's opening can be mapped before
# it and dropped (a replay against an eager run once counted the eager
# run's first 14 kernels, its BatchNorm folds, as missing; `--profiler`
# measures how often). 10 ms held in a short run; in the whole script's
# process, past phases 7-11, a 10 ms window lost a replay's first 13
# kernels and, in two runs, all of a sublayer launch's, so the window is
# held 50 ms
PROFILE_SETTLE_S = 0.05
# the 50 ms did not stop it: late in a whole run an eager run under the
# window still lost its first kernel of each of several kinds (the replay
# it was held against kept them). What the profiler loses is the first
# stretch of the window's device work, up to ~36 ms of it late in a whole
# run on the H100, however long the window has been open. So each window
# opens on a lead-in of spin kernels (torch.cuda._sleep's) of LEAD_IN_MS
# each, run to completion before the profiled work starts: the loss falls
# on them, and the event readers (`window_events`) leave them out and log
# how many were lost. The lead-in is LEAD_IN_KERNELS spins plus the most
# the profiler has lost of one so far (PROFILER_LOST), so its headroom
# does not shrink as the loss grows. A window that kept none of them may
# have lost the work's first kernels too: `device_kernels` (the
# replay-vs-eager check's counts) then profiles the call again, up to
# PROFILE_TRIES windows.
LEAD_IN_KERNELS = 64
LEAD_IN_MS = 2.0
LEAD_IN_NAME = "spin_kernel"
PROFILE_TRIES = 3
PROFILER_LOST = [0]


@contextlib.contextmanager
def profiled(settle: float = PROFILE_SETTLE_S):
    """torch.profiler over the body, CPU and CUDA activity, with the
    device idle for `settle` s at each end of the window and the lead-in
    (LEAD_IN_KERNELS + PROFILER_LOST spin kernels of LEAD_IN_MS,
    finished) before the body; the body must leave its work
    synchronized. Yields the profiler.
    The garbage collector runs first: a collection inside the window frees
    dead graphs, events and pinned buffers there (a bf16 replay, profiled
    just after a capture that ran with the collector off, twice lost its
    first 11-13 kernels; alone it never did)."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    device_sleep(0)                     # calibrated outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof.lead_in = LEAD_IN_KERNELS + PROFILER_LOST[0]
        time.sleep(settle)
        for _ in range(prof.lead_in):
            device_sleep(LEAD_IN_MS)
        torch.cuda.synchronize()
        time.sleep(settle)
        yield prof
        torch.cuda.synchronize()
        time.sleep(settle)


def profiler_window(pairs: int = 200) -> None:
    """`--profiler`: `replay_check`'s two profiles (a graph's replay, then
    the same forward eager: two BatchNorm-style folds of 7 kernels, then
    100 matmul layers), `pairs` times with no settle and `pairs` times
    with PROFILE_SETTLE_S, interleaved; logs how often the two device
    kernel counts differ. Raises if they differ under the settle."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    var = torch.rand(64, device=dev, generator=g) + 0.5
    w = torch.randn(512, 512, device=dev, generator=g) / 512 ** 0.5
    x = torch.randn(256, 512, device=dev, generator=g)

    def fn():
        folds = [var * torch.rsqrt(var + 1e-5) for _ in range(2)]
        folds = [(var - var * f) + var * f for f in folds]
        y = x
        for _ in range(100):
            y = torch.relu(y @ w) + y
        return y + folds[0].sum() + folds[1].sum()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()

    def n_kernels(f, settle):
        with profiled(settle) as prof:
            f()
        return len(device_events(prof))

    seen = {0.0: {}, PROFILE_SETTLE_S: {}}
    for i in range(2 * pairs):
        settle = PROFILE_SETTLE_S if i % 2 else 0.0
        key = (n_kernels(graph.replay, settle), n_kernels(fn, settle))
        seen[settle][key] = seen[settle].get(key, 0) + 1
    for settle, got in seen.items():
        differ = sum(n for (r, e), n in got.items() if r != e)
        log(f"profiler window, settle {settle} s: replay and eager kernel "
            f"counts differ in {differ} of {pairs} pairs; (replay, eager) "
            f"counts {got}")
    if any(r != e for r, e in seen[PROFILE_SETTLE_S]):
        raise AssertionError("the profiler lost device events under the "
                             "settle")


def lead_in_split(prof):
    """A `profiled()` window's device events in launch order -> (how many
    of its lead-in kernels the profiler lost, the events after them).
    A user annotation on the device timeline (the optimizer's
    "Optimizer.step#AdamW.step") spans kernels counted on their own, and
    is left out."""
    import torch

    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    lead = 0
    while lead < len(events) and LEAD_IN_NAME in events[lead].name:
        lead += 1
    lost = getattr(prof, "lead_in", LEAD_IN_KERNELS) - lead
    PROFILER_LOST[0] = max(PROFILER_LOST[0], lost)
    return lost, events[lead:]


def window_events(prof):
    """The device events of a `profiled()` window after its lead-in; a
    lead-in the profiler lost kernels of is logged."""
    lost, events = lead_in_split(prof)
    if lost:
        log(f"  profiler window: lost {lost} of its {prof.lead_in} lead-in "
            f"kernels")
    return events


def device_events(prof):
    """(name, us) of each device kernel of a `profiled()` window, in
    launch order (`window_events`)."""
    return [(e.name, e.time_range.elapsed_us()) for e in window_events(prof)]


# the attention core's device kernel: this design's, and the FFMA kernel it
# replaced, so that a breakdown of the parent tree (`--encoders`) reads too
CORE_NAMES = ("attention_core", "segment_attention")


def is_core(name: str) -> bool:
    return any(c in name for c in CORE_NAMES)


def profile_run(fn, what: str):
    """Device time of one call of `fn` by kernel name (torch.profiler); `fn`
    must end in a host fetch or a synchronize. Also the attention core's
    device ms and the split-K reductions' launches in the call."""
    with profiled() as prof:
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
    name: in a graph the profiler sees them as "Unknown". A graph may also
    run a device-to-device memcpy node as a copy kernel (`memcpy32_post`,
    seen in a bf16 replay where the eager run made a "Memcpy DtoD"): it
    counts as that memcpy. A window that kept none of its lead-in may
    have lost the call's first kernels too: the call is profiled again,
    up to PROFILE_TRIES windows in all."""
    import torch

    for attempt in range(1, PROFILE_TRIES + 1):
        with profiled() as prof:
            result = fn()
            torch.cuda.synchronize()
        lost, events = lead_in_split(prof)
        if lost:
            log(f"  profiler window: lost {lost} of its {prof.lead_in} "
                f"lead-in kernels (window {attempt} of {PROFILE_TRIES})")
        if lost < prof.lead_in:
            break
    counts: dict = {}
    for e in events:
        name = e.name
        if name.startswith("memcpy32_post"):
            name = "Memcpy DtoD"
        if name.startswith(("Memset", "Memcpy")):
            name = name.split(" (")[0]
        counts[name] = counts.get(name, 0) + 1
    return result, counts


def replay_check(engine, what: str, xlmr_layers: int = 12,
                 bf16: bool = False):
    """The graph of the engine's last call, against an eager run of its
    forward on the same static inputs: the outputs bit for bit, and the
    device kernels of one profiled replay by name and count against the
    eager run's and against the launches recorded at its capture (each
    counter's kernel as often as counted; a bf16 engine's by the bf16
    counters)."""
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
    sfx = "_bf16" if bf16 else ""
    for k, parts in (SIGNATURES_BF16 if bf16 else SIGNATURES).items():
        want = entry.launches[k]
        if k == "attn_sublayer" + sfx:
            want += xlmr_layers * entry.launches["encoder_stack" + sfx]
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


def many_launches(samples, batch_size: int, kw: dict, dp: int = 1):
    """The launches extract_many must make (a rank's, with its batch over
    `dp` data ranks: each chunk's padded batch rounded up to a multiple of
    dp, the rank's share of it): per chunk (of one T bucket) one tower
    launch per padded clip and 160-frame piece, and one JEGAL forward (15
    attention and FFN sublayers, one XLM-R stack)."""
    from jegal_torch.data.bucketing import T_BUCKETS, batch_ladder, next_bucket

    groups: dict = {}
    for s in samples:
        b = next_bucket(s["frames"].shape[0], T_BUCKETS)
        groups[b] = groups.get(b, 0) + 1
    tower = chunks = 0
    for bucket, n in groups.items():
        pieces = -(-(bucket + 20) // 160)
        for lo in range(0, n, batch_size):
            b = batch_ladder(min(batch_size, n - lo), batch_size)
            tower += -(-b // dp) * pieces
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


# ---------------------------------------------------------------------------
# Phase 7d: training on a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_RANKS, MESH_MODEL = 4, 2          # the (2, 2) mesh of phase 7d(ii)
MESH_TIMEOUT_S = 420
MESH_LR, MESH_WEIGHT_DECAY = 1e-4, 1e-2
# A sharded step against one rank (tests/test_torch_training_mesh.py's
# bars): the loss within rel 1e-5; the gathered gradient's cosine >= 0.9999
# and its norm within rel 1e-5; the parameters after one AdamW step within
# abs 1e-5 where both runs' gradients have one sign and are at least 10 eps
# in size, and every element within 2 lr. (AdamW's first step moves an
# element by lr g / (|g| + 1e-8), about lr times the sign of g: where the
# two gradients differ in sign or one is near 0, rounding decides it.)
MESH_RESOLVED_GRAD = 1e-7
MESH_PARAM_ATOL = 1e-5
# kernel 6 at a (2, 2) rank's shapes (B 8 / 2, heads / 2) and its launches
# a step: the gesture encoder's 6 layers, the text encoder's 3, XLM-R's 12
MESH_FLASH_SHAPES = (
    ("gesture encoder, (2, 2) rank (4, 4, 128, 64)", (4, 4, 128, 64), 100,
     dict(launches_per_rank_step=6)),
    ("text encoder, (2, 2) rank (4, 4, 32, 96)", (4, 4, 32, 96), 21,
     dict(launches_per_rank_step=3)),
    ("XLM-R, (2, 2) rank (4, 6, 32, 64)", (4, 6, 32, 64), 21,
     dict(launches_per_rank_step=12)))


def mesh_step(jp, rp, batch, mesh):
    """One training step of `jp` at gates (1, 1) on `mesh` (None: one rank,
    phase 7b's path), each from a fresh AdamW state: -> dict(loss,
    step_loss, grads and params (whole leaves: the gradient of the loss,
    the parameters after the step), launches (the step's kernel
    launches))."""
    import torch

    from jegal_torch.models.roberta import XLMR_BASE
    from jegal_torch.ops.kernels import _build
    from jegal_torch.parallel import mesh as M
    from jegal_torch.training import trainer as TR

    def fresh():
        opt = TR.make_optimizer(lr=MESH_LR, weight_decay=MESH_WEIGHT_DECAY)
        state = TR.init_state(jp, opt)
        if mesh is None:
            return state, rp, batch, opt
        return (*TR.shard_training(mesh, state, rp, batch), opt)

    state, rps, b, _ = fresh()
    loss, grads = TR.loss_and_grads(state.params, rps, b, (1.0, 1.0),
                                    XLMR_BASE, mesh=mesh)
    del state
    state, rps, b, opt = fresh()
    torch.cuda.synchronize()
    _build.reset_launches()
    state, step_loss = TR.make_train_step(opt, XLMR_BASE, mesh=mesh)(
        state, b, (1.0, 1.0), rps)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    params = [p.detach() for p in TR.param_leaves(state.params)]
    if mesh is not None:
        specs = M.spec_leaves(TR.param_spec(state.params))
        grads = M.gather_leaves(grads, specs, mesh)
        params = M.gather_leaves(params, specs, mesh)
    return dict(loss=loss.item(), step_loss=step_loss.item(), grads=grads,
                params=params, launches=launches)


def smoke_weights(dev):
    """main()'s GestSync, JEGAL and XLM-R trees, drawn again from SEED in
    main()'s order."""
    import torch

    from jegal_torch.convert import (
        init_gestsync_params,
        init_jegal_params,
        init_roberta_params,
    )

    g = torch.Generator().manual_seed(SEED)
    gp = init_gestsync_params(g, dev)
    return gp, init_jegal_params(g, dev), init_roberta_params(g, device=dev)


def weights_digest(jp, rp) -> list:
    """A few sums that tell two draws of the trees apart."""
    return [float(jp["proj_op_rgb"]["kernel"].double().sum()),
            float(jp["encoder_text"]["layers"][2]["ff"]["w2"]["kernel"]
                  .double().sum()),
            float(rp["embeddings"]["word"][-1000:].double().sum()),
            float(rp["layers"][11]["out"]["kernel"].double().sum())]


def mesh_step_ms(jp, rp, batch, mesh, reps: int):
    """Host ms of `reps` warm training steps at gates (1, 1) on `mesh`
    (None: one rank), each ending in a synchronize, after 3 untimed ones
    -> (median, first quartile, third quartile)."""
    import torch

    from jegal_torch.models.roberta import XLMR_BASE
    from jegal_torch.training import trainer as TR

    opt = TR.make_optimizer(lr=MESH_LR, weight_decay=MESH_WEIGHT_DECAY)
    state, rps, b = TR.init_state(jp, opt), rp, batch
    if mesh is not None:
        state, rps, b = TR.shard_training(mesh, state, rp, batch)
    step = TR.make_train_step(opt, XLMR_BASE, mesh=mesh)
    walls = []
    for i in range(reps + 3):
        t0 = time.perf_counter()
        state, _ = step(state, b, (1.0, 1.0), rps)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(1e3 * (time.perf_counter() - t0))
    q1, med, q3 = statistics.quantiles(walls, n=4)
    return med, q1, q3


def mesh_rank_main(argv) -> int:
    """A rank started by `run_mesh_ranks` as `chip_smoke.py --mesh-rank
    RANK WORLD MODEL INIT_FILE OUT_DIR BACKEND REPS`: joins the BACKEND
    group (its card LOCAL_RANK's), steps once on the (WORLD / MODEL,
    MODEL) mesh, then times REPS more steps (none for 0), and writes what
    it found under OUT_DIR."""
    import torch

    rank, world, model = (int(x) for x in argv[:3])
    init, out, backend, reps = argv[3], Path(argv[4]), argv[5], int(argv[6])
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from jegal_torch.models import roberta as R
    from jegal_torch.parallel import mesh as M

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    M.initialize_distributed(backend=backend, device="cuda",
                             init_method=f"file://{init}", rank=rank,
                             world_size=world)
    mesh = M.make_mesh(world, model)
    dev = torch.device("cuda", torch.cuda.current_device())
    _, jp, rp = smoke_weights(dev)
    if model == 1:          # XLM-R on the stack kernel, as loop.train has it
        rp = R.stack_layers(rp)
    batch = {k: v.to(dev) for k, v in fixed_batch(word_tokenizer()).items()}
    res = mesh_step(jp, rp, batch, mesh)
    if rank == 0:
        torch.save({k: res[k] for k in ("grads", "params")},
                   out / "rank0.pt")
    timed = mesh_step_ms(jp, rp, batch, mesh, reps) if reps else None
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, coordinate=list(mesh.get_coordinate()),
        backend=dist.get_backend(), card=str(dev), loss=res["loss"],
        step_loss=res["step_loss"], launches=res["launches"],
        digest=weights_digest(jp, rp), step_ms=timed,
        wall_s=time.perf_counter() - t0)))
    dist.destroy_process_group()
    return 0


def mesh_compare(got, want, what: str) -> dict:
    """A sharded step's loss, gradient and parameters against one rank's
    (MESH_* bars); raises if one fails."""
    import torch

    def flat(leaves):
        return torch.cat([x.reshape(-1) for x in leaves]).double()

    a, b = flat(got["grads"]), flat(want["grads"])
    cos = float(a @ b / (a.norm() * b.norm()))
    norm_rel = float((a.norm() - b.norm()).abs() / b.norm())
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    resolved = (torch.sign(a) == torch.sign(b)) & (
        torch.minimum(a.abs(), b.abs()) >= MESH_RESOLVED_GRAD)
    del a, b
    diff = (flat(got["params"]) - flat(want["params"])).abs()
    res = dict(loss=got["loss"], loss_one_rank=want["loss"],
               loss_rel_err=loss_rel, grad_cos=cos, grad_norm_rel_err=norm_rel,
               params_max_abs_resolved=float(diff[resolved].max()),
               params_resolved=int(resolved.sum()),
               params_over=int((diff > MESH_PARAM_ATOL).sum()),
               params_max_abs=float(diff.max()), elements=diff.numel())
    ok = (loss_rel <= TRAIN_LOSS_RTOL and cos >= TRAIN_GRAD_MIN_COS
          and norm_rel <= TRAIN_LOSS_RTOL
          and res["params_max_abs_resolved"] <= MESH_PARAM_ATOL
          and res["params_max_abs"] <= 2 * MESH_LR)
    log(f"  {what} against one rank: loss {got['loss']:.7f} vs "
        f"{want['loss']:.7f} (rel {loss_rel:.3e}); gradient cosine "
        f"{cos:.10f}, norm rel {norm_rel:.3e}; parameters after one AdamW "
        f"step max abs {res['params_max_abs_resolved']:.3e} over the "
        f"{res['params_resolved']} elements whose gradients resolve the "
        f"step; {res['params_over']} of {res['elements']} elements over "
        f"{MESH_PARAM_ATOL:g} (max {res['params_max_abs']:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the sharded step disagrees with one "
                             f"rank: {res}")
    return res


def run_children(tmp: Path, flag: str, world: int, cards: int,
                 timeout: float, args_of):
    """`world` child processes `chip_smoke.py FLAG *args_of(rank)`, rank r
    on card r % cards (LOCAL_RANK), each logging to tmp/rank<r>.log; a rank
    that fails or outlives `timeout` seconds raises, and every rank is
    killed."""
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                 *args_of(r)], stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                env=dict(os.environ, LOCAL_RANK=str(r % cards))))
    try:
        for r, p in enumerate(procs):
            left = timeout - (time.perf_counter() - t0)
            if p.wait(timeout=max(left, 1.0)) != 0:
                tail = (tmp / f"rank{r}.log").read_text()[-3000:]
                raise AssertionError(f"{flag} {r} exited {p.returncode}:\n"
                                     f"{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_mesh_ranks(tmp: Path, want, digest, dp: int, mp: int,
                   backend: str, cards: int, reps: int) -> dict:
    """dp * mp child ranks (`--mesh-rank`) over `backend`, rank r on card r
    % cards, one step each on the (dp, mp) mesh against the one-rank step
    `want` (mesh_step) and its weights' `digest`, then `reps` timed steps:
    a rank's launches (kernels 5 and 6 as one rank's at mp 1; else kernel 6
    alone, 21), every rank's global loss equal, and mesh_compare's bars. A
    rank that fails or outlives MESH_TIMEOUT_S fails the phase, and every
    rank is killed. -> the stats."""
    import torch

    world = dp * mp
    t0 = time.perf_counter()
    run_children(tmp, "--mesh-rank", world, cards, MESH_TIMEOUT_S,
                 lambda r: [str(r), str(world), str(mp), str(tmp / "pg"),
                            str(tmp), backend, str(reps)])
    wall = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)]
    per_rank = want["launches"] if mp == 1 else counts(flash_attention=sum(
        x["launches_per_rank_step"] for _, _, _, x in MESH_FLASH_SHAPES))
    for x in ranks:
        log(f"  rank {x['rank']} at {x['coordinate']} ({x['backend']}, "
            f"{x['card']}): loss {x['loss']:.7f}, launches "
            f"{ {k: n for k, n in x['launches'].items() if n} }, "
            f"{x['wall_s']:.1f} s"
            + ("" if x["step_ms"] is None else
               f", step {x['step_ms'][0]:.3f} ms (quartiles "
               f"{x['step_ms'][1]:.3f} / {x['step_ms'][2]:.3f})"))
        if x["digest"] != digest:
            raise AssertionError(f"mesh rank {x['rank']} drew other "
                                 f"weights: {x['digest']} vs {digest}")
        if x["launches"] != per_rank:
            raise AssertionError(f"mesh rank {x['rank']}: launches "
                                 f"{x['launches']}, want {per_rank}")
        if x["loss"] != ranks[0]["loss"]:
            raise AssertionError("the ranks' global losses differ")
    sharded = torch.load(tmp / "rank0.pt", map_location="cuda")
    res = mesh_compare(dict(sharded, loss=ranks[0]["loss"]), want,
                       f"the ({dp}, {mp}) mesh's step")
    return dict(backend=ranks[0]["backend"], ranks=world,
                cards=sorted({x["card"] for x in ranks}),
                launches_per_rank=ranks[0]["launches"], wall_s=wall,
                rank_wall_s=[x["wall_s"] for x in ranks],
                step_ms=[x["step_ms"] for x in ranks], **res)


def run_mesh_training(jp, rp, batch):
    """Phase 7d: (i) a one-rank NCCL group at mesh (1, 1), whose step must
    equal phase 7b's path (no group) bit for bit; (ii) MESH_RANKS child
    processes on this card over gloo at the (2, 2) mesh, one step each,
    against the one-rank step; then kernel 6 at a (2, 2) rank's shapes
    against its twin. -> (the phase's stats, kernel 6's rows)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from jegal_torch.parallel import mesh as M

    dev_batch = {k: v.cuda() for k, v in batch.items()}
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        log("training on a mesh: (i) one NCCL rank at mesh (1, 1) against "
            "no group, phase 7b's batch, with cuDNN's deterministic "
            "algorithms (the audio CNN's backward otherwise sums in an "
            "order that varies from run to run)")
        torch.backends.cudnn.deterministic = True
        try:
            M.initialize_distributed(device="cuda",
                                     init_method=f"file://{tmp}/pg1", rank=0,
                                     world_size=1)
            try:
                got = mesh_step(jp, rp, dev_batch, M.make_mesh(1, 1))
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
            want = mesh_step(jp, rp, dev_batch, None)
        finally:
            torch.backends.cudnn.deterministic = False
        same = (got["loss"] == want["loss"]
                and got["step_loss"] == want["step_loss"]
                and all(torch.equal(x, y) for x, y in
                        zip(got["grads"] + got["params"],
                            want["grads"] + want["params"])))
        log(f"  backend {backend}: loss {got['loss']:.7f}, gradients and "
            f"parameters after the step "
            f"{'bit-equal' if same else 'DIFFER'}; launches "
            f"{got['launches']} (no group: {want['launches']})")
        one_launches = counts(encoder_stack=1, flash_attention=9)
        if not same or got["launches"] != one_launches \
                or want["launches"] != one_launches:
            raise AssertionError("the (1, 1) mesh's step differs from the "
                                 "step without a group")
        out["1x1"] = dict(backend=backend, bit_equal=same,
                          launches=got["launches"])

        dp = MESH_RANKS // MESH_MODEL
        log(f"training on a mesh: (ii) {MESH_RANKS} ranks on this card over "
            f"gloo at mesh ({dp}, {MESH_MODEL}), one step each (a check of "
            f"the sharded path; one card, so no multi-GPU speed)")
        out[f"{dp}x{MESH_MODEL}"] = run_mesh_ranks(
            tmp / "ranks", want, weights_digest(jp, rp), dp, MESH_MODEL,
            "gloo", cards=1, reps=0)
    g = torch.Generator().manual_seed(SEED + 12)
    rows = flash_rows(torch.device("cuda"), g, MESH_FLASH_SHAPES)
    return out, rows


MESH_CARD_MESHES = ((4, 1), (2, 2), (1, 4))
MESH_CARD_REPS = 20


def run_mesh_cards(jp, rp, batch) -> dict:
    """`--mesh-cards`: training on (data, model) meshes of this machine's
    cards over NCCL, one rank a card: at each of MESH_CARD_MESHES a step
    against the one-rank step on card 0 (run_mesh_ranks's checks), then
    MESH_CARD_REPS timed steps a rank, beside MESH_CARD_REPS one-rank steps
    on card 0 timed first (host clock, each step ending in a
    synchronize). rp: XLM-R with its stack operands."""
    import tempfile

    import torch

    n = torch.cuda.device_count()
    world = max(dp * mp for dp, mp in MESH_CARD_MESHES)
    if n < world:
        raise AssertionError(f"--mesh-cards needs {world} cards, found {n}")
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    want = mesh_step(jp, rp, dev_batch, None)
    med, q1, q3 = mesh_step_ms(jp, rp, dev_batch, None, MESH_CARD_REPS)
    log(f"one rank on card 0: step {med:.3f} ms (median of "
        f"{MESH_CARD_REPS}, quartiles {q1:.3f} / {q3:.3f}), launches "
        f"{ {k: v for k, v in want['launches'].items() if v} }")
    out = {"cards": n, "one_rank": dict(step_ms=[med, q1, q3],
                                        launches=want["launches"])}
    digest = weights_digest(jp, rp)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for dp, mp in MESH_CARD_MESHES:
            log(f"training on a mesh of cards: ({dp}, {mp}) over NCCL, one "
                f"rank a card")
            out[f"{dp}x{mp}"] = run_mesh_ranks(
                Path(tmp) / f"{dp}x{mp}", want, digest, dp, mp, "nccl",
                cards=n, reps=MESH_CARD_REPS)
    return out


# ---------------------------------------------------------------------------
# Phase 7e: data-parallel inference on a mesh
# ---------------------------------------------------------------------------

INFER_RANKS = 2               # (ii): gloo ranks on this card at (2, 1)
INFER_TIMEOUT_S = 300
INFER_REQUESTS = 4
INFER_WINDOW_MS = 50
# --mesh-cards: 32 planar 5 s clips at (4, 1), batch 16 (4 rows a rank)
CARDS_CLIPS, CARDS_BATCH, CARDS_REPS = 32, 16, 5
CARDS_REQUESTS, CARDS_THREADS = 48, 16


def gestsync_digest(gp) -> list:
    return [float(gp["net_vid"][0]["conv"]["kernel"].double().sum()),
            float(gp["transformer"]["layers"][5]["ff"]["w2"]["kernel"]
                  .double().sum())]


def infer_rank_main(argv) -> int:
    """A rank started by `run_infer_ranks` as `chip_smoke.py --infer-rank
    RANK WORLD INIT_FILE OUT_DIR BACKEND MODE`: joins the BACKEND group (its
    card LOCAL_RANK's) at the (WORLD, 1) mesh, draws main()'s weights, and
    runs MODE's collective calls ("card": phase 7e(ii); "cards": the
    `--mesh-cards` inference), writing what it found under OUT_DIR."""
    import pickle

    import torch

    rank, world = int(argv[0]), int(argv[1])
    init, out, backend, mode = argv[2], Path(argv[3]), argv[4], argv[5]
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from jegal_torch.parallel import mesh as M

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    M.initialize_distributed(backend=backend, device="cuda",
                             init_method=f"file://{init}", rank=rank,
                             world_size=world)
    mesh = M.make_mesh(world, 1)
    dev = torch.device("cuda", torch.cuda.current_device())
    gp, jp, rp = smoke_weights(dev)
    res = dict(rank=rank, card=str(dev), backend=dist.get_backend(),
               digest=gestsync_digest(gp) + weights_digest(jp, rp))
    run = infer_card if mode == "card" else infer_cards
    res.update(run(gp, jp, rp, mesh, rank))
    res["wall_s"] = time.perf_counter() - t0
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def serve_vta(engine, mesh, rank: int, n: int, threads: int,
              max_batch: int) -> dict:
    """A data-parallel server (mesh) or a one-card one (mesh None) on this
    engine: rank 0 serves `n` binary planar `vta` requests (phase 11's
    samples, T 100 and 125) from `threads` client threads of its own, after
    the warm-up `serve` runs, then closes it; a rank > 0 follows. -> rank
    0's answers (with the requests' meta and extract() kwargs) and
    requests/s."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from jegal_torch import serving

    serving.warmup(engine, ("vta",), INFER_WINDOW_MS, max_batch, "planar",
                   mesh)
    if rank != 0:
        serving.follow(engine, mesh)
        return {}
    base, content, clips = serve_samples()
    server = serving.create_server(engine, port=0, mesh=mesh,
                                   batch_window_ms=INFER_WINDOW_MS,
                                   max_batch=max_batch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests = [request_of("vta", i, base, content, clips)
                for i in range(n)]
    bodies = [(r, encode_request(*r[:2], True)) for r in requests]

    def one(item):
        (meta, _, kw), body = item
        return post(url, *body), meta, kw

    try:
        with ThreadPoolExecutor(threads) as ex:
            t0 = time.perf_counter()
            answers = list(ex.map(one, bodies))
            wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for (status, _), meta, _ in answers:
        if status != 200:
            raise AssertionError(f"served {meta['fname']}: status {status}")
    return dict(answers=[(ans, meta, kw) for (_, ans), meta, kw in answers],
                requests=n, wall_s=wall, requests_per_s=n / wall)


def infer_card(gp, jp, rp, mesh, rank: int) -> dict:
    """Phase 7e(ii) in a rank: extract_many(mesh=) of phase 6c's eight
    planar clips (batch_size 4), its launches counted as `drive_call`
    counts them (this rank's graphs), then INFER_REQUESTS served `vta`
    requests through a two-rank server (batch 4)."""
    from jegal_torch.api import JegalEngine
    from jegal_torch.parallel import mesh as M

    engine = JegalEngine(jp, gp, roberta_params=rp,
                         tokenizer=word_tokenizer())
    samples = many_samples()
    want, _ = many_launches(samples, 4, {}, dp=M.data_size(mesh))
    results, ran = drive_call(
        lambda: engine.extract_many(samples, "vta", batch_size=4, mesh=mesh),
        want, f"rank {rank}'s extract_many (mesh ({M.data_size(mesh)}, 1))")
    served = serve_vta(engine, mesh, rank, INFER_REQUESTS, INFER_REQUESTS,
                       4)
    return dict(results=results, launches=ran,
                want=counts(**want), served=served)


def infer_cards(gp, jp, rp, mesh, rank: int) -> dict:
    """The `--mesh-cards` inference in a rank of the (4, 1) mesh over NCCL:
    for a float32 and a bf16 engine, extract_many of CARDS_CLIPS planar 5 s
    clips (batch CARDS_BATCH) at the mesh, and on rank 0 the same call
    without a mesh on card 0 (the others waiting at a barrier), CARDS_REPS
    warm calls of each in turns (host clock); then a served `vta` load on
    one card and at the mesh, in turns (one, mesh, mesh, one)."""
    import torch
    import torch.distributed as dist

    from jegal_torch.api import JegalEngine

    samples = cards_samples()
    out: dict = {}
    for label, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        engine = JegalEngine(jp, gp, roberta_params=rp,
                             tokenizer=word_tokenizer(), dtype=dtype)

        def call(m):
            return engine.extract_many(samples, "vta",
                                       batch_size=CARDS_BATCH, mesh=m)

        got, launches = replayed(lambda: call(mesh))
        one = call(None) if rank == 0 else None
        dist.barrier()
        walls = {"one_card": [], "mesh": []}
        for _ in range(CARDS_REPS):
            if rank == 0:
                t0 = time.perf_counter()
                call(None)
                walls["one_card"].append(time.perf_counter() - t0)
            dist.barrier()
            t0 = time.perf_counter()
            call(mesh)
            walls["mesh"].append(time.perf_counter() - t0)
            dist.barrier()
        out[label] = dict(results=got, launches=launches, one_card=one,
                          walls=walls)
        if label == "float32":
            served = []
            for m in (None, mesh, mesh, None):
                if m is not None or rank == 0:
                    served.append(serve_vta(engine, m, rank, CARDS_REQUESTS,
                                            CARDS_THREADS, CARDS_BATCH))
                dist.barrier()
            out["served"] = served
        engine.close()
        del engine
        torch.cuda.empty_cache()
    return out


def cards_samples():
    """CARDS_CLIPS planar `vta` 5 s clips (T 125), phase 6c's content."""
    import numpy as np

    from jegal_torch.ops.video import s2d_repack

    base = clip(125, 12, SEED + 3)
    out = []
    for i in range(CARDS_CLIPS):
        rng = np.random.default_rng(SEED + 100 + i)
        frames = rng.integers(0, 256, (125, 270, 480, 3), dtype=np.uint8)
        out.append(dict(frames=s2d_repack(frames, rng.integers(90, 200, 125)),
                        text=SMOKE_TEXT, wav=base["wav"],
                        word_boundaries=base["word_boundaries"],
                        fname=f"cards_{i}"))
    return out


def run_infer_ranks(tmp: Path, world: int, backend: str, cards: int,
                    mode: str, digest) -> list:
    """`world` child ranks (`--infer-rank`) over `backend`, rank r on card r
    % cards, running MODE; a rank that fails or outlives INFER_TIMEOUT_S
    fails the phase and every rank is killed. -> each rank's results."""
    import pickle

    t0 = time.perf_counter()
    run_children(tmp, "--infer-rank", world, cards, INFER_TIMEOUT_S,
                 lambda r: [str(r), str(world), str(tmp / "pg"), str(tmp),
                            backend, mode])
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        x = ranks[-1]
        log(f"  rank {r} ({x['backend']}, {x['card']}): "
            f"{x['wall_s']:.1f} s")
        if x["digest"] != digest:
            raise AssertionError(f"inference rank {r} drew other weights")
    log(f"  {world} ranks in {time.perf_counter() - t0:.1f} s")
    return ranks


def same_ranks(ranks, key, what: str):
    """Every rank's results bit for bit rank 0's."""
    import numpy as np

    for x in ranks[1:]:
        for a, b in zip(x[key], ranks[0][key]):
            if not all(np.array_equal(a[k], b[k])
                       for k in ("gesture_emb", "content_emb")):
                raise AssertionError(f"{what}: rank {x['rank']}'s results "
                                     f"differ from rank 0's")


def run_mesh_inference(engine, digest) -> dict:
    """Phase 7e: (i) a one-rank NCCL group at mesh (1, 1): extract_many(
    mesh=) of phase 6c's eight planar clips bit-equal to the call without a
    group; (ii) INFER_RANKS child processes on this card over gloo at (2,
    1): the same call in each, its launches this rank's rows' (kernels 2,
    7, 3, 4 and 5), both ranks' results bit-equal and within abs 1e-4 and
    min row cosine 0.99999 of (i)'s one-rank results, then a two-rank
    server (batch window INFER_WINDOW_MS, batch 4) answering INFER_REQUESTS
    `vta` requests as `extract` does."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from jegal_torch.parallel import mesh as M

    samples = many_samples()
    out: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        log("data-parallel inference: (i) one NCCL rank at mesh (1, 1) "
            "against no group, extract_many of phase 6c's eight planar "
            "clips")
        want = engine.extract_many(samples, "vta", batch_size=4)
        M.initialize_distributed(device="cuda",
                                 init_method=f"file://{tmp}/pg1", rank=0,
                                 world_size=1)
        try:
            got, ran = replayed(lambda: engine.extract_many(
                samples, "vta", batch_size=4, mesh=M.make_mesh(1, 1)))
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(got, want)
                   for k in ("gesture_emb", "content_emb"))
        log(f"  backend {backend}: {'bit-equal' if same else 'DIFFER'}; "
            f"graphs replayed {ran}")
        if not same:
            raise AssertionError("extract_many at mesh (1, 1) differs from "
                                 "the call without a group")
        out["1x1"] = dict(backend=backend, bit_equal=same, launches=ran)

        log(f"data-parallel inference: (ii) {INFER_RANKS} ranks on this "
            f"card over gloo at mesh ({INFER_RANKS}, 1) (a check of the "
            f"path; one card, so no multi-GPU speed)")
        ranks = run_infer_ranks(tmp / "ranks", INFER_RANKS, "gloo", 1,
                                "card", digest)
    same_ranks(ranks, "results", "extract_many at (2, 1)")
    worst = dict(err=0.0, cos=1.0)
    for s, r, w in zip(samples, ranks[0]["results"], want):
        c = compare(r, w, f"(2, 1) vs one rank, {s['fname']}")
        worst = dict(err=max(worst["err"], c["err"]),
                     cos=min(worst["cos"], c["cos"]))
    for x in ranks:
        log(f"  rank {x['rank']} launches {x['launches']}")
        if x["launches"] != x["want"]:
            raise AssertionError(f"rank {x['rank']}: launches "
                                 f"{x['launches']}, want {x['want']}")
    served = ranks[0]["served"]
    sworst = dict(err=0.0, cos=1.0)
    for ans, meta, kw in served["answers"]:
        w = hold_answer(ans, expected(engine, meta, kw),
                        f"two-rank server, {meta['fname']}")
        sworst = dict(err=max(sworst["err"], w["err"]),
                      cos=min(sworst["cos"], w["cos"]))
    log(f"  two-rank server: {served['requests']} vta requests, "
        f"{served['requests_per_s']:.2f} requests/s (a check, not a "
        f"speed), every answer within the bars of extract")
    torch.cuda.synchronize()
    out[f"{INFER_RANKS}x1"] = dict(
        backend=ranks[0]["backend"], launches_per_rank=ranks[0]["launches"],
        rank_wall_s=[x["wall_s"] for x in ranks], max_abs_err=worst["err"],
        min_row_cos=worst["cos"], served=served["requests"],
        served_max_abs_err=sworst["err"], served_min_row_cos=sworst["cos"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 7e: {out['wall_s']:.1f} s")
    return out


def run_mesh_cards_infer(engine, digest, cards: int) -> dict:
    """`--mesh-cards` inference: four ranks over NCCL at (4, 1), one a
    card (infer_cards): each engine's mesh results bit-equal on every rank
    and within the bars of card 0's one-rank results (float32: abs 1e-4,
    min row cosine 0.99999; bf16: tests/bf16_bars.py's min row cosine
    0.9999), clips/s of each beside one card, and the served `vta` load's
    requests/s on one card and at the mesh, every answer within the bars
    of `extract` on this process's float32 engine."""
    import tempfile

    import numpy as np

    world = 4
    if cards < world:
        raise AssertionError(f"--mesh-cards needs {world} cards, found "
                             f"{cards}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ranks = run_infer_ranks(Path(tmp) / "infer", world, "nccl", cards,
                                "cards", digest)
    out: dict = {}
    bar16 = bf16_bars().KERNEL_COS
    for label in ("float32", "bf16"):
        same_ranks([x[label] | dict(rank=x["rank"]) for x in ranks],
                   "results", f"{label} extract_many at (4, 1)")
        mesh_res = ranks[0][label]["results"]
        one = ranks[0][label]["one_card"]
        worst = dict(err=0.0, cos=1.0)
        for i, (a, b) in enumerate(zip(mesh_res, one)):
            if label == "float32":
                c = compare(a, b, f"(4, 1) vs card 0, float32, clip {i}")
            else:
                c = dict(err=max(float(np.abs(a[k] - b[k]).max())
                                 for k in ("gesture_emb", "content_emb")),
                         cos=hold_cos(a, b, bar16,
                                      f"(4, 1) vs card 0, bf16, clip {i}"))
            worst = dict(err=max(worst["err"], c["err"]),
                         cos=min(worst["cos"], c["cos"]))
        walls = ranks[0][label]["walls"]
        one_s = statistics.median(walls["one_card"])
        mesh_s = statistics.median(walls["mesh"])
        out[label] = dict(
            clips=CARDS_CLIPS, batch_size=CARDS_BATCH,
            clips_per_s_one_card=CARDS_CLIPS / one_s,
            clips_per_s_mesh=CARDS_CLIPS / mesh_s,
            walls_one_card_s=walls["one_card"], walls_mesh_s=walls["mesh"],
            launches_per_rank=ranks[0][label]["launches"],
            max_abs_err=worst["err"], min_row_cos=worst["cos"])
        log(f"  {label}: {CARDS_CLIPS} planar 5 s clips, batch "
            f"{CARDS_BATCH}: one card {CARDS_CLIPS / one_s:.3f} clips/s, "
            f"(4, 1) {CARDS_CLIPS / mesh_s:.3f} clips/s (median of "
            f"{CARDS_REPS} calls in turns; host clock)")
    served = ranks[0]["served"]
    for s, what in zip(served, ("one card", "(4, 1)", "(4, 1)",
                                "one card")):
        for ans, meta, kw in s["answers"]:
            hold_answer(ans, expected(engine, meta, kw),
                        f"served at {what}, {meta['fname']}")
        log(f"  served {s['requests']} vta requests at {what} from "
            f"{CARDS_THREADS} threads: {s['requests_per_s']:.2f} "
            f"requests/s")
    out["served"] = dict(requests=CARDS_REQUESTS, threads=CARDS_THREADS,
                         max_batch=CARDS_BATCH,
                         requests_per_s_one_card=[served[0]["requests_per_s"],
                                                  served[3]["requests_per_s"]],
                         requests_per_s_mesh=[served[1]["requests_per_s"],
                                              served[2]["requests_per_s"]])
    out["rank_wall_s"] = [x["wall_s"] for x in ranks]
    return out


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

# ---------------------------------------------------------------------------
# Phase 9: checkpoints, validation and eval
# ---------------------------------------------------------------------------

# launches of one forward_validation (inference, fused=True): the gesture
# encoder's 6 and the text encoder's 3 pre-norm layers as fused sublayers,
# and XLM-R as one stack
VALIDATION_LAUNCHES = dict(attn_sublayer=9, ffn_sublayer=9, encoder_stack=1)
# forward_aud, card against CPU: eight conv layers of up to 3,456-term
# float32 sums in another order (cuDNN, oneDNN); max abs err within this
# share of the output's largest magnitude (the CPU port is within 7e-7 of
# the JAX package's at the same width)
AUD_RTOL = 1e-5
# log-mel, card against the host's numpy copy: the JAX suite's bar for its
# two mel paths (tests/test_audio.py:100)
MEL_RTOL, MEL_ATOL = 2e-4, 2e-3


def same_leaves(got, want, what: str):
    """Every leaf of `got` equal to `want`'s exactly: keys (the .npz
    scheme's), dtype, shape, values."""
    import numpy as np

    from jegal_torch.convert.checkpoints import flatten

    g, w = flatten(got), flatten(want)
    if sorted(g) != sorted(w):
        raise AssertionError(f"{what}: keys differ: "
                             f"{sorted(set(g) ^ set(w))[:5]}")
    bad = [k for k in w if g[k].dtype != w[k].dtype
           or not np.array_equal(g[k], w[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. "
                             f"{bad[:3]}")
    log(f"  {what}: {len(w)} leaves equal to the tree written, exactly")


def _mb(path: Path) -> float:
    files = path.rglob("*") if path.is_dir() else [path]
    return sum(f.stat().st_size for f in files if f.is_file()) / 1e6


def timed_load(fn, path: Path, what: str):
    """fn() -> its result, with the file's MB and the load's seconds."""
    t0 = time.perf_counter()
    out = fn()
    sec = time.perf_counter() - t0
    mb = _mb(path)
    log(f"  {what}: {mb:.1f} MB loaded in {sec:.3f} s ({mb / sec:.0f} MB/s)")
    return out, dict(mb=mb, seconds=sec, mb_per_s=mb / sec)


def write_checkpoints(root: Path, gs_tree, jp, rp):
    """Phase 9a's reference-format files: the GestSync and JEGAL .pth
    ({"state_dict": ...} under `module.` prefixes) and XLM-R as an HF
    directory (model.safetensors where safetensors imports, else
    pytorch_model.bin). -> {name: path}."""
    import torch

    # the tests' helper tests/torch_ref_state_dicts.py (in every checkout;
    # it imports only numpy and torch) writes a tree in the reference's
    # torch names and layouts
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ref_state_dicts import (
        gestsync_state_dict,
        jegal_state_dict,
        roberta_hf_state_dict,
    )

    paths = {"gestsync": root / "gestsync.pth", "jegal": root / "jegal.pth"}
    t0 = time.perf_counter()
    torch.save({"state_dict": gestsync_state_dict(gs_tree)},
               paths["gestsync"])
    torch.save({"state_dict": jegal_state_dict(jp)}, paths["jegal"])
    hf = root / "xlm-roberta-base"
    hf.mkdir()
    sd = roberta_hf_state_dict(rp)
    try:
        from safetensors.torch import save_file
    except ImportError:
        torch.save(sd, hf / "pytorch_model.bin")
        fmt = "pytorch_model.bin (safetensors does not import here)"
    else:
        save_file(sd, str(hf / "model.safetensors"))
        fmt = "model.safetensors"
    paths["roberta"] = hf
    log(f"  wrote the reference-format files in "
        f"{time.perf_counter() - t0:.2f} s; XLM-R base as {fmt}")
    return paths, fmt


def _validate(jp, rp, batch):
    """forward_validation under no_grad on the batch's device."""
    import torch

    from jegal_torch.models import jegal as J
    from jegal_torch.models.roberta import XLMR_BASE

    fields = {k: v for k, v in batch.items() if k != "word_mask"}
    with torch.no_grad():
        return J.forward_validation(jp, rp, roberta_cfg=XLMR_BASE, **fields)


def _unit_rows(x):
    import numpy as np

    x = x.cpu().numpy().reshape(-1, x.shape[-1])
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _hold_validation(card, cpu, what: str) -> dict:
    """forward_validation's gesture and content rows, card against CPU,
    L2-normalized, within SLICE_ATOL and SLICE_MIN_COS."""
    import numpy as np

    worst = dict(err=0.0, cos=1.0)
    for name, a, b in zip(("gesture", "content"), card, cpu):
        a, b = _unit_rows(a), _unit_rows(b)
        err = float(np.abs(a - b).max())
        cos = float((a * b).sum(-1).min())
        ok = err <= SLICE_ATOL and cos >= SLICE_MIN_COS
        log(f"  card vs CPU, forward_validation on {what}, {name} rows "
            f"{a.shape[0]} (L2-normalized): max abs err {err:.3e} (tolerance "
            f"{SLICE_ATOL:g}), min row cosine {cos:.8f} (tolerance "
            f"{SLICE_MIN_COS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"forward_validation {name} on {what}: the "
                                 f"card disagrees with the CPU")
        worst = dict(err=max(worst["err"], err), cos=min(worst["cos"], cos))
    return worst


def run_validation(eng, engine, loaded, train_batch):
    """Phase 9c: forward_validation at phase 7b's training batch on the
    loaded weights (launches, warm ms, device busy), card against CPU on
    that batch and on phase 5's small clip."""
    import torch

    from jegal_torch.ops.kernels import _build
    from jegal_torch.training.data import collate_training_batch

    batch = {k: v.cuda() for k, v in train_batch.items()}
    _build.reset_launches()
    g, c = _validate(eng.jegal_params, eng.roberta_params, batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = counts(**VALIDATION_LAUNCHES)
    log(f"validation: forward_validation at the training batch (B 8, T "
        f"128, S 32): launches {launches}")
    if launches != want:
        raise AssertionError(f"forward_validation: launches {launches}, "
                             f"want {want}")
    if g.shape != (8, 128, 512) or c.shape != (8, 16, 512) \
            or not (torch.isfinite(g).all() and torch.isfinite(c).all()):
        raise AssertionError(f"forward_validation: {g.shape}, {c.shape}")
    # the kernels at this batch's shapes (gesture sublayers at R 1024,
    # segment 128; text sublayers at R 256, segment 32, d 768; the stack
    # at 8 x 32 tokens) against the CPU run on the same batch
    t0 = time.perf_counter()
    cpu = _validate(loaded["jegal"], loaded["roberta"], train_batch)
    log(f"  the CPU run of the training batch took "
        f"{time.perf_counter() - t0:.2f} s")
    batch_err = _hold_validation((g, c), cpu, "the training batch")

    def run():
        _validate(eng.jegal_params, eng.roberta_params, batch)
        torch.cuda.synchronize()

    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        run()
        walls.append(1e3 * (time.perf_counter() - t0))
    q1, ms, q3 = statistics.quantiles(walls, n=4)
    prof = profile_run(run, "forward_validation at the training batch")
    log(f"  warm forward_validation {ms:.3f} ms (median of 20, quartiles "
        f"{q1:.3f} / {q3:.3f}); device busy {prof['device_busy_ms']:.3f} ms")

    small = dict(clip(16, 4, SEED + 4), text="the quick brown fox")
    feats = engine.gestsync_features(small["frames"], small["chin_rows"])
    one = collate_training_batch([dict(
        visual_feats=feats, text=small["text"], wav=small["wav"],
        word_boundaries=small["word_boundaries"])], word_tokenizer())
    card = _validate(eng.jegal_params, eng.roberta_params,
                     {k: v.cuda() for k, v in one.items()})
    cpu = _validate(loaded["jegal"], loaded["roberta"], one)
    clip_err = _hold_validation(card, cpu, "the 16-frame 4-word clip")
    return dict(launches=launches, ms=ms, ms_q1=q1, ms_q3=q3,
                device_busy_ms=prof["device_busy_ms"],
                device_idle_share=1 - prof["device_busy_ms"] / ms,
                card_vs_cpu_batch=batch_err, card_vs_cpu_clip=clip_err)


def run_audio(eng, loaded, sample):
    """Phase 9d: the torch log-mel on the card against the host's numpy
    copy on phase 4's 80,000 samples, and forward_aud on (1, 80, 500, 1)
    against its CPU run; each timed."""
    import numpy as np
    import torch

    from jegal_torch.models import gestsync as G
    from jegal_torch.ops import audio as A

    wav = torch.from_numpy(sample["wav"][None]).cuda()
    got = A.wav2filterbanks(wav).cpu().numpy()
    want = A.wav2filterbanks_np(sample["wav"])
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and np.allclose(got, want, rtol=MEL_RTOL,
                                                 atol=MEL_ATOL)
    mel_ms = cuda_ms(lambda: A.wav2filterbanks(wav))
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        A.wav2filterbanks_np(sample["wav"])
        walls.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(walls)
    log(f"audio: wav2filterbanks on the card, {wav.shape[1]} samples -> "
        f"{got.shape}: max abs err {err:.3e} against wav2filterbanks_np "
        f"(rtol {MEL_RTOL:g}, atol {MEL_ATOL:g}) {'ok' if ok else 'FAIL'}; "
        f"{mel_ms:.4f} ms on the card (CUDA events, median of 20), numpy "
        f"on the host {host_ms:.3f} ms (median of 20)")
    if not ok:
        raise AssertionError("wav2filterbanks: the card disagrees with the "
                             "numpy copy")
    x = torch.from_numpy(np.random.default_rng(SEED + 12).standard_normal(
        (1, 80, 500, 1), dtype=np.float32))
    xd = x.cuda()
    # the whole (1, 1024, 1, 13) map that the timed call computes, before
    # forward_aud keeps its first column
    card = G.aud_feature_map(eng.gestsync_params, xd).cpu()
    cpu = G.aud_feature_map(loaded["gestsync"], x)
    aud_err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    ok = card.shape == cpu.shape == (1, 1024, 1, 13) \
        and aud_err <= AUD_RTOL * scale \
        and G.forward_aud(eng.gestsync_params, xd).shape == (1, 1024, 1)
    aud_ms = cuda_ms(lambda: G.forward_aud(eng.gestsync_params, xd))
    log(f"  the audio branch on (1, 80, 500, 1) -> map {tuple(card.shape)}: "
        f"card vs CPU max abs err {aud_err:.3e} (tolerance {AUD_RTOL:g} of "
        f"the largest output, {scale:.3f}) {'ok' if ok else 'FAIL'}; "
        f"forward_aud {aud_ms:.4f} ms on the card")
    if not ok:
        raise AssertionError("forward_aud: the card disagrees with the CPU")
    return dict(mel_max_abs_err=err, mel_ms=mel_ms, mel_numpy_host_ms=host_ms,
                forward_aud_max_abs_err=aud_err, forward_aud_ms=aud_ms)


def _same_rates(dev: dict, host: dict, what: str, exact=()):
    """Integer fields (`exact`) equal, every rate within 1e-6."""
    bad = [k for k in host if (dev[k] != host[k] if k in exact
                               else abs(dev[k] - host[k]) > 1e-6)]
    log(f"  {what}: device {dev}; numpy {host} "
        f"{'FAIL' if bad or sorted(dev) != sorted(host) else 'ok'}")
    if bad or sorted(dev) != sorted(host):
        raise AssertionError(f"{what}: the device path disagrees on {bad}")


def same_spots(res_dir: str):
    """spotting.predict_device's frame and score for each video against
    spot_word's: frames equal, scores within 1e-6. -> the hits and misses
    at the default thresholds."""
    from jegal_torch.eval import common, spotting

    preds = spotting.predict_device(res_dir)
    files = common.list_embedding_files(res_dir)
    hits = 0
    for (_, pred, score), fname in zip(preds, files):
        feats = common.load_pkl(fname)
        info = feats["info"]
        ok, want_pred, want_score = spotting.spot_word(
            feats["gesture_emb"], feats["content_emb"],
            info["word_boundaries"], info["target_word_boundary"])
        if pred != want_pred or abs(score - want_score) > 1e-6:
            raise AssertionError(f"spotting {fname}: device frame {pred} "
                                 f"score {score}, numpy {want_pred} "
                                 f"{want_score}")
        hits += int(ok)
    if len(preds) != len(files):
        raise AssertionError(f"spotting: {len(preds)} predictions for "
                             f"{len(files)} files")
    log(f"  spotting: {len(preds)} videos' frames and scores from the card "
        f"equal spot_word's ({hits} hits, {len(preds) - hits} misses) ok")
    return hits, len(preds) - hits


def spread_pairs(seed: int, n: int = 5000, d: int = 512,
                 margin: float = 1e-6):
    """n seeded (query, key) pairs with spread ranks: noise 8 puts a
    pair's cosine (about 0.12) among the other keys' (standard deviation
    about 0.044), for R@1 about 0.2 and MR about 13. No key's cosine lies
    within `margin` of its row's diagonal in float64: the float32 paths
    round each cosine by at most about 1.3e-7, so a closer pair would order
    by the rounding, and the card's rank and numpy's could differ by it.
    A row with such a pair has its key moved toward its query (1 % of it)
    until none is left."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, d), dtype=np.float32)
    k = q + 8.0 * rng.standard_normal((n, d), dtype=np.float32)
    qn = q / np.linalg.norm(q.astype(np.float64), axis=1, keepdims=True)
    for _ in range(20):
        kn = k / np.linalg.norm(k.astype(np.float64), axis=1, keepdims=True)
        sim = qn @ kn.T
        gap = np.abs(sim - np.diag(sim)[:, None])
        np.fill_diagonal(gap, np.inf)
        near = np.flatnonzero(gap.min(axis=1) < margin)
        if not len(near):
            return q, k
        k[near] += 0.01 * q[near]
    raise AssertionError(f"spread_pairs: {len(near)} rows still within "
                         f"{margin:g} of their diagonal")


def run_eval(eng, root: Path):
    """Phase 9e: phase 6c's eight planar clips, each with audio of its own
    (so that no two content rows tie: the reference's sort counts a tied
    row's every index), written by `extract_to_pkl` with each clip's
    target word in its info, as the CSV extractor writes it, and in the
    even clips the target word's content row redrawn and planted as a
    gesture peak in its span;
    then retrieval, spotting (each video's frame and score too) and ASD on
    the card against their numpy paths; and compute_metrics_device on
    5,000 seeded 512-d pairs with spread ranks, checked and timed against
    numpy."""
    import pickle

    import numpy as np

    from jegal_torch.cli.main import Rows
    from jegal_torch.eval import asd, common, retrieval, spotting

    res_dir = root / "embs"
    names = []
    t0 = time.perf_counter()
    for i, s in enumerate(many_samples()):
        t = s["frames"].shape[0]
        wav = (np.random.default_rng(SEED + 30 + i).standard_normal(80000)
               * 3000).astype(np.float32)
        path = eng.extract_to_pkl(str(res_dir), modalities="vta",
                                  **dict(s, wav=wav, fname=f"clip{i}__t{t}"))
        with open(path, "rb") as f:
            feats = pickle.load(f)
        info = feats["info"]
        wbs = common.parse_word_boundaries(info["word_boundaries"])
        wi = (3 * i) % len(wbs)
        info["target_word_boundary"] = info["word_boundaries"][wi]
        if i % 2 == 0:
            # a hit: the target word's row redrawn (seeded, so about
            # orthogonal to the other words') and planted as the gesture
            # peak at its span's start; its score there is about 1
            cont = feats["content_emb"]
            row = np.random.default_rng(SEED + 40 + i).standard_normal(
                cont.shape[1]).astype(np.float32)
            cont[wi] = row * (np.linalg.norm(cont[wi]) / np.linalg.norm(row))
            feats["gesture_emb"][wbs[wi][1]] = 8 * cont[wi]
        with open(path, "wb") as f:
            pickle.dump(feats, f)
        names.append(f"clip{i}/t{t}")
    log(f"eval: {len(names)} .pkl files written by extract_to_pkl in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    ret_dev, ret_host = retrieval.evaluate_device(str(res_dir)), \
        retrieval.evaluate(str(res_dir))
    for mode in ("c2g", "g2c"):
        _same_rates(ret_dev[mode], ret_host[mode], f"retrieval {mode}",
                    exact=("MR",))
    hits, misses = same_spots(str(res_dir))
    if not (hits and misses):
        raise AssertionError(f"spotting: {hits} hits and {misses} misses; "
                             f"the planted set should give both")
    spot_dev, spot_host = spotting.evaluate_device(str(res_dir)), \
        spotting.evaluate(str(res_dir))
    _same_rates(spot_dev, spot_host, "spotting", exact=("correct", "total"))
    table = Rows([{"filename": n, "neg_files": str([m for m in names
                                                     if m != n])}
                  for n in names])
    asd_dev, asd_host = asd.evaluate_device(str(res_dir), table), \
        asd.evaluate(str(res_dir), table)
    _same_rates(asd_dev, asd_host, "asd", exact=("evaluated",))
    out.update(retrieval=ret_dev, spotting=spot_dev, asd=asd_dev)

    q, k = spread_pairs(SEED + 13)
    host = retrieval.compute_metrics(retrieval.similarity_matrix(q, k))
    dev = retrieval.compute_metrics_device(q, k)
    _same_rates(dev, host, "compute_metrics_device, 5000 x 512",
                exact=("MR",))
    if not (0.05 < host["R1"] < 0.5 and host["MR"] > 1):
        raise AssertionError(f"the 5000-row set should spread its ranks: "
                             f"{host}")

    def median_ms(fn, reps=5):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(walls)

    import torch

    qd, kd = torch.from_numpy(q).cuda(), torch.from_numpy(k).cuda()
    valid = torch.ones(5000, device=qd.device)
    dev_ms = median_ms(lambda: retrieval.compute_metrics_device(q, k))
    core_ms = cuda_ms(lambda: retrieval._metrics_on_device(qd, kd, valid))
    host_ms = median_ms(lambda: retrieval.compute_metrics(
        retrieval.similarity_matrix(q, k)))
    log(f"  compute_metrics_device on 5000 x 512: {dev_ms:.3f} ms a call "
        f"(host clock, median of 5, uploads and the scalars' fetch "
        f"included), {core_ms:.3f} ms on the card (CUDA events, median of "
        f"20); numpy {host_ms:.3f} ms (median of 5)")
    out["metrics_5000"] = dict(device_call_ms=dev_ms, device_ms=core_ms,
                               numpy_ms=host_ms)
    return out


def run_checkpoints(gp, jp, rp, engine, sample, raw_res, train_batch):
    """Phase 9: reference-format checkpoints written and loaded without
    JAX (a), an engine built from them (b), forward_validation (c), the
    torch log-mel and forward_aud (d), the eval on the card (e)."""
    import tempfile

    import torch

    from jegal_torch.api import JegalEngine
    from jegal_torch.convert import checkpoints as CK
    from jegal_torch.convert import init_gestsync_audio_params

    out: dict = {}
    gs_tree = dict(gp, **init_gestsync_audio_params(
        torch.Generator().manual_seed(SEED + 11)))
    rp_tree = {"embeddings": rp["embeddings"], "layers": rp["layers"]}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        log("checkpoints: the phase-4 trees (GestSync with a seeded audio "
            "branch) as reference-format files")
        paths, out["xlmr_format"] = write_checkpoints(root, gs_tree, jp,
                                                      rp_tree)
        loaded, loads = {}, {}
        for name, fn in (("gestsync", CK.load_gestsync),
                         ("jegal", CK.load_jegal),
                         ("roberta", lambda p: CK.load_roberta(p)[0])):
            loaded[name], loads[name] = timed_load(
                lambda: fn(str(paths[name])), paths[name],
                f"{paths[name].name} through convert.checkpoints")
        for name, want in (("gestsync", gs_tree), ("jegal", jp),
                           ("roberta", rp_tree)):
            same_leaves(loaded[name], want, f"loaded {name}")
        for name in loaded:
            npz = root / f"{name}.npz"
            save, read = ((CK.save_roberta_npz,
                           lambda p: CK.load_roberta(p)[0])
                          if name == "roberta" else (CK.save_npz,
                                                     CK.load_npz))
            t0 = time.perf_counter()
            save(loaded[name], str(npz))
            write_s = time.perf_counter() - t0
            back, loads[npz.name] = timed_load(lambda: read(str(npz)), npz,
                                               npz.name)
            loads[npz.name]["write_s"] = write_s
            same_leaves(back, loaded[name], f"{npz.name} read back")
        out["loads"] = loads

        eng = JegalEngine(loaded["jegal"], loaded["gestsync"],
                          roberta_params=loaded["roberta"],
                          tokenizer=word_tokenizer())      # device="cuda"
        res, _ = drive(eng, sample, "vta", VTA_LAUNCHES,
                       "the loaded engine's raw vta clip")
        check_embeddings(res, 125, 12)
        out["engine_vs_phase4"] = compare(res, raw_res,
                                          "loaded engine vs phase 4")
        out["validation"] = run_validation(eng, engine, loaded, train_batch)
        out["audio"] = run_audio(eng, loaded, sample)
        out["eval"] = run_eval(eng, root)
        eng.close()
    return out


# ---------------------------------------------------------------------------
# Phase 10: the CLI
# ---------------------------------------------------------------------------

# the four clips of phase 10: two in the T = 128 bucket, two in 256
CLI_CLIPS = (125, 125, 200, 200)
# verify's two samples (T bucket 64)
VERIFY_T = 50


def cli_frames(t: int, seed: int):
    """A synthetic 270x480 clip that a codec keeps close: a horizontal
    gradient, a square drifting across it, and low noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.linspace(40, 220, 480).astype(np.uint8)[None, :, None]
    frames = np.repeat(np.repeat(base, 270, axis=0), 3, axis=2)[None]
    frames = np.repeat(frames, t, axis=0)
    for i in range(t):
        x = (3 * i) % 380
        frames[i, 120:220, x:x + 100] = (200, 90, 60)
    return frames + rng.integers(0, 12, frames.shape, dtype=np.uint8)


def cli_words(t: int, n: int = 12):
    """n words over t frames: (word, start s, end s) and the [word, start
    frame, end frame] boundaries load_text makes of them."""
    words = SMOKE_TEXT.split(" ")[:n]
    secs = [(w, round(0.04 * (i * t // n) + 0.04, 2),
             round(0.04 * ((i + 1) * t // n) - 0.04, 2))
            for i, w in enumerate(words)]
    return secs, [[w, round(s * 25), round(e * 25)] for w, s, e in secs]


def write_transcript(path: Path, secs):
    rows = [f"{w}, {s}, {e}, 0.9" for w, s, e in secs]
    path.write_text("\n".join(["Text: " + " ".join(w for w, _, _ in secs),
                               "Lang: en", "", "WORD, START, END, SCORE",
                               *rows]) + "\n")


class CliRun:
    """The port's CLI called in-process: `run(name, argv)` -> (its stdout,
    the exit code SystemExit gave or 0), with every launch counter set to
    0 just before and read just after, and its wall seconds, kept by
    subcommand."""

    def __init__(self):
        self.walls: dict = {}
        self.launches: dict = {}

    def run(self, name: str, argv, expect_code: int = 0):
        import contextlib
        import io

        from jegal_torch.cli.main import main as cli
        from jegal_torch.ops.kernels import _build

        out = io.StringIO()
        code = 0
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli(argv)
        except SystemExit as e:
            code = e.code
        wall = time.perf_counter() - t0
        self.launches[name] = {k: n for k, n in _build.LAUNCHES.items() if n}
        self.walls[name] = wall
        log(f"  python -m jegal_torch {' '.join(argv[:1] + argv[1:9])}"
            f"{' ...' if len(argv) > 9 else ''}: exit {code} in {wall:.2f} s, "
            f"launches {self.launches[name]}")
        if code != expect_code:
            raise AssertionError(f"{name}: exit {code}, want {expect_code}; "
                                 f"output {out.getvalue()[-2000:]}")
        return out.getvalue()


def last_json(text: str):
    """The JSON document the CLI printed last (one line, or indented)."""
    start = text.rfind("\n{")
    return json.loads(text[start + 1 if start >= 0 else text.index("{"):])


def hold_features(got, want, what: str):
    """(T, 1024) features of two runs within SLICE_ATOL, each row's cosine
    within SLICE_MIN_COS."""
    import numpy as np

    err = float(np.abs(got - want).max())
    g = got / np.linalg.norm(got, axis=-1, keepdims=True)
    w = want / np.linalg.norm(want, axis=-1, keepdims=True)
    cos = float((g * w).sum(-1).min())
    ok = got.shape == want.shape and err <= SLICE_ATOL and cos >= SLICE_MIN_COS
    log(f"  {what}: max abs err {err:.3e}, min row cosine {cos:.8f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the runs disagree")
    return dict(err=err, cos=cos)


def trace_has(trace_dir: Path, needle: str) -> int:
    """Device kernels named with `needle` in the Chrome traces under
    trace_dir."""
    n = 0
    for f in trace_dir.glob("*.json"):
        for ev in json.loads(f.read_text()).get("traceEvents", []):
            if ev.get("cat") == "kernel" and needle in ev.get("name", ""):
                n += 1
    return n


def cli_inputs(root: Path):
    """Phase 10a: the decoder built (or, where the card machine has no
    libav, `_decode_for_features` replaced at the host boundary by the
    numpy repack of the same synthetic frames), four clips and verify's
    two samples with their .wav and transcripts, and the CSVs. -> dict."""
    import numpy as np
    from scipy.io import wavfile

    from jegal_torch.cli import main as C
    from jegal_torch.host import media
    from jegal_torch.ops.video import FALLBACK_ROWS, s2d_repack

    try:
        t0 = time.perf_counter()
        media._get_lib()                  # builds, then loads with libav's
        real = True
        log(f"cli: the libav decoder built and loaded in "
            f"{time.perf_counter() - t0:.2f} s: "
            f"{media.library_path().relative_to(ROOT)}")
    except (RuntimeError, OSError) as e:
        real = False
        log(f"cli: the libav decoder does not build or load here "
            f"({str(e).strip().splitlines()[-1][:200]})")
    videos = root / "videos"
    clips, frames_of = [], {}
    for i, t in enumerate(CLI_CLIPS):
        (videos / f"spk{i}").mkdir(parents=True)
        name = f"spk{i}/clip{i}"
        frames = cli_frames(t, SEED + 50 + i)
        wav = (np.random.default_rng(SEED + 60 + i).standard_normal(t * 640)
               * 3000).astype(np.int16)
        secs, wbs = cli_words(t)
        clips.append(dict(name=name, t=t, secs=secs, wbs=wbs))
        frames_of[str(videos / f"{name}.avi")] = frames
        wavfile.write(videos / f"{name}.wav", 16000, wav)
        write_transcript(videos / f"{name}.txt", secs)
    samples = root / "samples"
    samples.mkdir()
    for i in (1, 2):
        frames = cli_frames(VERIFY_T, SEED + 70 + i)
        wav = (np.random.default_rng(SEED + 72 + i).standard_normal(
            VERIFY_T * 640) * 3000).astype(np.int16)
        frames_of[str(samples / f"sample{i}.avi")] = frames
        wavfile.write(samples / f"sample{i}.wav", 16000, wav)
        write_transcript(samples / f"sample{i}.txt", cli_words(VERIFY_T, 6)[0])
    if real:
        t0 = time.perf_counter()
        for path, frames in frames_of.items():
            wav_path = Path(path).with_suffix(".wav")
            _, wav = wavfile.read(wav_path)
            media.encode_av(path, frames, wav)
        log(f"  {len(frames_of)} clips written by encode_av (mpeg4 + AAC) "
            f"in {time.perf_counter() - t0:.2f} s")
        decode = C._decode_for_features
    else:
        def decode(video_path, planar=True):
            frames = frames_of[video_path]
            cuts = np.full((frames.shape[0],), FALLBACK_ROWS, np.int32)
            return (s2d_repack(frames, cuts), None) if planar \
                else (frames, None)

        C._decode_for_features = decode
        log("cli: DECODE SUBSTITUTED: jegal_torch.cli.main."
            "_decode_for_features is the numpy repack (ops/video.s2d_repack, "
            "fallback chin rows) of the synthetic frames kept in memory; "
            "everything from the planar frames on is the CLI's own")
    names = [c["name"] for c in clips]
    rows = ["filename,phrase,word_boundaries,target_word_boundary,"
            "neg_files,start"]
    for i, c in enumerate(clips):
        phrase = " ".join(w for w, _, _ in c["secs"])
        negs = [n for n in names if n != c["name"]]
        rows.append(",".join([c["name"], phrase, json.dumps(str(c["wbs"])),
                              json.dumps(str(c["wbs"][(3 * i) % 12])),
                              json.dumps(str(negs)), str(10 * i)]))
    (root / "set.csv").write_text("\n".join(rows) + "\n")
    return dict(real=real, clips=clips, decode=decode, videos=videos,
                samples=samples, csv=root / "set.csv")


def run_cli(gp, jp, rp, engine):
    """Phase 10: the CLI's device subcommands in-process, at full width on
    phase 4's weights written as reference-format files: (a) inputs, (b)
    convert, (c) infer, (d) extract-feats, (e) extract-embs, (f) the evals,
    (g) verify, (h) warmup, (i) train. -> the `cli` line's dict."""
    import math
    import pickle
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from jegal_torch import api
    from jegal_torch.cli import main as C
    from jegal_torch.convert import checkpoints as CK
    from jegal_torch.convert import init_gestsync_audio_params
    from jegal_torch.data.datasets import read_csv
    from jegal_torch.host.media import load_audio_any
    from jegal_torch.text.normalize import load_text
    from jegal_torch.text.tokenizer import WordTokenizer

    t_phase = time.perf_counter()
    out: dict = {}
    runs = CliRun()
    from_file = WordTokenizer.__dict__["from_file"]
    decode = C._decode_for_features
    WordTokenizer.from_file = classmethod(
        lambda cls, path, **kw: cls(PieceTokenizer(), **kw))
    log("cli: --tokenizer_path resolves to a WordTokenizer over "
        "PieceTokenizer (WordTokenizer.from_file patched in chip_smoke.py; "
        "the card machine has no tokenizers wheel)")
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            root = Path(tmp)
            inp = cli_inputs(root)
            out["decoder_real"] = inp["real"]

            # (b) convert: reference-format files -> .npz, bit for bit
            gs_tree = dict(gp, **init_gestsync_audio_params(
                torch.Generator().manual_seed(SEED + 11)))
            rp_tree = {"embeddings": rp["embeddings"], "layers": rp["layers"]}
            src, _ = write_checkpoints(root, gs_tree, jp, rp_tree)
            npz = {k: root / f"{k}.npz" for k in src}
            for name in ("gestsync", "jegal", "roberta"):
                runs.run(f"convert {name}", ["convert", "--model", name,
                                             "--src", str(src[name]),
                                             "--dst", str(npz[name])])
            same_leaves(CK.load_npz(str(npz["gestsync"])), gs_tree,
                        "convert gestsync")
            same_leaves(CK.load_npz(str(npz["jegal"])), jp, "convert jegal")
            same_leaves(CK.load_roberta(str(npz["roberta"]))[0], rp_tree,
                        "convert roberta")
            ckpt = ["--checkpoint_path_jegal", str(npz["jegal"]),
                    "--checkpoint_path_gestsync", str(npz["gestsync"]),
                    "--roberta_path", str(npz["roberta"]),
                    "--tokenizer_path", "piece-tokenizer"]

            # (c) infer vta on one clip, profiled
            c0 = inp["clips"][0]
            video = inp["videos"] / f"{c0['name']}.avi"
            trace_dir = root / "trace"
            res = root / "infer"
            t0 = time.perf_counter()
            _, ran = drive_call(lambda: runs.run("infer", [
                "infer", *ckpt, "--modalities", "vta", "--video_path",
                str(video), "--text_path", str(video.with_suffix(".txt")),
                "--audio_path", str(video.with_suffix(".wav")),
                "--res_dir", str(res), "--profile_dir", str(trace_dir)]),
                VTA_LAUNCHES, "infer --modalities vta")
            with open(res / "clip0.pkl", "rb") as f:
                got = pickle.load(f)
            planar, _ = inp["decode"](str(video))
            text, wbs = load_text(str(video.with_suffix(".txt")))
            want = engine.extract(
                modalities="vta", frames=planar, text=text,
                word_boundaries=wbs,
                wav=load_audio_any(str(video.with_suffix(".wav"))),
                fname="clip0")
            check_embeddings(got, c0["t"], 12)
            out["infer"] = dict(compare(got, want,
                                        "infer vs JegalEngine.extract"),
                                replayed=ran)
            n_band = trace_has(trace_dir, "stem_band_kernel")
            log(f"  the --profile_dir trace holds {n_band} stem_band_kernel "
                f"device kernels")
            if not n_band:
                raise AssertionError("infer: the trace has no band stem "
                                     "kernel")
            out["infer"]["trace_stem_band_kernels"] = n_band

            # (d) extract-feats over the four clips, uploads on the decode
            # threads
            stacked = []
            stack = api.JegalEngine._stack_on_device

            def counted(fr, clips):
                stacked.extend(f.device.type for f, _ in clips)
                return stack(fr, clips)

            api.JegalEngine._stack_on_device = staticmethod(counted)
            feats_dir = root / "feats"
            argv = ["extract-feats", "--file_path", str(inp["csv"]),
                    "--video_dir", str(inp["videos"]), "--res_dir",
                    str(feats_dir), "--checkpoint_path", str(npz["gestsync"]),
                    "--batch_size", "4", "--decode_workers", "2"]
            try:
                stats = last_json(runs.run("extract-feats", argv))
            finally:
                api.JegalEngine._stack_on_device = staticmethod(stack)
            wall = runs.walls["extract-feats"]
            # a stem and a block-2 launch a padded clip and 160-frame
            # piece; the window head's 6 attention and FFN sublayers a chunk
            tower, chunks = many_launches([dict(frames=np.empty((t, 1)))
                                           for t in CLI_CLIPS], 4, {})
            want_launches = dict(stem_band=tower["stem_band"],
                                 conv2=tower["conv2"],
                                 attn_sublayer=6 * chunks,
                                 ffn_sublayer=6 * chunks)
            log(f"  extract-feats: {stats}; {wall:.2f} s, "
                f"{len(CLI_CLIPS) / wall:.2f} clips/s (engine load and "
                f"decode included); {len(stacked)} clips stacked on "
                f"{set(stacked)}")
            if stats != {"done": 4, "skipped": 0, "failed": 0}:
                raise AssertionError(f"extract-feats: {stats}")
            if stacked != ["cuda"] * 4:
                raise AssertionError(f"extract-feats: the clips were not "
                                     f"stacked on the card: {stacked}")
            if runs.launches["extract-feats"] != want_launches:
                raise AssertionError(f"extract-feats: launches "
                                     f"{runs.launches['extract-feats']}, "
                                     f"want {want_launches}")
            worst = dict(err=0.0, cos=1.0)
            decode_s = []
            for c in inp["clips"]:
                t0 = time.perf_counter()
                planar, _ = inp["decode"](str(inp["videos"]
                                              / f"{c['name']}.avi"))
                decode_s.append(time.perf_counter() - t0)
                r = hold_features(np.load(feats_dir / f"{c['name']}.npy"),
                                  engine.gestsync_features(planar),
                                  f"extract-feats {c['name']} vs "
                                  f"gestsync_features")
                worst = dict(err=max(worst["err"], r["err"]),
                             cos=min(worst["cos"], r["cos"]))
            again = last_json(runs.run("extract-feats (resume)", argv))
            if again != {"done": 0, "skipped": 4, "failed": 0}:
                raise AssertionError(f"extract-feats resume: {again}")
            out["extract_feats"] = dict(
                wall_s=wall, clips_per_s=len(CLI_CLIPS) / wall,
                clips_stacked_on_card=len(stacked), vs_engine=worst,
                decode_ms_per_clip=(1e3 * statistics.mean(decode_s)
                                    if inp["real"] else None))

            # (e) extract-embs on those features
            embs_root = root / "embs"
            stats = last_json(runs.run("extract-embs", [
                "extract-embs", "--file_path", str(inp["csv"]),
                "--checkpoint_path", str(npz["jegal"]), *ckpt[4:],
                "--res_dir", str(embs_root), "--video_dir",
                str(inp["videos"]), "--feature_dir", str(feats_dir),
                "--batch_size", "4"]))
            if stats != {"done": 4, "skipped": 0, "failed": 0, "invalid": 0}:
                raise AssertionError(f"extract-embs: {stats}")
            rows = read_csv(str(inp["csv"]))
            direct = engine.extract_many([dict(
                visual_feats=np.load(feats_dir / f"{r['filename']}.npy"),
                text=r["phrase"], word_boundaries=c["wbs"],
                wav=wavfile.read(inp["videos"] / f"{r['filename']}.wav")[1]
                .astype(np.float32)) for r, c in zip(rows, inp["clips"])],
                modalities="vta", batch_size=4)
            embs_dir = embs_root / "vta"
            worst = dict(err=0.0, cos=1.0)
            for r, want in zip(rows, direct):
                a, b = r["filename"].split("/")
                with open(embs_dir / f"{a}__{b}.pkl", "rb") as f:
                    got = pickle.load(f)
                if got["info"] != r:
                    raise AssertionError(f"extract-embs info {got['info']} "
                                         f"!= the CSV row {r}")
                e = compare(got, want, f"extract-embs {r['filename']} vs "
                                       f"extract_many")
                worst = dict(err=max(worst["err"], e["err"]),
                             cos=min(worst["cos"], e["cos"]))
            out["extract_embs"] = dict(wall_s=runs.walls["extract-embs"],
                                       vs_extract_many=worst)

            # (f) the evals, host and device
            evals = {}
            for name, extra in (("eval-retrieval", []),
                                ("eval-spotting", []),
                                ("eval-asd", ["--file", str(inp["csv"])])):
                argv = [name, "--path", str(embs_dir), *extra]
                host = last_json(runs.run(name, argv))
                dev = last_json(runs.run(f"{name} --on_device",
                                         argv + ["--on_device"]))
                for key in host if name == "eval-retrieval" else [None]:
                    d, h = (dev[key], host[key]) if key else (dev, host)
                    _same_rates(d, h, f"{name}{' ' + key if key else ''}",
                                exact=("MR", "correct", "total",
                                       "evaluated"))
                evals[name] = dev
            out["evals"] = evals

            # (g) verify against goldens the engine wrote
            golden = root / "golden"
            golden.mkdir()
            for i in (1, 2):
                base = inp["samples"] / f"sample{i}"
                planar, _ = inp["decode"](str(base.with_suffix(".avi")))
                text, wbs = load_text(str(base.with_suffix(".txt")))
                wav = load_audio_any(str(base.with_suffix(".wav")))
                for combo in ("vta", "vt", "va", "ta", "v", "t", "a"):
                    g = engine.extract(
                        modalities=combo,
                        frames=planar if "v" in combo else None,
                        text=text if "t" in combo else None,
                        word_boundaries=wbs,
                        wav=wav if "a" in combo else None,
                        fname=f"sample{i}_{combo}")
                    with open(golden / f"sample{i}_{combo}.pkl", "wb") as f:
                        pickle.dump(g, f)
            argv = ["verify", *ckpt, "--samples_dir", str(inp["samples"]),
                    "--golden_dir", str(golden)]
            verdict = last_json(runs.run("verify", argv + [
                "--res_dir", str(root / "verify")]))
            log(f"  verify: ok {verdict['ok']}, combos {verdict['combos']}, "
                f"retrieval smoke {verdict.get('retrieval_smoke')}")
            if not verdict["ok"] or len(verdict["combos"]) != 7:
                raise AssertionError(f"verify: {verdict}")
            with open(golden / "sample2_vta.pkl", "rb") as f:
                g = pickle.load(f)
            g["gesture_emb"][3] = -g["gesture_emb"][3]
            with open(golden / "sample2_vta.pkl", "wb") as f:
                pickle.dump(g, f)
            bad = last_json(runs.run("verify (one golden row negated)",
                                     argv + ["--res_dir",
                                             str(root / "verify_bad")],
                                     expect_code=1))
            failed = [(s, c) for s, rep in bad["samples"].items()
                      for c, r in rep.items() if not r["ok"]]
            log(f"  verify with sample2_vta's gesture row 3 negated: exit 1, "
                f"failed {failed}")
            if failed != [("sample2", "vta")]:
                raise AssertionError(f"verify: failed {failed}")
            out["verify"] = dict(combos=verdict["combos"], failed_bad=failed)

            # (h) warmup at the main path's buckets
            table = last_json(runs.run("warmup", [
                "warmup", "--checkpoint_path", str(npz["jegal"]),
                *ckpt[2:], "--modalities", "vta", "--t_buckets", "128",
                "--s_buckets", "32", "--w_buckets", "16", "--mel_buckets",
                "512"]))
            log(f"  warmup: {table}")
            out["warmup"] = table

            # (i) train on phase 7a's corpus
            corpus = root / "corpus"
            corpus.mkdir()
            csv, feat_dir = write_corpus(corpus)
            result = last_json(runs.run("train", [
                "train", "--file_path", str(csv), "--feature_dir",
                str(feat_dir), "--checkpoint_path", str(npz["jegal"]),
                "--roberta_path", str(npz["roberta"]), "--tokenizer_path",
                "piece-tokenizer", "--steps", "3", "--batch_size", "8",
                "--log_path", str(corpus / "train.jsonl")]))
            log(f"  train: {result}")
            if result["steps"] != 3 or not math.isfinite(
                    result["final_loss"]):
                raise AssertionError(f"train: {result}")
            if runs.launches["train"] != {"encoder_stack": 3,
                                          "flash_attention": 27}:
                raise AssertionError(f"train: launches "
                                     f"{runs.launches['train']}")
            out["train"] = result
    finally:
        WordTokenizer.from_file = from_file
        C._decode_for_features = decode
    out["walls_s"] = runs.walls
    out["launches"] = runs.launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"cli: phase 10 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: serving
# ---------------------------------------------------------------------------

# the load of 11b, at the buckets `serve` warms (T 128; S 64, W 16, mel 512):
# binary planar vta clips (T 100 and 125) with every fifth a raw-frames one
# the server repacks, then JSON ta requests, from SERVE_THREADS threads of
# a client process
SERVE_CLIPS = (100, 125)
SERVE_VTA = 80
SERVE_TA = 128
SERVE_THREADS = 8
SERVE_MAX_BATCH = 8
SERVE_WINDOW_MS = 5
# 12 words of 3-5 pieces: 49 tokens, the S 64 bucket that `serve` warms
SERVE_TEXT = ("remarkable gentlemen carefully considered extraordinary "
              "circumstances whenever thunderstorms approached "
              "neighbouring countryside villages")
# 11c: a clip of an un-warmed T bucket (256) among warmed ones, then
# SERVE_THREADS more of that bucket, which replay its new graph
SERVE_COLD_T = 200
# `python -m jegal_torch serve` in a child process; the card machine has no
# tokenizers wheel, so --tokenizer_path resolves to PieceTokenizer there,
# as in phase 10; everything else is the CLI's own
SERVE_CHILD = (
    "import runpy, sys\n"
    "sys.path.insert(0, sys.argv.pop(1))\n"
    "import chip_smoke\n"
    "from jegal_torch.text.tokenizer import WordTokenizer\n"
    "WordTokenizer.from_file = classmethod(\n"
    "    lambda cls, path, **kw: cls(chip_smoke.PieceTokenizer(), **kw))\n"
    "sys.argv[0] = 'jegal_torch'\n"
    "runpy.run_module('jegal_torch', run_name='__main__', alter_sys=True)\n")
# the load client of 11b and 11c, a process of its own: its threads encode
# and send the bodies without sharing the server's interpreter lock
SERVE_CLIENT = (
    "import sys\n"
    "sys.path.insert(0, sys.argv.pop(1))\n"
    "import chip_smoke\n"
    "chip_smoke.load_client(*sys.argv[1:])\n")


def http(url: str, path: str = "/healthz", body: bytes | None = None,
         content_type: str | None = None, binary_answer: bool = False):
    """One request -> (status, answer): a dict for JSON, (meta, arrays)
    for a binary answer; HTTP errors are answers too."""
    import urllib.error
    import urllib.request

    from jegal_torch import serving

    headers = {}
    if content_type:
        headers["Content-Type"] = content_type
    if binary_answer:
        headers["Accept"] = serving.BINARY_CONTENT_TYPE
    req = urllib.request.Request(url + path, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            data = resp.read()
            if resp.headers.get("Content-Type") == \
                    serving.BINARY_CONTENT_TYPE:
                return resp.status, serving.decode_binary(data)
            return resp.status, json.loads(data)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def encode_request(meta: dict, arrays: dict, binary: bool):
    """An /extract body, binary (JGL1 framing) or JSON (arrays as base64
    .npy) -> (body, content type, binary)."""
    from jegal_torch import serving

    if binary:
        return (serving.encode_binary(meta, arrays),
                serving.BINARY_CONTENT_TYPE, True)
    return (json.dumps(dict(meta, **{k: serving.encode_array(v)
                                     for k, v in arrays.items()})).encode(),
            "application/json", False)


def post(url: str, body: bytes, content_type: str, binary: bool):
    """POST an encoded /extract body, a binary answer asked for a binary
    body -> (status, result dict with numpy embeddings | error dict)."""
    from jegal_torch import serving

    status, ans = http(url, "/extract", body, content_type,
                       binary_answer=binary)
    if status != 200:
        return status, ans
    if binary:
        rmeta, rarr = ans
        return status, dict(gesture_emb=rarr.get("gesture_emb"),
                            content_emb=rarr.get("content_emb"),
                            info=rmeta["info"])
    return status, dict(gesture_emb=serving.decode_array(ans["gesture_emb"]),
                        content_emb=serving.decode_array(ans["content_emb"]),
                        info=ans["info"])


def serve_request(url: str, meta: dict, arrays: dict, binary: bool):
    """An /extract request, binary both ways or JSON."""
    return post(url, *encode_request(meta, arrays, binary))


def hold_answer(got, want, what: str) -> dict:
    """A served answer against `extract`'s on the same sample: each
    embedding within SLICE_ATOL and min row cosine SLICE_MIN_COS, info
    equal. -> the worst error and cosine."""
    import numpy as np

    worst = dict(err=0.0, cos=1.0)
    for key in ("gesture_emb", "content_emb"):
        a, b = got[key], want[key]
        if b is None:
            if a is not None:
                raise AssertionError(f"{what}: {key} should be None")
            continue
        if a is None or a.shape != b.shape:
            raise AssertionError(f"{what}: {key} shape "
                                 f"{None if a is None else a.shape}, want "
                                 f"{b.shape}")
        err = float(np.abs(a - b).max())
        cos = float((a * b).sum(-1).min())
        if not (err <= SLICE_ATOL and cos >= SLICE_MIN_COS):
            raise AssertionError(f"{what}: {key} max abs err {err:.3e}, min "
                                 f"row cosine {cos:.8f}")
        worst = dict(err=max(worst["err"], err), cos=min(worst["cos"], cos))
    if got["info"] != want["info"]:
        raise AssertionError(f"{what}: info {got['info']} != "
                             f"{want['info']}")
    return worst


def serve_samples():
    """The samples of phase 11: planar `vta` clips at T 100 and 125 (two
    of each, their chin rows folded in by the numpy repack) and their raw
    frames, SERVE_TEXT with phase 4's 5 s wav and 12 word boundaries: the
    buckets `serve` warms (T 128, S 64, W 16, mel 512)."""
    import numpy as np

    from jegal_torch.ops.video import s2d_repack

    base = clip(125, 12, SEED + 3)
    content = dict(text=SERVE_TEXT, word_boundaries=base["word_boundaries"])
    clips = []
    for i, t in enumerate(SERVE_CLIPS * 2):
        rng = np.random.default_rng(SEED + 80 + i)
        raw = rng.integers(0, 256, (t, 270, 480, 3), dtype=np.uint8)
        clips.append(dict(raw=raw, frames=s2d_repack(
            raw, rng.integers(90, 200, t)), t=t))
    return base, content, clips


def cold_clip(i: int):
    """Clip i of the un-warmed T bucket of 11c: (planar frames, raw)."""
    import numpy as np

    from jegal_torch.ops.video import s2d_repack

    rng = np.random.default_rng(SEED + 90 + i)
    raw = rng.integers(0, 256, (SERVE_COLD_T, 270, 480, 3), dtype=np.uint8)
    return s2d_repack(raw, rng.integers(90, 200, SERVE_COLD_T))


def request_of(kind: str, i: int, base, content, clips):
    """(meta, arrays, the extract() kwargs) of request i of a kind: 'vta'
    planar frames, 'vta_raw' raw frames (the server repacks them at the
    fallback chin row), 'cold' 11c's planar clip i at SERVE_COLD_T (all
    binary); 'ta' (JSON)."""
    import numpy as np

    meta = dict(modalities="ta" if kind == "ta" else "vta",
                fname=f"{kind}_{i}", **content)
    if kind == "ta":
        wav = base["wav"] if i % 2 == 0 else np.roll(base["wav"], 1000)
        return meta, {"wav": wav}, dict(wav=wav)
    if kind == "cold":
        frames = cold_clip(i)
    else:
        c = clips[i % len(clips)]
        frames = c["raw"] if kind == "vta_raw" else c["frames"]
    return meta, {"frames": frames, "wav": base["wav"]}, dict(
        frames=frames, wav=base["wav"])


def sample_key(kind: str, i: int, n_clips: int):
    """The sample a request of `request_of` carries, its fname aside."""
    return kind, (i % n_clips if kind.startswith("vta") else
                  i % 2 if kind == "ta" else i)


def expected(engine, meta, kw):
    return engine.extract(modalities=meta["modalities"], fname=meta["fname"],
                          text=meta["text"],
                          word_boundaries=meta["word_boundaries"], **kw)


def run_serve_cli(root: Path, gp, jp, rp, engine) -> dict:
    """Phase 11a: `python -m jegal_torch serve --port 0 --warmup_combos
    vta,ta --warmup_frames planar --batch_window_ms 5 --max_batch 8` in a
    child process on phase 9's reference-format files; /healthz, a JSON
    `ta`, a binary planar and a binary raw `vta` request (the raw one
    repacked by the C++ repack in the server), a 422 sample and a 400
    frames shape, each 200 held to `engine.extract` on the same sample;
    /healthz's graph count unchanged by them (they fall in the buckets
    the CLI warms, so none captures); then the server is stopped."""
    import selectors

    import numpy as np
    import torch

    from jegal_torch import serving
    from jegal_torch.convert import init_gestsync_audio_params

    gs_tree = dict(gp, **init_gestsync_audio_params(
        torch.Generator().manual_seed(SEED + 11)))
    src, _ = write_checkpoints(root, gs_tree, jp,
                               {"embeddings": rp["embeddings"],
                                "layers": rp["layers"]})
    argv = ["serve", "--checkpoint_path", str(src["jegal"]),
            "--checkpoint_path_gestsync", str(src["gestsync"]),
            "--roberta_path", str(src["roberta"]),
            "--tokenizer_path", "piece-tokenizer", "--port", "0",
            "--warmup_combos", "vta,ta", "--warmup_frames", "planar",
            "--batch_window_ms", str(SERVE_WINDOW_MS),
            "--max_batch", str(SERVE_MAX_BATCH)]
    log(f"serve: python -m jegal_torch {' '.join(argv)} (a child process; "
        f"--tokenizer_path resolves to PieceTokenizer there, as in phase "
        f"10)")
    err_path = root / "serve_stderr.txt"
    out: dict = {}
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", SERVE_CHILD,
                                 str(ROOT), *argv], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
    try:
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=600):
            raise AssertionError("serve printed no first line in 600 s")
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"serve exited {proc.wait()}: "
                                 f"{err_path.read_text()[-3000:]}")
        first = json.loads(line)
        out["start_s"] = time.perf_counter() - t0
        log(f"  first line after {out['start_s']:.2f} s: {first}")
        url = first["serving"]
        if (first["warmed"] != ["vta", "ta"] or url.endswith(":0")
                or first["batch_window_ms"] != SERVE_WINDOW_MS):
            raise AssertionError(f"serve's first line: {first}")
        status, health = http(url)
        log(f"  GET /healthz: {status} {health}")
        if status != 200 or not health["ok"] or health["graphs"] != 3 \
                or health["queue_depth"] != 0:
            raise AssertionError(f"/healthz: {status} {health}")
        base, content, clips = serve_samples()
        worst = {}
        for kind, binary in (("ta", False), ("vta", True),
                             ("vta_raw", True)):
            meta, arrays, kw = request_of(kind, 0, base, content, clips)
            t1 = time.perf_counter()
            status, got = serve_request(url, meta, arrays, binary)
            wall = time.perf_counter() - t1
            if status != 200:
                raise AssertionError(f"{kind}: HTTP {status} {got}")
            worst[kind] = hold_answer(got, expected(engine, meta, kw),
                                      f"serve CLI, {kind}")
            log(f"  {kind} ({'binary' if binary else 'JSON'}): 200 in "
                f"{1e3 * wall:.1f} ms, against extract: max abs err "
                f"{worst[kind]['err']:.3e}, min row cosine "
                f"{worst[kind]['cos']:.8f}")
        meta, arrays, _ = request_of("ta", 0, base, content, clips)
        bad = dict(meta, word_boundaries=meta["word_boundaries"][:3])
        status, ans = serve_request(url, bad, arrays, binary=False)
        log(f"  ta with 3 boundaries for 12 words: {status} {ans}")
        if status != 422:
            raise AssertionError(f"want 422, got {status}")
        status, ans = serve_request(url, dict(meta, modalities="vta"), {
            "frames": np.zeros((4, 135, 240, 3), np.uint8),
            "wav": arrays["wav"]}, binary=True)
        log(f"  frames (4, 135, 240, 3): {status} {ans}")
        if status != 400:
            raise AssertionError(f"want 400, got {status}")
        status, health = http(url)
        log(f"  GET /healthz after the requests: {status} {health}")
        if status != 200 or health["graphs"] != 3:
            raise AssertionError(f"a request captured in the CLI's server: "
                                 f"{health}")
        out["answers"] = worst
    finally:
        proc.terminate()
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        proc.stdout.close()
    log(f"  server stopped (exit {code}); its stderr: "
        f"{err_path.read_text()[-500:]!r}")
    out["first_line"] = first
    return out


def union_ms(prof) -> float:
    """Device busy ms of a `profiled()` window: the union of its device
    events' intervals (`window_events`)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in window_events(prof))
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def load_client(url: str, out_dir: str) -> None:
    """The client process of 11b and 11c (SERVE_CLIENT). Per JSON line on
    stdin, {"name", "jobs": [[kind, i], ...], "threads"}: it encodes every
    job's body (`request_of` on `serve_samples`; binary but for `ta`)
    first, prints "ready", and on "go" sends them from `threads` threads,
    pickles each job's (status, answer, seconds) and the wall seconds to
    <out_dir>/<name>.pkl and prints "done". An empty line ends it."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    base, content, clips = serve_samples()
    while line := sys.stdin.readline().strip():
        cmd = json.loads(line)
        bodies = [encode_request(*request_of(kind, i, base, content,
                                             clips)[:2], kind != "ta")
                  for kind, i in cmd["jobs"]]
        print("ready", flush=True)
        if sys.stdin.readline().strip() != "go":
            raise SystemExit("load client: want 'go'")

        def one(req):
            t0 = time.perf_counter()
            status, ans = post(url, *req)
            return status, ans, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(cmd["threads"]) as ex:
            res = list(ex.map(one, bodies))
        wall = time.perf_counter() - t0
        with open(Path(out_dir) / f"{cmd['name']}.pkl", "wb") as f:
            pickle.dump(dict(results=res, wall_s=wall), f)
        print("done", flush=True)


class LoadClient:
    """SERVE_CLIENT in a child process, driven a command at a time:
    `prepare` (it encodes the bodies), `go`, `finish` -> the results with
    requests/s, p50 / p99 / max ms."""

    def __init__(self, url: str, out_dir: Path):
        import selectors

        self.out_dir = out_dir
        self.err = out_dir / "client_stderr.txt"
        with open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", SERVE_CLIENT, str(ROOT), url,
                 str(out_dir)], cwd=ROOT, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True)
        self.sel = selectors.DefaultSelector()
        self.sel.register(self.proc.stdout, selectors.EVENT_READ)

    def _send(self, line: str):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def _expect(self, word: str, timeout: float = 600):
        while True:
            if not self.sel.select(timeout=timeout):
                raise AssertionError(f"load client: no '{word}' in "
                                     f"{timeout} s")
            line = self.proc.stdout.readline()
            if not line:
                raise AssertionError(f"load client exited "
                                     f"{self.proc.wait()}: "
                                     f"{self.err.read_text()[-3000:]}")
            if line.strip() == word:
                return
            log(f"  load client: {line.rstrip()}")

    def prepare(self, name: str, jobs, threads: int = SERVE_THREADS):
        self.name, self.n = name, len(jobs)
        self._send(json.dumps(dict(name=name, jobs=jobs, threads=threads)))
        self._expect("ready")

    def go(self):
        self._send("go")

    def finish(self) -> dict:
        import pickle

        import numpy as np

        self._expect("done", timeout=900)
        with open(self.out_dir / f"{self.name}.pkl", "rb") as f:
            res = pickle.load(f)
        lat = np.array([dt for _, _, dt in res["results"]]) * 1e3
        return dict(res, requests=self.n,
                    requests_per_s=self.n / res["wall_s"],
                    p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)),
                    max_ms=float(lat.max()))

    def close(self):
        if self.proc.poll() is None:
            try:
                self._send("")
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.proc.stdin.close()
        self.proc.stdout.close()


def vta_jobs(n: int):
    """11b's vta jobs: every fifth a raw-frames one."""
    return [["vta_raw" if i % 5 == 4 else "vta", i] for i in range(n)]


def warm_measured(eng, *args) -> list:
    """`serving.warmup(eng, *args)` with each of its engine.warmup calls
    recorded: combo, frames kind, seconds, and the MiB the capture added
    to the memory the caching allocator holds (its cache emptied around
    each call)."""
    import torch

    from jegal_torch import serving

    records = []
    warmup = eng.warmup

    def measured(**kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        warmup(**kw)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        records.append(dict(combo=kw["modalities"], batch=kw["batch"],
                            frames_kind=kw.get("frames_kind"),
                            seconds=seconds, reserved_mib=(
                                torch.cuda.memory_reserved() - before)
                            / 2 ** 20))

    eng.warmup = measured
    try:
        serving.warmup(eng, *args)
    finally:
        del eng.warmup
    return records


def run_serve_load(gp, jp, rp, engine) -> dict:
    """Phase 11b and 11c, the server in-process and its clients in a
    process of their own (LoadClient): `serving.warmup` as the CLI of 11a
    runs it (vta and ta, planar frames, batch 8, the default buckets) on a
    new engine, each capture's MiB measured around it; `create_server`
    with the batcher. (b) SERVE_VTA binary `vta` clips (T 100 and 125,
    every fifth raw frames the server repacks) then SERVE_TA JSON `ta`
    requests from SERVE_THREADS client threads, once measured
    (requests/s, p50 / p99, the batch sizes the batcher formed, the host
    ms a request in decode_binary and in the repack) with every graph
    replay recorded, once profiled (device busy and idle share over each
    kind's window); no capture inside a request, kernels 2, 7, 3, 4 and 5
    in the replayed graphs, every answer equal to `extract`. (c) a clip of
    an un-warmed T bucket sent while the client's other threads are
    mid-request: it captures one graph, answers, and the others answer as
    before; then SERVE_THREADS clips of that bucket replay it. Before the
    load, decode_binary and the repack are timed alone on one clip."""
    import tempfile
    import threading

    import numpy as np

    from jegal_torch import serving
    from jegal_torch.api import JegalEngine
    from jegal_torch.ops.kernels import _build

    eng = JegalEngine(jp, gp, roberta_params=rp, tokenizer=word_tokenizer())
    base, content, clips = serve_samples()
    out: dict = {}
    t0 = time.perf_counter()
    records = warm_measured(eng, ("vta", "ta"), SERVE_WINDOW_MS,
                            SERVE_MAX_BATCH, "planar")
    out["warmup_s"] = time.perf_counter() - t0
    for r in records:
        log(f"  serving.warmup {r['combo']} frames {r['frames_kind']} batch "
            f"{r['batch']}: {r['seconds']:.3f} s, reserved "
            f"+{r['reserved_mib']:.1f} MiB")
    out["warmup"] = records
    n_graphs = len(eng.cached_graphs)
    if n_graphs != 3:
        raise AssertionError(f"serve's warm-up of vta, ta and planar "
                             f"frames should capture 3 graphs, got "
                             f"{n_graphs}")

    # the server's two host steps on the longest clip with no other thread
    # busy, the yardstick of their ms a request under load
    c = clips[1]
    body = encode_request({"fname": "alone"}, {"frames": c["frames"],
                                               "wav": base["wav"]}, True)[0]
    alone = {}
    for name, fn, arg in (("decode_binary", serving.decode_binary, body),
                          ("repack", serving._repack_raw, c["raw"])):
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn(arg)
            times.append(1e3 * (time.perf_counter() - t1))
        alone[name] = statistics.median(times)
    log(f"  alone, median of 5: decode_binary of a {len(body) / 1e6:.1f} MB "
        f"body {alone['decode_binary']:.1f} ms, repack of T {c['t']} raw "
        f"frames {alone['repack']:.1f} ms")
    out["alone_ms"] = alone

    batches: list = []
    host_ms: dict = {"decode_binary": [], "repack": []}
    extract_many = eng.extract_many

    def counted_many(samples, **kw):
        batches.append(len(samples))
        return extract_many(samples, **kw)

    def timed(name, fn):
        def call(*a):
            t1 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                host_ms[name].append(1e3 * (time.perf_counter() - t1))
        return call

    originals = serving.decode_binary, serving._repack_raw
    eng.extract_many = counted_many
    serving.decode_binary = timed("decode_binary", serving.decode_binary)
    serving._repack_raw = timed("repack", serving._repack_raw)
    server = serving.create_server(eng, port=0,
                                   batch_window_ms=SERVE_WINDOW_MS,
                                   max_batch=SERVE_MAX_BATCH)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    client = LoadClient(url, Path(tmp.name))
    try:
        phases = (("vta", vta_jobs(SERVE_VTA)),
                  ("ta", [["ta", i] for i in range(SERVE_TA)]))
        # the references on phase 4's engine
        keys = {sample_key(k, i, len(clips)): (k, i)
                for _, jobs in phases for k, i in jobs}
        keys.update({("cold", i): ("cold", i)
                     for i in range(SERVE_THREADS + 1)})
        want = {}
        for key, (k, i) in keys.items():
            meta, _, kw = request_of(k, i, base, content, clips)
            want[key] = expected(engine, meta, kw)

        def check(jobs, res, what="served"):
            """Each answer against the reference of its sample, with the
            request's own fname in `info`."""
            worst = dict(err=0.0, cos=1.0)
            for (k, i), (status, ans, _) in zip(jobs, res):
                if status != 200:
                    raise AssertionError(f"{k}_{i}: HTTP {status} {ans}")
                w = want[sample_key(k, i, len(clips))]
                got = hold_answer(ans, dict(w, info=dict(
                    w["info"], fname=f"{k}_{i}")), f"{what} {k}_{i}")
                worst = dict(err=max(worst["err"], got["err"]),
                             cos=min(worst["cos"], got["cos"]))
            return worst

        def mean(xs):
            return float(np.mean(xs)) if xs else None

        def ms(x):
            return "none" if x is None else f"{x:.1f} ms"

        for rep in ("measured", "profiled"):
            rep_out: dict = {}
            for kind, jobs in phases:
                client.prepare(f"{rep}_{kind}", jobs)
                _build.reset_launches()
                batches.clear()
                for v in host_ms.values():
                    v.clear()
                ctx = profiled() if rep == "profiled" else \
                    contextlib.nullcontext()
                with ctx as prof:
                    t_window = time.perf_counter()
                    stats, ran = replayed(
                        lambda: (client.go(), client.finish())[1])
                    window_s = time.perf_counter() - t_window
                counted = {k: n for k, n in _build.LAUNCHES.items() if n}
                if counted or len(eng.cached_graphs) != n_graphs:
                    raise AssertionError(
                        f"{rep} {kind}: a request captured a graph: "
                        f"counters {counted}, {len(eng.cached_graphs)} "
                        f"graphs, {n_graphs} warmed")
                r = rep_out[kind] = dict(
                    {k: v for k, v in stats.items() if k != "results"},
                    batches=list(batches), replayed={
                        k: n for k, n in ran.items() if n},
                    decode_binary_ms=mean(host_ms["decode_binary"]),
                    repack_ms=mean(host_ms["repack"]),
                    repacks=len(host_ms["repack"]),
                    vs_extract=check(jobs, stats["results"]))
                log(f"  {rep} {kind}: {len(jobs)} requests from "
                    f"{SERVE_THREADS} threads of the client process in "
                    f"{r['wall_s']:.3f} s: {r['requests_per_s']:.2f} "
                    f"requests/s, p50 {r['p50_ms']:.1f} ms, p99 "
                    f"{r['p99_ms']:.1f} ms, max {r['max_ms']:.1f} ms; "
                    f"{len(batches)} batches {r['batches']}; decode_binary "
                    f"{ms(r['decode_binary_ms'])} a request; repack "
                    f"{ms(r['repack_ms'])} a raw request ({r['repacks']}); "
                    f"replayed {r['replayed']}; against extract max abs "
                    f"err {r['vs_extract']['err']:.3e}, min row cosine "
                    f"{r['vs_extract']['cos']:.8f}")
                if rep == "profiled":
                    busy = union_ms(prof)
                    r.update(window_ms=1e3 * window_s, busy_ms=busy,
                             idle_share=1 - busy / (1e3 * window_s))
                    log(f"  profiled {kind} window {1e3 * window_s:.1f} "
                        f"ms: device busy {busy:.1f} ms, idle share "
                        f"{r['idle_share']:.3f}")
            out[rep] = rep_out
        served = {}
        for kind, _ in phases:
            for k, n in out["measured"][kind]["replayed"].items():
                served[k] = served.get(k, 0) + n
        out["launches"] = served
        missing = [k for k in ("stem_band", "conv2", "attn_sublayer",
                               "ffn_sublayer", "encoder_stack")
                   if not served.get(k)]
        if missing:
            raise AssertionError(f"served batches launched no {missing}: "
                                 f"{served}")
        if not out["measured"]["vta"]["repacks"]:
            raise AssertionError("no raw-frames request was repacked")
        log(f"  served batches replayed {served}; no capture in a request "
            f"(counters 0, {n_graphs} graphs)")

        # (c) a capture under load: the client's other threads send warm
        # clips, this process the cold one once they are mid-request
        warm_jobs = [["vta", i] for i in range(3 * (SERVE_THREADS - 1))]
        cold_body = encode_request(*request_of("cold", 0, base, content,
                                               clips)[:2], True)
        client.prepare("under_capture", warm_jobs, SERVE_THREADS - 1)
        _build.reset_launches()
        client.go()
        time.sleep(0.5)               # the warm clients are mid-request
        t1 = time.perf_counter()
        status, got = post(url, *cold_body)
        cold_s = time.perf_counter() - t1
        warm = client.finish()
        if status != 200:
            raise AssertionError(f"the cold clip: HTTP {status} {got}")
        want_cold = want["cold", 0]
        cold_worst = hold_answer(got, dict(want_cold, info=dict(
            want_cold["info"], fname="cold_0")), "the cold clip")
        captured = {k: n for k, n in _build.LAUNCHES.items() if n}
        new = len(eng.cached_graphs) - n_graphs
        warm_worst = check(warm_jobs, warm["results"], "under a capture,")
        log(f"  capture under load: the T {SERVE_COLD_T} clip answered in "
            f"{1e3 * cold_s:.1f} ms with {new} new graph(s), counters "
            f"{captured}; against extract max abs err "
            f"{cold_worst['err']:.3e}, min row cosine "
            f"{cold_worst['cos']:.8f}; the {len(warm_jobs)} warm clips sent "
            f"meanwhile: max abs err {warm_worst['err']:.3e}, min row "
            f"cosine {warm_worst['cos']:.8f}")
        if new != 1 or not captured.get("stem_band"):
            raise AssertionError(f"the cold clip should capture one graph: "
                                 f"{new} new, counters {captured}")
        # that bucket is warm now: its clips replay the new graph
        cold_jobs = [["cold", i] for i in range(1, SERVE_THREADS + 1)]
        client.prepare("cold_bucket", cold_jobs)
        _build.reset_launches()
        after, ran = replayed(lambda: (client.go(), client.finish())[1])
        counted = {k: n for k, n in _build.LAUNCHES.items() if n}
        after_worst = check(cold_jobs, after["results"], "T 256 bucket")
        log(f"  {len(cold_jobs)} more T {SERVE_COLD_T} clips: "
            f"{after['requests_per_s']:.2f} requests/s, replayed "
            f"{ {k: n for k, n in ran.items() if n} }, counters {counted}; "
            f"max abs err {after_worst['err']:.3e}, min row cosine "
            f"{after_worst['cos']:.8f}")
        if counted or len(eng.cached_graphs) != n_graphs + 1:
            raise AssertionError(f"the T 256 bucket captured again: "
                                 f"counters {counted}, "
                                 f"{len(eng.cached_graphs)} graphs")
        out["capture_under_load"] = dict(
            ms=1e3 * cold_s, new_graphs=new, counters=captured,
            cold=cold_worst, warm=warm_worst, after=after_worst)
        status, health = http(url)
        log(f"  GET /healthz: {status} {health}")
        if status != 200 or health["graphs"] != n_graphs + 1:
            raise AssertionError(f"/healthz: {status} {health}")
    finally:
        client.close()
        tmp.cleanup()
        serving.decode_binary, serving._repack_raw = originals
        server.shutdown()
        server.server_close()
    return out


def run_serve(gp, jp, rp, engine) -> dict:
    """Phase 11: (a) the CLI server in a child process, (b) load and (c) a
    capture under load in-process. -> the `serve` line's dict."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = {"cli": run_serve_cli(Path(tmp), gp, jp, rp, engine)}
    out.update(run_serve_load(gp, jp, rp, engine))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve: phase 11 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the bf16 engine
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# the bf16 engine's embeddings against the float32 engine's on the card,
# and against the bf16 engine's on the CPU (the CPU runs the bf16 layer
# loop, which rounds at other sites than the kernels' twins)
BF16_F32_COS = 0.9995
BF16_CPU_COS = 0.999
# a bf16 kernel against the float32 kernel on the same (bf16) inputs
BF16_KERNEL_F32_COS = 0.9999
# profiled replays of 12b's raw clip whose median busy is reported
BUSY_REPLAYS = 5
VTA_LAUNCHES_BF16 = dict(stem_band_bf16=1, conv2_bf16=1,
                         attn_sublayer_bf16=15, ffn_sublayer_bf16=15,
                         encoder_stack_bf16=1)
SIGNATURES_BF16 = {"stem_band_bf16": ("stem_band_bf16_kernel",),
                   "stem_pool_bf16": ("stem_pool_bf16_kernel", "Bf16Frames"),
                   "stem_pool_planar_bf16": ("stem_pool_bf16_kernel",
                                             "PlanarU8"),
                   "conv2_bf16": ("conv2_bf16_kernel",),
                   "attn_sublayer_bf16": ("attention_core",),
                   "flash_attention_bf16": ("flash_attention_bf16",)}
# the bf16 engine with stem_impl="window" on phase 4's clip: kernel 1b's
# entry in place of kernel 2b
WINDOW_LAUNCHES_BF16 = dict(VTA_LAUNCHES_BF16, stem_band_bf16=0,
                            stem_pool_bf16=1)
WINDOW_PLANAR_LAUNCHES_BF16 = dict(VTA_LAUNCHES_BF16, stem_band_bf16=0,
                                   stem_pool_planar_bf16=1)


def bf16_bars():
    """tests/bf16_bars.py (numpy and torch only; in every checkout)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import bf16_bars

    return bf16_bars


def bound_bf16(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) of a bf16 kernel: its products at the dense bf16
    tensor-core rate, or its bytes at the HBM rate."""
    t_op, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem else "bytes")


def hold_bf16(got, twin, f32_out, what: str, stack: bool = False) -> dict:
    """A bf16 kernel's output against its bf16 twin (2 bf16 ulps an element,
    4 for a stack of layers, min row cosine 0.9999: tests/bf16_bars.py) and
    against the float32 kernel on the same inputs (min row cosine
    BF16_KERNEL_F32_COS)."""
    import torch

    bars = bf16_bars()
    if got.dtype != torch.bfloat16 or not bool(torch.isfinite(
            got.float()).all()):
        raise AssertionError(f"{what}: not finite bf16 ({got.dtype})")
    max_ulps = bars.STACK_MAX_ULPS if stack else bars.MAX_ULPS
    worst, cos = bars.check_kernel_bar(got, twin, what, max_ulps)
    cos32 = bars.min_row_cos(got, f32_out)
    err = (got.float() - twin.float()).abs().max().item()
    ok = cos32 >= BF16_KERNEL_F32_COS
    log(f"  {what}: vs its bf16 twin {worst:.2f} bf16 ulps (bar "
        f"{max_ulps}), min row cosine {cos:.7f} (bar {bars.KERNEL_COS}), "
        f"max abs err {err:.3e}; vs the float32 kernel min row cosine "
        f"{cos32:.7f} (bar {BF16_KERNEL_F32_COS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the bf16 kernel is too far from the "
                             f"float32 kernel")
    return dict(max_abs_err=err, worst_ulps=worst, min_row_cos=cos,
                min_row_cos_f32=cos32)


# --against DIR: the kernels this tree redesigned (1b; 2b, 6b and 7b take
# their turns too when their sources are listed) as another checkout (DIR)
# builds them, each timed in turns with this tree's in 12a: {source stem:
# ctypes library}
REPLACED: dict = {}
REPLACED_SOURCES = ("stem",)


def build_replaced(tree: Path) -> dict:
    """Compile `tree`'s csrc/ sources of REPLACED_SOURCES (all at once,
    this tree's nvcc flags) under build/jegal_torch_kernels/ and load
    them."""
    import ctypes

    from jegal_torch.ops.kernels import _build

    csrc = tree / "jegal_torch" / "csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in REPLACED_SOURCES:
        lib = _build.BUILD_DIR / f"replaced-{stem}.so"
        procs[stem] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tree}'s {stem}.cu:\n{out}")
        libs[stem] = ctypes.CDLL(str(lib))
    void, i32 = ctypes.c_void_p, ctypes.c_int
    sigs = {"flash_attention": {"jt_flash_attention_bf16":
                                [void] * 5 + [i32] * 4
                                + [ctypes.c_float, void]},
            "conv2": {"jt_conv2_bf16": [void] * 5 + [i32] * 3 + [void]},
            "stem_band": {e: [void] * 5 + [i32] * 3 + [void]
                          for e in ("jt_stem_band_bf16",
                                    "jt_stem_band_planar_bf16")},
            "stem": {e: [void] * 5 + [i32] * 3 + [void]
                     for e in ("jt_stem_pool_bf16",
                               "jt_stem_pool_planar_bf16")}}
    for stem in REPLACED_SOURCES:
        for entry, args in sigs[stem].items():
            getattr(libs[stem], entry).argtypes = args
    log(f"the replaced kernels built from {tree}")
    return libs


def replaced_turns(fn, old, what: str, cold: bool) -> dict:
    """The kernel and the one it replaces (`old`, the --against tree's) on
    the same inputs, timed in turns (old, new, new, old; CUDA events,
    median of 20 each); the new one must be the faster in both pairs."""
    ms = [cuda_ms(f, cold=cold) for f in (old, fn, fn, old)]
    log(f"  {what} in turns with the replaced kernel: replaced {ms[0]:.4f} "
        f"/ {ms[3]:.4f} ms, this kernel {ms[1]:.4f} / {ms[2]:.4f} ms")
    if not (ms[1] < ms[0] and ms[2] < ms[3]):
        raise AssertionError(f"{what}: slower than the kernel it replaces")
    return dict(replaced_ms=[ms[0], ms[3]], ms_in_turns=[ms[1], ms[2]])


def bf16_row(what: str, fn, plain, f32_fn, library, flops: float,
             nbytes: float, cold: bool, stack: bool = False,
             replaced=None, **extra) -> dict:
    """One bf16 kernel at one shape: held (hold_bf16), a second launch
    bit-identical, then timed beside its float32 kernel on the same
    inputs, its twin and its bf16 PyTorch chain (CUDA events, median of
    20; the L2 flushed before each launch when `cold`)."""
    row = dict(extra, **hold_bf16(fn(), plain(), f32_fn(), what, stack))
    relaunch_identical(fn, what)
    b_ms, b_by = bound_bf16(flops, nbytes)
    row.update(ms=cuda_ms(fn, cold=cold), ms_f32=cuda_ms(f32_fn, cold=cold),
               plain_ms=cuda_ms(plain, cold=cold),
               library_ms=cuda_ms(library, cold=cold), bound_ms=b_ms,
               bound_by=b_by)
    log(f"  {what} ms {row['ms']:.4f} (float32 kernel {row['ms_f32']:.4f}) "
        f"plain {row['plain_ms']:.4f} library (bf16) "
        f"{row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}, bf16), "
        f"{100 * b_ms / row['ms']:.1f} % of it")
    if replaced is not None:
        row.update(replaced_turns(fn, replaced, what, cold))
    return row


def check_bf16_tower(gp, dev, stem_inputs):
    """12a: both stems' bf16 variants (kernel 2b, band, and 1b, window) on
    both entries at the T = 128 bucket (152 padded frames of 270x480) and
    block 2's on the band stem's output."""
    import torch
    import torch.nn.functional as F

    from jegal_torch.api import _cast_tree
    from jegal_torch.ops.kernels import conv2 as C2
    from jegal_torch.ops.kernels import stem as S
    from jegal_torch.ops.video import edge_pad, mask_frames_device, s2d_repack

    bf = torch.bfloat16
    u8, chin = stem_inputs[0], stem_inputs[1]
    gp16 = _cast_tree(gp, bf)
    frames = mask_frames_device(u8, chin, bf)              # (152, 270, 480, 3)
    planar = torch.from_numpy(s2d_repack(u8.cpu().numpy(),
                                         chin.cpu().numpy())).to(dev)
    planar = edge_pad(planar).contiguous()                 # (152, 90, 27, 160)
    ops = S.stem_kernel_params(gp16["net_vid"][0])
    ops32 = (ops[0].float(), ops[1], ops[2])
    blk = gp16["net_vid"][0]
    bn = {k: v.float() for k, v in blk["bn"].items()}
    xc = frames.permute(3, 0, 1, 2)[None].contiguous()
    wc = blk["conv"]["kernel"].permute(4, 3, 0, 1, 2).contiguous()

    def library():
        y = F.conv3d(xc, wc, blk["conv"]["bias"], stride=(1, 3, 3))
        y = F.relu(F.batch_norm(y, bn["mean"].to(bf), bn["var"].to(bf),
                                bn["scale"].to(bf), bn["bias"].to(bf), False,
                                0.0, 1e-5))
        return F.max_pool3d(y, (1, 3, 3), (1, 2, 2))

    t_in, h, w = frames.shape[:3]
    t_out, j, wp, c = S.pooled_shape(t_in, h, w)
    flops = stem_flops(t_in, h, w)
    out_b = 2.0 * t_out * j * wp * c
    replaced = {"window": (None, None), "band": (None, None)}
    old_out = torch.empty(t_out, j, wp, c, device=dev, dtype=bf)
    pw = S.planar_weight(ops[0]).contiguous()
    # the --against tree's 1b and 2b, on the same operands
    for impl, source, entry in (("window", "stem", "jt_stem_pool"),
                                ("band", "stem_band", "jt_stem_band")):
        if source in REPLACED:
            lib = REPLACED[source]
            replaced[impl] = (
                functools.partial(launch_replaced,
                                  getattr(lib, entry + "_bf16"), frames,
                                  ops[0], ops[1], ops[2], old_out, t_in, h,
                                  w),
                functools.partial(launch_replaced,
                                  getattr(lib, entry + "_planar_bf16"),
                                  planar, pw, ops[1], ops[2], old_out, t_in,
                                  h // 3, w // 3))
    rows = {}
    for impl, name in (("band", "stem_band_bf16"),
                       ("window", "stem_pool_bf16")):
        log(f"bf16 {impl} stem: frames {tuple(frames.shape)} bf16, planar "
            f"{tuple(planar.shape)} uint8 -> {(t_out, j, wp, c)} bf16; "
            f"float entry {stem_info_bf16(False, impl)}, planar entry "
            f"{stem_info_bf16(True, impl)}")
        rows[impl] = [
            bf16_row(f"{name} (float entry)",
                     lambda: S.stem_pool(frames, *ops, impl=impl),
                     lambda: S.stem_pool_plain(frames, *ops),
                     lambda: S.stem_pool(frames.float(), *ops32, impl=impl),
                     library, flops,
                     2.0 * frames.numel() + 2.0 * ops[0].numel() + 8 * c
                     + out_b, False, replaced=replaced[impl][0],
                     shape="float frames (152, 270, 480, 3)"),
            bf16_row(f"{name} (planar entry)",
                     lambda: S.stem_pool_planar(planar, *ops, impl=impl),
                     lambda: S.stem_pool_planar_plain(planar, *ops),
                     lambda: S.stem_pool_planar(planar, *ops32, impl=impl),
                     library, flops,
                     1.0 * planar.numel() + 2.0 * ops[0].numel() + 8 * c
                     + out_b, False, replaced=replaced[impl][1],
                     shape="planar frames (152, 90, 27, 160)")]
    x = S.stem_pool(frames, *ops)                          # (148, 43, 78, 64)
    c2 = C2.conv2_kernel_params(gp16["net_vid"][1])
    c2_32 = (c2[0].float(), c2[1], c2[2])
    blk2 = gp16["net_vid"][1]
    xn = x.permute(0, 3, 1, 2).contiguous()
    w2 = blk2["conv"]["kernel"][0].permute(3, 2, 0, 1).contiguous()
    bn2 = {k: v.to(bf) for k, v in blk2["bn"].items()}

    def library2():
        y = F.conv2d(xn, w2, blk2["conv"].get("bias"), stride=2)
        return F.relu(F.batch_norm(y, bn2["mean"], bn2["var"], bn2["scale"],
                                   bn2["bias"], False, 0.0, 1e-5))

    _, j2, w2_, _ = C2.out_shape(*x.shape[:3])
    m = x.shape[0] * j2 * w2_
    log(f"bf16 block 2: {tuple(x.shape)} bf16 -> "
        f"{C2.out_shape(*x.shape[:3])}; kernel "
        f"{kernel_info_bf16(C2.kernel_info_bf16(), 'kernel 7b')}")
    replaced = None
    if "conv2" in REPLACED:
        old_out = torch.empty(x.shape[0], 128, j2, w2_, device=dev, dtype=bf)
        replaced = lambda: launch_replaced(   # noqa: E731
            REPLACED["conv2"].jt_conv2_bf16, x, c2[0], c2[1], c2[2], old_out,
            *x.shape[:3])
    conv2_row = bf16_row(
        "conv2_bf16", lambda: C2.conv2_bn_relu(x, *c2),
        lambda: C2.conv2_bn_relu_plain(x, *c2),
        lambda: C2.conv2_bn_relu(x.float(), *c2_32), library2,
        2.0 * m * 128 * 1600,
        2.0 * (x.numel() + c2[0].numel() + m * 128) + 8 * 128, False,
        replaced=replaced, shape=f"{tuple(x.shape)}")
    return rows["band"], [conv2_row], rows["window"]


def kernel_info_bf16(info: dict, what: str) -> dict:
    """A kernel's registers, spills, shared memory and blocks an SM: no
    spill, and at least one block an SM."""
    if info["spill_bytes"] or info["blocks_per_sm"] < 1:
        raise AssertionError(f"{what}: spills or does not fit an SM: {info}")
    return info


def launch_replaced(entry, *args):
    """One launch of a replaced kernel's C entry on tensors (as pointers)
    and numbers, on the current stream."""
    import torch

    from jegal_torch.ops.kernels import _build

    rc = entry(*(_build.ptr(a) if isinstance(a, torch.Tensor) else a
                 for a in args), _build.stream_ptr(args[0].device))
    if rc != 0:
        raise RuntimeError(f"the replaced kernel failed: error {rc}")


def stem_info_bf16(planar: bool, impl: str) -> dict:
    from jegal_torch.ops.kernels import stem as S

    info = S.kernel_info(planar, impl=impl, bf16=True)
    if info["spill_bytes"]:
        raise AssertionError(f"the bf16 {impl} stem spills: {info}")
    return info


def check_bf16_flash(dev):
    """12a: the flash kernel's bf16 variant (kernel 6b) at the bf16 long
    clip's (1, 8, 1024, 64) with phase 8's key mask (1000 valid keys) and
    at a text shape with head width 96, (8, 8, 128, 96), each batch row
    with a pad tail; the bf16 SDPA with an additive -1e9 mask as its
    library chain. `launches_per_clip` counts a bf16 long clip's."""
    import torch

    from jegal_torch.ops.kernels import flash_attention as FA

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 16)
    rows = []
    for label, (b, h, t, d), valid, per_clip_n in (
            ("gesture encoder, long clip (1, 8, 1024, 64)", (1, 8, 1024, 64),
             1000, 6),
            ("text encoder (8, 8, 128, 96)", (8, 8, 128, 96), 100, 0)):
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dev).to(bf)
                   for _ in range(3))
        mask = torch.zeros(b, t)
        mask[:, :valid] = 1.0
        mask = mask.to(dev)
        log(f"bf16 flash attention: {label}, {valid} valid keys; kernel "
            f"{kernel_info_bf16(FA.kernel_info_bf16(d), 'kernel 6b')}")
        replaced = None
        if "flash_attention" in REPLACED:
            old_out = torch.empty_like(q)
            replaced = functools.partial(
                launch_replaced,
                REPLACED["flash_attention"].jt_flash_attention_bf16, q, k, v,
                mask, old_out, b, h, t, d, 1.0 / math.sqrt(d))
        rows.append(bf16_row(
            "flash_attention_bf16",
            lambda: FA.flash_attention(q, k, v, mask),
            lambda: FA.flash_attention_plain(q, k, v, mask),
            lambda: FA.flash_attention(q.float(), k.float(), v.float(), mask),
            lambda: _library_flash(q, k, v, mask),
            4.0 * b * h * t * t * d, 2.0 * 4 * b * h * t * d + 4.0 * b * t,
            False, replaced=replaced, shape=label,
            launches_per_clip=per_clip_n))
    return rows


def sublayer_kernels_bf16(plans, prenorm: bool, attn: bool) -> int:
    """Device operations of one bf16 sublayer under the plans of its two
    products (gemm_plan.plan_bf16): the memset of the tile counters when a
    product splits, the pre-LN, the two products (each reducing its own
    split), the attention core, and the post-LN's row pass."""
    return (int(any(p[2] > 1 for p in plans)) + int(prenorm) + 2
            + int(attn) + int(not prenorm))


def bf16_split(fn, what: str, products, plans, prenorm: bool, attn: bool,
               core_flops: float, core_bytes: float) -> dict:
    """12a's per-launch split of a bf16 sublayer: its device operations
    (torch.profiler, one warm launch after an L2 flush), each product's
    device ms beside its own bf16 bound (2 M N K at the dense bf16 rate,
    or A, B and the bf16 output read and written once) and its plan, the
    attention core's ms beside its bound, and the row passes' ms."""
    want = sublayer_kernels_bf16(plans, prenorm, attn)
    kernels = kernel_breakdown(lambda: (flush_l2(), fn())[1], what, None)
    kernels = [(n, ms) for n, ms in kernels if "elementwise" not in n
               and "fill" not in n.lower()]
    if CHECK_KERNEL_COUNTS and len(kernels) != want:
        raise AssertionError(f"{what}: {len(kernels)} device operations, "
                             f"the design runs {want}: {kernels}")
    gemms = [ms for n, ms in kernels if "gemm_wg_kernel" in n]
    prods = []
    for (m, n, k), plan, ms in zip(products, plans, gemms):
        b_ms, b_by = bound_bf16(2.0 * m * n * k, 2.0 * (m * k + k * n + m * n))
        prods.append(dict(mnk=[m, n, k], plan=list(plan), ms=ms,
                          bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms))
        log(f"    product {(m, n, k)} plan {tuple(plan)}: {ms:.4f} ms, bound "
            f"{b_ms:.4f} ({b_by}), {100 * b_ms / ms:.1f} % of it")
    out = dict(device_ops=len(kernels), products=prods,
               row_pass_ms=sum(ms for n, ms in kernels if "row_norm" in n),
               other_ms=sum(ms for n, ms in kernels if "Memset" in n
                            or "emset" in n))
    if attn:
        core = sum(ms for n, ms in kernels if "attention_core_bf16" in n)
        b_ms, b_by = bound_bf16(core_flops, core_bytes)
        out["attention_core"] = dict(ms=core, bound_ms=b_ms, bound_by=b_by,
                                     bound_share=b_ms / core)
        log(f"    attention core: {core:.4f} ms, bound {b_ms:.4f} ({b_by}), "
            f"{100 * b_ms / core:.1f} % of it")
    log(f"    row passes {out['row_pass_ms']:.4f} ms; {len(kernels)} device "
        f"operations a launch")
    return out


def check_bf16_encoders(gp, jp, rp, dev, text_mask, ids32, mask32):
    """12a: the bf16 attention and FFN sublayers at phase 3's three shapes,
    each launch split into its products, core and row passes, and the bf16
    XLM-R stack at the clip's 32 rows."""
    import torch

    from jegal_torch.api import _cast_tree
    from jegal_torch.config import NUM_HEADS
    from jegal_torch.models import roberta as R
    from jegal_torch.ops.kernels import fused_layer as FL
    from jegal_torch.ops.kernels import gemm_plan as GP

    bf = torch.bfloat16
    for tile in sorted(GP.TILES_BF16):
        info = FL.gemm_info_bf16(tile)
        log(f"bf16 wgmma product, tile {tile}: {info}")
        if info["spill_bytes"]:
            raise AssertionError(f"the bf16 product spills: {info}")
    for dk in FL.HEAD_DIMS:
        for packed in (True, False):
            info = FL.attention_info(dk, packed, bf16=True)
            log(f"bf16 attention core, dk {dk}, "
                f"{'packed' if packed else 'streamed'}: {info}")
            if info["spill_bytes"]:
                raise AssertionError(f"the bf16 attention core spills: "
                                     f"{info}")
    rows = {"attn_sublayer_bf16": [], "ffn_sublayer_bf16": []}
    for label, w, x32, seg, pre, kind, km, per_clip_n, _ in _sublayer_cases(
            _cast_tree(gp, bf), _cast_tree(jp, bf), dev, text_mask):
        log(f"bf16 sublayers: {label}")
        x = x32.to(bf)
        w32 = {k: v.float() for k, v in w.items()}
        lw = dict(w)
        for name in ("wqkv", "wo", "w1", "w2"):
            lw[name + "_t"] = w[name].t().contiguous()
        r, d = x.shape
        dff, heads = w["w1"].shape[1], NUM_HEADS
        n, dk = r // seg, d // heads
        kw = dict(prenorm=pre, ln_kind=kind)
        attn_flops = 2.0 * r * d * 4 * d + 4.0 * n * heads * seg * seg * dk
        attn_bytes = 2.0 * (2 * r * d + 4 * d * d) + 4.0 * (6 * d) + (
            4.0 * r if km is not None else 0.0)
        ffn_flops = 4.0 * r * d * dff
        ffn_bytes = 2.0 * (2 * r * d + 2 * d * dff) + 4.0 * (dff + 3 * d)
        sms = GP.sm_count(dev)
        products = FL.stack_products(r, d, dff)
        plans = [GP.plan_bf16(*p, sms) for p in products]

        def attn():
            return FL.attn_sublayer(x, w, seg, heads, kmask=km, **kw)

        def ffn():
            return FL.ffn_sublayer(x, w, **kw)

        row = bf16_row(
            "attn_sublayer_bf16", attn,
            lambda: FL.attn_sublayer_plain(x, w, seg, heads, kmask=km, **kw),
            lambda: FL.attn_sublayer(x.float(), w32, seg, heads, kmask=km,
                                     **kw),
            lambda: _library_attn(x, lw, seg, heads, pre, km), attn_flops,
            attn_bytes, True, shape=label, launches_per_clip=per_clip_n)
        row.update(bf16_split(
            attn, "bf16 attn_sublayer launch", products[:2], plans[:2], pre,
            True, 4.0 * n * heads * seg * seg * dk,
            2.0 * 4 * r * d + (4.0 * r if km is not None else 0.0)))
        rows["attn_sublayer_bf16"].append(row)
        row = bf16_row(
            "ffn_sublayer_bf16", ffn,
            lambda: FL.ffn_sublayer_plain(x, w, **kw),
            lambda: FL.ffn_sublayer(x.float(), w32, **kw),
            lambda: _library_ffn(x, lw, pre), ffn_flops, ffn_bytes, True,
            shape=label, launches_per_clip=per_clip_n)
        row.update(bf16_split(ffn, "bf16 ffn_sublayer launch", products[2:],
                              plans[2:], pre, False, 0.0, 0.0))
        rows["ffn_sublayer_bf16"].append(row)

    cfg = R.XLMR_BASE
    d, heads, dff = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    rp16 = _cast_tree(rp, bf)
    ops = R.stack_layers(rp16)["fused_ops"]
    ops32 = {k: v.float() for k, v in ops.items()}
    lt = [{k: ops[k][l].t().contiguous() for k in ("wqkv", "wo", "w1", "w2")}
          for l in range(cfg.num_layers)]
    b, seg = ids32.shape
    x1 = R.embeddings(rp16["embeddings"], ids32.to(dev), cfg).reshape(
        b * seg, d)
    km1 = mask32.to(dev).reshape(-1)
    stack = []
    # the clip's text (R 32), and an extract_many chunk of 4 texts (R 128)
    for n_text, per_clip_n in ((1, 1), (4, 0)):
        x, km = x1.repeat(n_text, 1), km1.repeat(n_text)
        r = x.shape[0]
        kw = dict(prenorm=False, ln_kind="std", activation="gelu", kmask=km)
        n, dk = r // seg, d // heads
        flops = cfg.num_layers * (2.0 * r * d * 4 * d + 4.0 * r * d * dff
                                  + 4.0 * n * heads * seg * seg * dk)
        nbytes = sum(t.numel() * t.element_size() for t in ops.values()) \
            + 2.0 * 2 * r * d + 4.0 * r
        label = (f"XLM-R R={r} seg={seg} ({n_text} x the 12-word text) "
                 f"masked")
        log(f"bf16 encoder stack: {label}")

        def run(x=x, kw=kw):
            return FL.encoder_stack(x, ops, seg, heads, **kw)

        row = bf16_row(
            "encoder_stack_bf16", run,
            lambda x=x, kw=kw: FL.encoder_stack_plain(x, ops, seg, heads,
                                                      **kw),
            lambda x=x, kw=kw: FL.encoder_stack(x.float(), ops32, seg, heads,
                                                **kw),
            lambda x=x, km=km: _library_stack(x, ops, lt, seg, heads, km),
            flops, nbytes, True, stack=True, shape=label,
            launches_per_clip=per_clip_n)
        row["device_kernels"] = len(kernel_breakdown(
            run, "bf16 encoder stack launch"))
        stack.append(row)
    return rows, stack


def hold_cos(a, b, bar: float, what: str) -> float:
    """Min row cosine of two runs' unit-norm embeddings against `bar`."""
    worst = 1.0
    for key in ("gesture_emb", "content_emb"):
        x, y = a.get(key), b.get(key)
        if x is None and y is None:
            continue
        if x is None or y is None or x.shape != y.shape:
            raise AssertionError(f"{what}, {key}: shapes differ")
        cos = float((x * y).sum(-1).min())
        log(f"  {what}, {key}: min row cosine {cos:.7f} (bar {bar}) "
            f"{'ok' if cos >= bar else 'FAIL'}")
        if cos < bar:
            raise AssertionError(f"{what}, {key}: min row cosine {cos}")
        worst = min(worst, cos)
    return worst


def bf16_launches(want: dict) -> dict:
    """A float32 path's launch counts as the bf16 path's."""
    return {k + "_bf16": n for k, n in want.items() if n}


def graph_mib(eng, fn, want: dict, what: str):
    """The first call of a graph key: its launches (drive_call) and the MiB
    its capture added to the caching allocator's reserved memory."""
    import torch

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # what is held, not what is cached
        return torch.cuda.memory_reserved()

    before = reserved()
    res, ran = drive_call(fn, want, what)
    mib = (reserved() - before) / 2 ** 20
    log(f"  {what}: the capture added {mib:.1f} MiB")
    return res, ran, mib


def serve_load(eng, n_vta: int, n_ta: int, threads: int = 4) -> dict:
    """A few requests in-process, from `threads` threads, against a server
    on `eng` (batch window 5 ms, batch 8) warmed as `serve` warms it:
    binary planar `vta` clips (T 100 and 125) and JSON `ta` requests at
    the warmed buckets. -> answers, requests/s, and the profiled window's
    device busy ms and idle share."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from jegal_torch import serving

    base, content, clips = serve_samples()
    serving.warmup(eng, ("vta", "ta"), SERVE_WINDOW_MS, SERVE_MAX_BATCH,
                   "planar")
    n_graphs = len(eng.cached_graphs)
    server = serving.create_server(eng, host="127.0.0.1", port=0,
                                   batch_window_ms=SERVE_WINDOW_MS,
                                   max_batch=SERVE_MAX_BATCH)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    jobs = [("vta", i) for i in range(n_vta)] + [("ta", i)
                                                 for i in range(n_ta)]

    def one(job):
        kind, i = job
        meta, arrays, kw = request_of(kind, i, base, content, clips)
        return job, serve_request(url, meta, arrays, kind != "ta"), (meta, kw)

    try:
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(one, jobs[:threads]))           # connections warm
            t0 = time.perf_counter()
            answers = list(ex.map(one, jobs))
            wall = time.perf_counter() - t0
            with profiled() as prof:
                t1 = time.perf_counter()
                list(ex.map(one, jobs))
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t1
    finally:
        server.shutdown()
        server.server_close()
    if len(eng.cached_graphs) != n_graphs:
        raise AssertionError("a served request captured a graph")
    busy = union_ms(prof)
    out = dict(requests=len(jobs), wall_s=wall,
               requests_per_s=len(jobs) / wall,
               device_busy_ms=busy, idle_share=1 - busy / (1e3 * pwall))
    log(f"  served {len(jobs)} requests ({n_vta} binary planar vta, {n_ta} "
        f"JSON ta) from {threads} threads in {wall:.3f} s: "
        f"{out['requests_per_s']:.2f} requests/s; profiled window device "
        f"busy {busy:.1f} ms, idle share {out['idle_share']:.3f}")
    return answers, out


def run_bf16(gp, jp, rp, engine, sample, raw_res):
    """12b: the bf16 engine (`JegalEngine(dtype=torch.bfloat16)`) on phase
    4's raw and planar `vta` clip, `extract_many` over phase 6c's eight
    planar clips and a served load, each beside the float32 engine's
    figures of this run, and phase 5's small clip card against the bf16
    engine on the CPU."""
    import torch

    from jegal_torch.api import JegalEngine
    from jegal_torch.ops.video import s2d_repack

    bf = torch.bfloat16
    planar = dict(sample, frames=s2d_repack(sample["frames"],
                                            sample["chin_rows"]))
    del planar["chin_rows"]
    t_clip = sample["frames"].shape[0]
    stats: dict = {}
    engines = {}
    band_res = {}
    for label, dt in (("float32", torch.float32), ("bf16", bf)):
        eng = JegalEngine(jp, gp, roberta_params=rp, dtype=dt,
                          tokenizer=word_tokenizer())
        engines[label] = eng
        want = VTA_LAUNCHES if dt == torch.float32 else VTA_LAUNCHES_BF16
        log(f"{label} engine: the raw vta clip")
        res, ran, mib = graph_mib(
            eng, lambda: eng.extract(modalities="vta", **sample), want,
            f"the {label} raw vta path")
        check_embeddings(res, t_clip, 12)
        s = dict(graph_mib=mib, launches=ran)
        if dt == bf:
            s["graph"] = replay_check(eng, "the bf16 raw vta clip", bf16=True)
            s["vs_f32"] = hold_cos(res, raw_res, BF16_F32_COS,
                                   "bf16 vs float32 engine, raw vta clip")
            res_p, _ = drive(eng, planar, "vta", want,
                             "the bf16 planar vta path")
            check_embeddings(res_p, t_clip, 12)
            s["planar_vs_f32"] = hold_cos(
                res_p, raw_res, BF16_F32_COS,
                "bf16 planar vs float32 raw, vta clip")
            s["planar_vs_raw"] = hold_cos(
                res_p, res, BF16_F32_COS, "bf16 planar vs bf16 raw, vta clip")
            band_res = dict(raw=res, planar=res_p)
        else:
            compare(res, raw_res, "a new float32 engine vs phase 4")
        stats[label] = s
    # warm ms/clip in turns (float32, bf16, bf16, float32: the host's clock
    # drifts within a run), then each engine's profile and host split
    for label in ("float32", "bf16", "bf16", "float32"):
        log(f"{label} engine: warm raw vta clips")
        stats[label].setdefault("warm", []).append(
            warm_ms(engines[label], sample, "vta"))
    for label, eng in engines.items():
        s = stats[label]
        s["ms_per_clip"] = statistics.mean(w["ms_per_clip"]
                                           for w in s["warm"])
        s["clips_per_s"] = 1e3 / s["ms_per_clip"]
        # one profiled replay's busy swings between replays: the median of
        # BUSY_REPLAYS, with their spread
        runs = sorted((profile_clip(eng, sample, "vta")
                       for _ in range(BUSY_REPLAYS)),
                      key=lambda r: r["device_busy_ms"])
        s.update(runs[len(runs) // 2])
        s["device_busy_ms_runs"] = [r["device_busy_ms"] for r in runs]
        log(f"  {label} raw vta clip: device busy median "
            f"{s['device_busy_ms']:.3f} ms of {BUSY_REPLAYS} replays, "
            f"{runs[0]['device_busy_ms']:.3f}-{runs[-1]['device_busy_ms']:.3f}")
        s["idle_share"] = 1 - s["device_busy_ms"] / s["wall_ms"]
        s["host"] = host_split(lambda: eng.extract("vta", **sample),
                               f"{label} raw vta clip")

    samples = many_samples()
    want32, n_chunks = many_launches(samples, 4, {})
    many = {}
    for label, eng in engines.items():
        want = want32 if label == "float32" else bf16_launches(want32)
        log(f"{label} engine: extract_many over 8 planar vta clips")
        results, _, mib = graph_mib(
            eng, lambda: eng.extract_many(samples, "vta", batch_size=4),
            want, f"one {label} extract_many call ({n_chunks} chunks)")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.extract_many(samples, "vta", batch_size=4)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        prof = profile_run(lambda: eng.extract_many(samples, "vta",
                                                    batch_size=4),
                           f"{label} extract_many call")
        many[label] = results
        stats[label]["extract_many"] = dict(
            graph_mib=mib, ms_per_call=1e3 * wall,
            clips_per_s=len(samples) / wall, **prof,
            idle_share=1 - prof["device_busy_ms"] / prof["wall_ms"])
        log(f"  {label} extract_many: {len(samples) / wall:.3f} clips/s "
            f"(median of 3)")
    worst = 1.0
    for s, a, b in zip(samples, many["bf16"], many["float32"]):
        check_embeddings(a, s["frames"].shape[0], 12)
        worst = min(worst, hold_cos(a, b, BF16_F32_COS,
                                    f"bf16 vs float32 extract_many, "
                                    f"{s['fname']}"))
    stats["bf16"]["extract_many"]["vs_f32"] = worst

    answers = {}
    for label, eng in engines.items():
        log(f"{label} engine: served load")
        answers[label], stats[label]["serve"] = serve_load(eng, 16, 16)
    worst = 1.0
    for (job, (status, got), (meta, kw)) in answers["bf16"]:
        if status != 200:
            raise AssertionError(f"bf16 server: {job} answered {status}")
        want = expected(engines["float32"], meta, kw)
        for key in ("gesture_emb", "content_emb"):
            if got.get(key) is not None and got[key].dtype.name != "float32":
                raise AssertionError(f"{job}: {key} left as {got[key].dtype}")
        worst = min(worst, hold_cos(got, want, BF16_F32_COS,
                                    f"bf16 served {job} vs float32 extract"))
    stats["bf16"]["serve"]["vs_f32"] = worst

    small = dict(clip(16, 4, SEED + 4), text="the quick brown fox")
    on_card = engines["bf16"].extract(modalities="vta", **small)
    on_cpu = JegalEngine(jp, gp, device="cpu", roberta_params=rp, dtype=bf,
                         tokenizer=word_tokenizer()).extract(
                             modalities="vta", **small)
    check_embeddings(on_card, 16, 4)
    check_embeddings(on_cpu, 16, 4)
    stats["bf16"]["card_vs_cpu"] = hold_cos(
        on_card, on_cpu, BF16_CPU_COS,
        "bf16 engine card vs CPU, 16-frame 4-word vta clip")
    launches = {"vta": stats["bf16"]["launches"]}
    stats["bf16"]["window"], launches["window"] = run_bf16_window(
        gp, jp, rp, sample, planar, raw_res, band_res)
    stats["bf16"]["long_clip"], launches["long"] = run_bf16_long_clip(
        jp, engines)
    for eng in engines.values():
        eng.close()
    return launches, stats


def run_bf16_window(gp, jp, rp, sample, planar, raw_res, band_res):
    """12b (i): a bf16 engine with stem_impl="window" on phase 4's raw and
    planar `vta` clip: kernel 1b's entry launched once a clip in place of
    2b, the raw clip's replay against an eager run, each held to the
    float32 engine's raw rows and to the bf16 band engine's rows of the
    same frames. -> (stats, {counter: launches} of the two runs)."""
    import torch

    from jegal_torch.api import JegalEngine

    eng = JegalEngine(jp, gp, roberta_params=rp, dtype=torch.bfloat16,
                      stem_impl="window", tokenizer=word_tokenizer())
    t_clip = sample["frames"].shape[0]
    log("bf16 engine, stem_impl='window': the raw vta clip")
    res, ran = drive(eng, sample, "vta", WINDOW_LAUNCHES_BF16,
                     "the bf16 raw vta path, window stem")
    check_embeddings(res, t_clip, 12)
    out = dict(graph=replay_check(eng, "the bf16 raw vta clip, window stem",
                                  bf16=True),
               vs_f32=hold_cos(res, raw_res, BF16_F32_COS,
                               "bf16 window vs float32 engine, raw vta clip"),
               vs_band=hold_cos(res, band_res["raw"], BF16_F32_COS,
                                "bf16 window vs bf16 band, raw vta clip"))
    res_p, ran_p = drive(eng, planar, "vta", WINDOW_PLANAR_LAUNCHES_BF16,
                         "the bf16 planar vta path, window stem")
    check_embeddings(res_p, t_clip, 12)
    out.update(
        planar_vs_f32=hold_cos(res_p, raw_res, BF16_F32_COS,
                               "bf16 window planar vs float32 raw, vta clip"),
        planar_vs_band=hold_cos(res_p, band_res["planar"], BF16_F32_COS,
                                "bf16 window vs bf16 band, planar vta clip"),
        stems_equal=window_equals_band(gp, sample, planar, eng.device))
    eng.close()
    launches = {k: ran[k] + ran_p[k] for k in ran}
    out["launches"] = dict(raw=ran, planar=ran_p)
    return out, launches


def window_equals_band(gp, sample, planar, dev) -> bool:
    """12b (i): kernel 1b's pooled output against kernel 2b's on phase
    4's clip as the bf16 engine feeds it (masked and edge-padded bf16
    frames; the planar frames edge-padded), bit for bit on both entries:
    the two kernels sum each position's products in one order."""
    import torch

    from jegal_torch.api import _cast_tree
    from jegal_torch.ops.kernels import stem as S
    from jegal_torch.ops.video import edge_pad, mask_frames_device

    ops = S.stem_kernel_params(_cast_tree(gp, torch.bfloat16)["net_vid"][0])
    frames = mask_frames_device(
        torch.from_numpy(sample["frames"]).to(dev),
        torch.from_numpy(sample["chin_rows"]).to(dev), torch.bfloat16)
    pl = edge_pad(torch.from_numpy(planar["frames"]).to(dev)).contiguous()
    for what, run in (
            ("raw", lambda impl: S.stem_pool(frames, *ops, impl=impl)),
            ("planar", lambda impl: S.stem_pool_planar(pl, *ops, impl=impl))):
        window, band = run("window"), run("band")
        if not torch.equal(window, band):
            err = (window.float() - band.float()).abs().max().item()
            raise AssertionError(f"kernel 1b differs from 2b on the {what} "
                                 f"clip: max abs err {err:.3e}")
        log(f"  kernel 1b equals 2b bit for bit on the {what} clip "
            f"{tuple(window.shape)}")
    return True


def run_bf16_long_clip(jp, engines):
    """12b (ii): phase 8's 1000-frame clip (T bucket 1024, past the fused
    gate) through the bf16 engine: the gesture encoder's layer loop on
    kernel 6b, 6 launches; the replay against an eager run; warm ms
    (medians of two turns of 5) beside the float32 engine's, each
    engine's device time by kernel (one profiled call); held to the
    float32 engine's rows and to a bf16 engine's on the CPU. -> (stats,
    the bf16 run's launches)."""
    import numpy as np
    import torch

    from jegal_torch.api import JegalEngine

    feats = np.random.default_rng(SEED + 8).standard_normal(
        (1000, 1024), dtype=np.float32)
    sample = dict(visual_feats=feats)
    log("long clip in bf16: v on (1000, 1024) visual features, T bucket "
        "1024")
    res = {}
    res["float32"], _ = drive(engines["float32"], sample, "v",
                              dict(flash_attention=6),
                              "the float32 long clip")
    res["bf16"], ran = drive(engines["bf16"], sample, "v",
                             dict(flash_attention_bf16=6),
                             "the bf16 long clip")
    out = dict(graph=replay_check(engines["bf16"], "the bf16 long clip",
                                  bf16=True))
    walls: dict = {"float32": [], "bf16": []}
    for label in ("float32", "bf16", "bf16", "float32"):
        for _ in range(5):
            t0 = time.perf_counter()
            engines[label].extract(modalities="v", **sample)
            walls[label].append(1e3 * (time.perf_counter() - t0))
    for label, eng in engines.items():
        out[f"profile_{label}"] = profile_run(
            lambda: eng.extract(modalities="v", **sample),
            f"{label} long clip")
    on_cpu = JegalEngine(jp, device="cpu", dtype=torch.bfloat16).extract(
        modalities="v", **sample)
    for r in (res["float32"], res["bf16"], on_cpu):
        e = r["gesture_emb"]
        if e.shape != (1000, 512) or not np.isfinite(e).all():
            raise AssertionError(f"long clip gesture_emb {e.shape}")
    out.update(
        ms_per_clip=statistics.median(walls["bf16"]),
        ms_per_clip_f32=statistics.median(walls["float32"]),
        vs_f32=hold_cos(res["bf16"], res["float32"], BF16_F32_COS,
                        "bf16 vs float32 engine, long clip"),
        card_vs_cpu=hold_cos(res["bf16"], on_cpu, BF16_CPU_COS,
                             "bf16 engine card vs CPU, long clip"))
    log(f"  warm long clip: bf16 {out['ms_per_clip']:.3f} ms, float32 "
        f"{out['ms_per_clip_f32']:.3f} ms (medians of 10 in turns)")
    return out, ran


# the bf16 kernels whose design is their own, not the float32 kernel's
REDESIGNED = {
    "stem_band_bf16": "K in dy rows of 24, each A register one 32-bit load "
                      "from a two-copy bf16 ring; the five weight planes "
                      "packed once a block; 16 warps of one m64 tile each, "
                      "persistent",
    "stem_pool_bf16": "2b's K layout and products on a window tile: each A "
                      "register one 32-bit load from a two-copy bf16 patch "
                      "a tap; the five weight planes packed once a block; "
                      "16 warps of one m64 tile each, persistent over "
                      "(strip, row tile, frame)",
    "stem_pool_planar_bf16": "as stem_pool_bf16, the planar bytes converted "
                             "into both copies a warp a row",
    "flash_attention_bf16": "q * scale and p as two bf16 pieces held in "
                            "registers; wgmma m64n64k16 at head width 64, "
                            "mma.sync m16n8k16 bf16 at 96",
    "conv2_bf16": "persistent wgmma m64n128k16 implicit GEMM, one stage a "
                  "(kh, kw) tap in the 128-byte swizzle",
    "attn_sublayer_bf16": "the wgmma bf16 product and the one-walk bf16 "
                          "attention core",
    "ffn_sublayer_bf16": "the wgmma bf16 product",
}


def bf16_kernel_rows(tower, encoders, flash, launches) -> list:
    """The `kernels` line's bf16 rows: launches from the bf16 engine's raw
    `vta` clip (the window stem's from the window engine's raw clip for
    the float entry and planar clip for the planar entry, the flash
    attention's from the bf16 long clip); the band stem's time at its
    float entry (the planar entry under per_launch), the window stem's at
    the entry of its row, the sublayers' and the stack's per clip, the
    flash attention's per long clip."""
    stem_rows, conv2_rows, window_rows = tower
    sub, stack = encoders
    out = []
    for name, source, replaces, rows, clip_sum, path in (
            ("stem_band_bf16", "jegal_torch/csrc/stem_band.cu",
             "jegal_tpu/ops/pallas/stem.py:219", stem_rows, False, "vta"),
            ("stem_pool_bf16", "jegal_torch/csrc/stem.cu",
             "jegal_tpu/ops/pallas/stem.py:80", window_rows[:1], False,
             "window"),
            ("stem_pool_planar_bf16", "jegal_torch/csrc/stem.cu",
             "jegal_tpu/ops/pallas/stem.py:80", window_rows[1:], False,
             "window"),
            ("conv2_bf16", "jegal_torch/csrc/conv2.cu",
             "jegal_tpu/ops/pallas/conv2.py:76", conv2_rows, False, "vta"),
            ("attn_sublayer_bf16", "jegal_torch/csrc/fused_layer.cu",
             "jegal_tpu/ops/pallas/fused_layer.py:104",
             sub["attn_sublayer_bf16"], True, "vta"),
            ("ffn_sublayer_bf16", "jegal_torch/csrc/fused_layer.cu",
             "jegal_tpu/ops/pallas/fused_layer.py:173",
             sub["ffn_sublayer_bf16"], True, "vta"),
            ("encoder_stack_bf16", "jegal_torch/csrc/encoder_stack.cu",
             "jegal_tpu/ops/pallas/fused_layer.py:221", stack, True, "vta"),
            ("flash_attention_bf16", "jegal_torch/csrc/flash_attention.cu",
             "jegal_tpu/ops/pallas/flash_attention.py:30", flash, True,
             "long")):
        ran = launches[path]
        if not ran.get(name):
            raise AssertionError(f"{name}: no launch on the bf16 path")
        if clip_sum:
            want = sum(r["launches_per_clip"] for r in rows)
            if ran[name] != want:
                raise AssertionError(f"{name}: {ran[name]} launches, "
                                     f"the timed shapes assume {want}")
            agg = {k: sum(r[k] * r["launches_per_clip"] for r in rows)
                   for k in ("ms", "ms_f32", "plain_ms", "library_ms",
                             "bound_ms")}
            agg["bound_by"] = max(rows, key=lambda r: r["bound_ms"]
                                  * r["launches_per_clip"])["bound_by"]
        else:
            agg = {k: rows[0][k] for k in ("ms", "ms_f32", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "bound_by")}
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
        if all("replaced_ms" in r for r in rows):   # --against
            agg["replaced_ms"] = rows[0]["replaced_ms"] if not clip_sum else [
                sum(r["replaced_ms"][i] * r["launches_per_clip"]
                    for r in rows) for i in (0, 1)]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=ran[name], **({"design": REDESIGNED[name]}
                                   if name in REDESIGNED else {}),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            worst_ulps=max(r["worst_ulps"] for r in rows),
            min_row_cos=min(r["min_row_cos"] for r in rows),
            min_row_cos_f32=min(r["min_row_cos_f32"] for r in rows),
            dtype="bfloat16", per_launch=rows, **agg))
    return out


def run_phase12(gp, jp, rp, engine, sample, raw_res, stem_inputs, ids32,
                mask32, encoders=None):
    """Phase 12 (`--bf16`): 12a the bf16 kernels, 12b the bf16 engine.
    encoders: 12a's encoder rows when they ran already."""
    dev = engine.device
    tower = check_bf16_tower(gp, dev, stem_inputs)
    if encoders is None:
        encoders = check_bf16_encoders(gp, jp, rp, dev, mask32[0], ids32,
                                       mask32)
    flash = check_bf16_flash(dev)
    launches, stats = run_bf16(gp, jp, rp, engine, sample, raw_res)
    return bf16_kernel_rows(tower, encoders, flash, launches), stats


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
    if sys.argv[1:2] == ["--mesh-rank"]:     # a child of phase 7d(ii)
        return mesh_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--infer-rank"]:    # a child of phase 7e(ii)
        return infer_rank_main(sys.argv[2:])
    mode = sys.argv[1:]
    against = None
    if "--against" in mode[:-1]:
        at = mode.index("--against")
        against = Path(mode[at + 1]).resolve()
        mode = mode[:at] + mode[at + 2:]
    if mode not in ([], ["--encoders"], ["--stems"], ["--profiler"],
                    ["--cli"], ["--serve"], ["--bf16"],
                    ["--mesh-cards"]) or (
            against is not None and mode not in ([], ["--bf16"])):
        print(f"usage: {sys.argv[0]} [--encoders | --stems | --profiler | "
              f"--cli | --serve | --bf16 | --mesh-cards] [--against DIR] "
              f"(--against with no mode or --bf16)", file=sys.stderr)
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
    if mode == ["--profiler"]:
        profiler_window()
        return 0

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    if against is not None:
        REPLACED.update(build_replaced(against))

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

    digest = gestsync_digest(gp) + weights_digest(jp, rp)
    if mode == ["--mesh-cards"]:
        from jegal_torch.api import JegalEngine
        from jegal_torch.models import roberta as R

        cards = run_mesh_cards(jp, R.stack_layers(rp), train_batch)
        engine = JegalEngine(jp, gp, roberta_params=rp,
                             tokenizer=word_tokenizer())
        log("data-parallel inference on a mesh of cards: (4, 1) over NCCL, "
            "one rank a card")
        cards["infer"] = run_mesh_cards_infer(engine, digest,
                                              torch.cuda.device_count())
        log(json.dumps({"mesh_cards": cards}))
        log(smi.stdout.strip())
        return 0
    if mode in (["--cli"], ["--serve"]):   # phase 10 or 11 alone
        from jegal_torch.api import JegalEngine

        engine = JegalEngine(jp, gp, roberta_params=rp,
                             tokenizer=word_tokenizer())
        if mode == ["--cli"]:
            log(json.dumps({"cli": run_cli(gp, jp, rp, engine)}))
        else:
            log(json.dumps({"serve": run_serve(gp, jp, rp, engine)}))
        log(smi.stdout.strip())
        return 0
    if mode == ["--bf16"]:   # phase 12 alone, on phase 4's clip
        from jegal_torch.api import JegalEngine

        engine = JegalEngine(jp, gp, roberta_params=rp,
                             tokenizer=word_tokenizer())
        sample = dict(clip(125, 12, SEED + 3), text=SMOKE_TEXT)
        raw_res, _ = drive(engine, sample, "vta", VTA_LAUNCHES)
        rows, stats = run_phase12(gp, jp, rp, engine, sample, raw_res,
                                  stem_frames(dev), ids32, mask32)
        log(json.dumps({"bf16": stats}))
        log(json.dumps({"kernels": rows}))
        log(smi.stdout.strip())
        return 0
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
    # 12a's encoder rows run here, beside phase 3's kernel breakdowns,
    # early in the process, where the profiler keeps every device event
    bf16_encoders = check_bf16_encoders(gp, jp, rp, dev, mask32[0], ids32,
                                        mask32)
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
    training["mesh"], mesh_flash = run_mesh_training(
        jp, engine.roberta_params, train_batch)
    infer_mesh = run_mesh_inference(engine, digest)
    long_launches, training["long_clip"] = run_long_clip(engine, jp)
    launches["flash_attention"] = step_launches["flash_attention"]
    checkpoints = run_checkpoints(gp, jp, rp, engine, sample, raw_res,
                                  train_batch)
    cli = run_cli(gp, jp, rp, engine)
    serve = run_serve(gp, jp, rp, engine)
    bf16_rows, bf16 = run_phase12(gp, jp, rp, engine, sample, raw_res,
                                  stem_inputs, ids32, mask32, bf16_encoders)

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
    # phase 7d: kernels 5 and 6 a rank in a step at each mesh, and kernel 6
    # at a (2, 2) rank's shapes
    for row in kernels:
        if row["name"] in ("encoder_stack", "flash_attention"):
            row["launches_mesh"] = {
                m: stats["launches" if m == "1x1" else
                         "launches_per_rank"][row["name"]]
                for m, stats in training["mesh"].items()}
        if row["name"] == "flash_attention":
            row["mesh_shapes"] = mesh_flash
    step_want = sum(r["launches_per_step"] for r in stack)
    if step_launches["encoder_stack"] != step_want:
        raise AssertionError(f"encoder_stack: {step_launches} in a training "
                             f"step, the timed shapes assume {step_want}")
    long_want = sum(r["launches_per_long_clip"] for r in flash)
    if long_launches["flash_attention"] != long_want:
        raise AssertionError(f"flash_attention: {long_launches} on the long "
                             f"clip, the timed shapes assume {long_want}")
    for row in kernels:     # phase 7e: a (2, 1) rank's extract_many call
        row["launches_mesh_infer"] = infer_mesh[f"{INFER_RANKS}x1"][
            "launches_per_rank"].get(row["name"], 0)
    for row in kernels:     # rows 3-5: launches of one forward_validation
        if row["name"] in VALIDATION_LAUNCHES:
            row["launches_validation"] = \
                checkpoints["validation"]["launches"][row["name"]]
        # each CLI subcommand's counts in phase 10 (eager runs and captures)
        row["launches_cli"] = {cmd: n[row["name"]]
                               for cmd, n in cli["launches"].items()
                               if n.get(row["name"])}
        # phase 11b's served batches: the launches of the graphs replayed
        row["launches_serve"] = serve["launches"].get(row["name"], 0)
    for name, cmds in (("stem_band", ("infer", "extract-feats")),
                       ("conv2", ("infer", "extract-feats")),
                       ("attn_sublayer", ("infer", "extract-embs")),
                       ("ffn_sublayer", ("infer", "extract-embs")),
                       ("encoder_stack", ("infer", "extract-embs", "train")),
                       ("flash_attention", ("train",))):
        for cmd in cmds:
            if not cli["launches"][cmd].get(name):
                raise AssertionError(f"{name}: no launch in the CLI's {cmd}")
    log(json.dumps({"training": training}))
    log(json.dumps({"infer_mesh": infer_mesh}))
    log(json.dumps({"checkpoints": checkpoints}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"bf16": bf16}))
    log(json.dumps({"kernels": kernels + bf16_rows}))
    log(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

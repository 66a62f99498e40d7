"""JegalEngine — embedding extraction on the port (the JAX package's
api.py, reference inference_embs.py:526-646).

All seven combos of v, t and a. Given decoder frames — raw (T, 270, 480, 3)
uint8 with chin rows, or planar (T, 90, 27, 160) uint8 that
`jegal_torch.ops.video.s2d_repack` masked and repacked on the host — the
engine runs the fused path of the JAX engine's `_extract_fused`
(api.py:563-613): frames -> face mask -> GestSync tower -> JEGAL gesture
branch, beside the text branch (XLM-R -> text encoder -> word pooling) and
the audio branch, with no host round trip between the stages; embeddings
come back once and are L2-normalized in float32 on the host.
`extract_many` batches samples of one shape bucket (api.py:978-1185): per
T bucket, chunks padded to a power-of-two ladder (or always to batch_size
with ladder=False), run through a depth-1 pipeline that prepares and
uploads the next chunk while the card computes the current one. The
chunks are planned from each sample's plan (`_plan_sample`: checks,
tokenizer, pooling matrices, and the buckets, which the wav's length
gives); the log-mels, the bulk of the host's prep, follow on the prep
pool in dispatch order while the chunks before them run (`_prep_stream`).

Graphs per bucket, the counterpart of the JAX engine's one jit per (combo,
shape bucket): on the card every `extract` / `extract_many` forward replays
one CUDA graph per graph key — (v, t, a) for the two-stage forward, or
("fused", frame kind, t, a, batched) for frames -> embeddings — and shape
signature of its inputs. The first call of a key captures it (`_Graph`);
`warmup` / `warmup_all` capture ahead of traffic; at most
`max_cached_graphs` signatures are kept, evicted least recently used by
combo, exactly as the JAX engine's ledger does (`cached_graphs`). Inputs
are written on the host into pinned staging buffers kept with each graph
and uploaded without blocking the host. A chunk's frames are the bulk of
them (1.59 GB for 16 planar clips at T 256), so the engine's staging
pool writes them, in equal runs of frame slots over up to STAGE_WORKERS
threads, the process's share of the host's cores (`_fill_frames`). A
capture that fails raises. On the CPU the same ledger holds the eager
forward, which runs as it is.

Spans (utils/profiling.annotate; a flag check when no profiler runs),
all on the calling thread but the prep workers': one a call
(`jt.extract_many`, `jt.tower_many`) holding four kinds of leaves that
never nest or overlap: `jt.prep` (`_prep_map`'s plan of every sample,
then before each chunk's stage the wait for its samples' log-mels,
`_prep_stream`), `jt.stage` (a chunk's inputs made ready on the host),
`jt.launch` (its upload, replay or eager tower, and the queued fetch)
and `jt.settle` (`_pipeline`'s fetch and post-processing of one chunk);
`jt.capture` (a graph's capture) and `jt.stage.wait` (a wait for an
older upload) open inside `jt.stage` when they happen, `jt.prep.text`
(the tokenizer and text pooling of a sample's plan) and
`jt.prep.audio` (its log-mel) where they run: on the prep workers, or
inline inside `jt.prep` for a call of a few samples, and
`jt.stage.fill` on each staging worker's run of a frame fill (inside
its `jt.stage` in time, on another thread).
`extract` and `warmup` get the stage and launch spans of the helpers
they share.

Data-parallel inference (`mesh=` on `extract_many`,
`gestsync_features_from_raw_many` and `warmup`; the JAX engine's `mesh`,
which shards a batch over its devices' 'data' axis) is one process a
card: each is then a collective call over the ranks of a
parallel/mesh.make_mesh DeviceMesh, every rank filling, uploading and
replaying only its rows of each padded batch and gathering the rows over
'data' before the host fetches them.

The text modality needs XLM-R parameters and a tokenizer: a
`jegal_torch.text.WordTokenizer` over any backend with its duck-typed
interface (for the real vocabulary, `WordTokenizer.from_file` on
xlm-roberta-base's tokenizer.json, which needs the `tokenizers` package).

The engine runs on the card unless the caller passes device="cpu"; with no
card it raises rather than falling back. `stem_impl` ("band", the default,
| "window") and `conv2_impl` ("kernel", the default, | "dense": cuDNN's
convolution, the JAX package's default) choose the tower's block-1 and
block-2 kernels (models/gestsync.py) for every tower call; on the H100 the
block-2 kernel left less device time than cuDNN on the clips and batches
measured (PERF.md); `fusion_strategy` ("concat" | the warned "avg") the
content fusion (models/jegal.fuse_content).

`dtype` (torch.float32, the default, or torch.bfloat16) is the compute
dtype, as the JAX engine's `dtype` (its api.py:81-110): every floating
parameter is cast to it once at construction, the host's float inputs
(features, mel, pooling matrices) are staged in it, and every kernel on the
path takes its variant of that dtype (ops/kernels/*: bf16 variants of
both stems, block 2, the attention and FFN sublayers, the XLM-R stack and
the flash attention of clips past 512 frames). Frames stay uint8, masks
float32; the embeddings come back in the compute dtype and are
L2-normalized in float32 on the host. A bf16 engine runs wherever a
float32 one does: either `stem_impl`, and every T bucket on the card.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from jegal_torch.config import N_MELS
from jegal_torch.convert import tree_to_torch
from jegal_torch.data.bucketing import (
    MEL_BUCKETS,
    S_BUCKETS,
    T_BUCKETS,
    W_BUCKETS,
    batch_ladder,
    next_bucket,
    pad_axis,
)
from jegal_torch.models import gestsync as G
from jegal_torch.models import jegal as J
from jegal_torch.models import roberta as R
from jegal_torch.ops.audio import mel_frames, wav2filterbanks_np
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels.stem import IMPLS as STEM_IMPLS
from jegal_torch.ops.pooling import (
    build_audio_pooling,
    build_text_pooling,
    text_word_starts,
)
from jegal_torch.ops.video import FALLBACK_ROWS, mask_frames_device
from jegal_torch.parallel import mesh as M
from jegal_torch.utils.profiling import annotate

RAW_FRAME = (270, 480, 3)
PLANAR_FRAME = (90, 27, 160)
FRAME_SHAPES = {"raw": RAW_FRAME, "planar": PLANAR_FRAME}
INT_INPUTS = {"frames": torch.uint8, "cut": torch.int64,
              "input_ids": torch.int64, "audio_valid": torch.int64}
MASK_INPUTS = ("visual_mask", "text_mask")      # float32 in either dtype
DTYPES = (torch.float32, torch.bfloat16)
# Frame fills run on the staging pool (`_fill_frames`): a one-thread copy
# of a T-256 chunk of 16 planar clips took about as long as the card's work
# on the chunk before it (PERF.md §5); 4 threads copy it in under a third
# of that time.
STAGE_WORKERS = 4


def input_dtype(name: str, dtype: torch.dtype = torch.float32) -> torch.dtype:
    """The dtype of a graph input: its integer type; float32 for a mask
    (as the JAX engine keeps them); else the engine's compute dtype."""
    if name in INT_INPUTS:
        return INT_INPUTS[name]
    return torch.float32 if name in MASK_INPUTS else dtype


# numpy has no bf16: the host converts between float32 arrays and bf16 bit
# patterns (uint16) itself, in numpy on the calling thread. A torch CPU
# conversion runs in its thread pool, whose threads then spin on the
# host's cores for a while, and they slowed the engine's numpy prep and
# staging about twofold on the card machine (PERF.md §6).

def _bf16_bits(a) -> np.ndarray:
    """float32 values -> bf16 bit patterns, rounded to nearest even (as
    torch's and numpy's casts round)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)


def _numpy(t) -> np.ndarray:
    """A host tensor as numpy; a bf16 one as float32 holding its values
    exactly."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


class _Bf16Buffer:
    """A bf16 staging buffer (a tensor, pinned on the card) whose `fill`
    writes float32 host values into it as bf16: the JAX engine's host cast
    before the upload."""

    def __init__(self, tensor):
        self.tensor = tensor
        self.bits = tensor.view(torch.int16).numpy().view(np.uint16)

    def fill(self, value) -> None:
        self.bits[...] = _bf16_bits(value)


def _put(buf, value) -> None:
    """Fill a staging buffer completely: a numpy view of pinned memory, or
    a `_Bf16Buffer`."""
    if isinstance(buf, _Bf16Buffer):
        buf.fill(value)
    else:
        buf[...] = value


def _fill_slots(fr, clips, lo: int, hi: int) -> None:
    """Frame slots [lo, hi) of the host batch fr (b, T bucket, ...), taken
    row after row: in row i < len(clips) clip i's frames (host arrays) and
    its last frame repeated to the bucket, in the rows past them zeros.
    Numpy slice assignments, which release the GIL."""
    t_bucket = fr.shape[1]
    while lo < hi:
        bi, j0 = divmod(lo, t_bucket)
        j1 = min(t_bucket, j0 + hi - lo)
        if bi >= len(clips):
            fr[bi, j0:j1] = 0
        else:
            frames = clips[bi]
            t = frames.shape[0]
            if j0 < t:
                fr[bi, j0:min(j1, t)] = frames[j0:j1]
            if j1 > t:
                fr[bi, max(j0, t):j1] = frames[-1]
        lo += j1 - j0


def _fill_run(fr, clips, lo: int, hi: int) -> None:
    """`_fill_slots` on a staging worker, in its own span."""
    with annotate("jt.stage.fill"):
        _fill_slots(fr, clips, lo, hi)


def _stage_workers() -> int:
    """Threads a frame fill runs on: STAGE_WORKERS, or fewer where the
    process's cores, shared by the process group's ranks (a mesh's ranks
    are one host's cards), are fewer; at least 1."""
    cores = len(os.sched_getaffinity(0)) // M.world_size()
    return max(1, min(STAGE_WORKERS, cores))


def _cast_tree(tree, dtype):
    """Every floating leaf of a parameter tree cast to `dtype` (once, at
    construction, as the JAX engine does)."""
    if tree is None or dtype == torch.float32:
        return tree
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class ClientError(ValueError):
    """Invalid client-supplied sample (a modality without its data, a
    malformed array)."""


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda" becomes the current card's
    index); a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # indexed, so that it compares equal to a tensor's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Graph:
    """One entry of the engine's graph cache: the forward of one graph key
    at one set of input shapes.

    On the card it is captured at construction, following the
    `torch.cuda.graphs` recipe: static input buffers on the device (zeros),
    one eager run on a side stream (which also builds every kernel and
    fills every cache the forward reads, such as the shared GEMM's SM
    count), then the capture into the engine's memory pool. It holds the
    `torch.cuda.CUDAGraph`, its static output (the packed embeddings of
    `_pack_emb`) and `launches`, the `_build.LAUNCHES` delta recorded while
    it was captured: the kernels one replay launches (a replay itself adds
    nothing to the counts; the eager run and the capture add one each).
    A capture that fails raises.

    A call writes its host inputs into `stage()`'s pinned buffers (the
    frames by `JegalEngine._fill_frames`, in runs on the engine's
    staging pool, complete before `stage`'s caller launches), then
    `__call__` uploads them with non_blocking=True into the static
    inputs, copies device-resident inputs, and replays on the current
    stream. The returned output is the graph's own buffer: its caller
    copies it out, in stream order, before the next replay of any graph
    in the pool.

    Two sets of staging buffers (allocated at first use): extract_many's
    depth-1 pipeline stages chunk k+1 while chunk k's upload may still be
    in flight, and `stage()` never hands out a buffer whose upload has not
    completed (it takes the other set, or waits for the older upload).

    Inputs take `input_dtype` of the engine's dtype, in the static inputs
    and in the staging buffers alike: a bf16 input's staging buffer is a
    pinned bf16 tensor that `_put` fills through its bit patterns, the
    others numpy views.

    On the CPU the entry holds the eager forward alone, `stage()` returns
    fresh buffers and `__call__` runs the forward on them."""

    def __init__(self, fn, shapes: dict, device: torch.device, pool=None,
                 dtype: torch.dtype = torch.float32):
        self.fn = fn
        self.shapes = shapes
        self.dtypes = {k: input_dtype(k, dtype) for k in shapes}
        self.graph = None
        self.launches = dict.fromkeys(_build.LAUNCHES, 0)
        if device.type != "cuda":
            return
        self._staging: list = [{}, {}]
        self._uploaded: list = [None, None]     # each set's last upload
        self._slot = self._last = 0
        self.inputs = {k: torch.zeros(s, dtype=self.dtypes[k], device=device)
                       for k, s in shapes.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(**self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.LAUNCHES)
        # No garbage collection during the capture: a collection there may
        # free a dead engine's graphs, events or pinned buffers, and a CUDA
        # call that invalidates a capture in flight fails the capture at its
        # next launch (the card tests' batched replay check failed so, at
        # capture, in 3 of 3 runs of the whole file, and in 0 of 2 with this
        # guard; the collection is the suspected cause, not a shown one:
        # two later runs without the guard passed, and saw no collection
        # during a capture)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                self.out = fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        self.graph = graph

    @staticmethod
    def _view(t):
        return _Bf16Buffer(t) if t.dtype == torch.bfloat16 else t.numpy()

    def stage(self, names) -> dict:
        """Host buffers for the inputs `names`, to be filled completely
        (`_put`) and passed to `__call__`: numpy views of pinned memory on
        the card, or `_Bf16Buffer`s of pinned bf16 tensors."""
        if self.graph is None:
            return {k: self._view(torch.empty(self.shapes[k],
                                              dtype=self.dtypes[k]))
                    for k in names}
        free = [i for i in (0, 1) if self._uploaded[i] is None
                or self._uploaded[i].query()]
        self._slot = free[0] if free else 1 - self._last
        if not free:
            with annotate("jt.stage.wait"):
                self._uploaded[self._slot].synchronize()
        bufs = self._staging[self._slot]
        for k in names:
            if k not in bufs:
                bufs[k] = torch.empty(self.shapes[k], dtype=self.dtypes[k],
                                      pin_memory=True)
        return {k: self._view(bufs[k]) for k in names}

    def __call__(self, staged: dict, device_inputs=None) -> torch.Tensor:
        """Run the forward on the staged host inputs and the tensors of
        `device_inputs` (on the engine's device) -> packed embeddings."""
        device_inputs = device_inputs or {}
        if self.graph is None:
            return self.fn(**{k: v.tensor if isinstance(v, _Bf16Buffer)
                              else torch.from_numpy(v)
                              for k, v in staged.items()}, **device_inputs)
        bufs = self._staging[self._slot]
        for k in staged:
            self.inputs[k].copy_(bufs[k], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._uploaded[self._slot], self._last = done, self._slot
        for k, v in device_inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return self.out


class JegalEngine:
    """Holds parameter trees (jegal_torch.convert layout) on one device, and
    the tokenizer, and extracts L2-normalized embeddings."""

    def __init__(self, jegal_params, gestsync_params=None, device="cuda",
                 roberta_params=None, tokenizer=None,
                 roberta_cfg: R.RobertaConfig = R.XLMR_BASE,
                 stem_impl: str = "band", conv2_impl: str = "kernel",
                 fusion_strategy: str = "concat",
                 max_cached_graphs: int = 64,
                 dtype: torch.dtype = torch.float32):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, "
                             f"got {dtype!r}")
        if stem_impl not in STEM_IMPLS:
            raise ValueError(f"stem_impl must be one of {STEM_IMPLS}, got "
                             f"{stem_impl!r}")
        if conv2_impl not in G.CONV2_IMPLS:
            raise ValueError(f"conv2_impl must be one of {G.CONV2_IMPLS}, "
                             f"got {conv2_impl!r}")
        self.device = resolve_device(device)
        self.dtype = dtype

        def load(tree):
            return (None if tree is None
                    else _cast_tree(tree_to_torch(tree, self.device), dtype))

        self.jegal_params = load(jegal_params)
        self.gestsync_params = load(gestsync_params)
        self.roberta_params = load(roberta_params)
        if self.roberta_params is not None \
                and "fused_ops" not in self.roberta_params:
            # once at load: the stack kernel's operands are then ready and
            # no forward stacks or concatenates a weight
            self.roberta_params = R.stack_layers(self.roberta_params)
        self.tokenizer = tokenizer
        self.roberta_cfg = roberta_cfg
        self.tower_kw = dict(chunk=160, stem_impl=stem_impl,
                             conv2_impl=conv2_impl)
        self.fusion_strategy = fusion_strategy
        self.max_cached_graphs = max_cached_graphs
        self._graph_ledger: dict = {}      # (key, shape signature) -> seq no
        self._graph_seq = 0
        self._graphs: dict = {}            # (key, shape signature) -> _Graph
        self._graph_pool = None            # one memory pool for all graphs
        # a tokenizer backend need not be thread-safe (HF's raises
        # "Already borrowed"): extract_many's prep threads take turns
        self._tok_lock = threading.Lock()
        self._pool_lock = threading.Lock()
        self._prep_pool = None             # created by _prep_map, see close
        self._stage_pool = None            # created by _fill_frames

    def close(self) -> None:
        """Shut the prep and staging pools down (waiting for their
        threads); the engine stays usable and creates a new pool when it
        needs one."""
        with self._pool_lock:
            pools = self._prep_pool, self._stage_pool
            self._prep_pool = self._stage_pool = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    # Visual features (GestSync)
    # ------------------------------------------------------------------

    def _gestsync(self):
        if self.gestsync_params is None:
            raise RuntimeError("engine has no GestSync parameters")
        return self.gestsync_params

    @staticmethod
    def _features_out(feats, t: int, as_device: bool):
        """The first t rows: the device tensor (in the compute dtype), or
        float32 numpy (a bf16 engine's values exactly)."""
        return feats[:t] if as_device else _numpy(feats[:t].cpu())

    def gestsync_features_masked(self, masked_frames, as_device=False):
        """(T + 24, 270, 480, 3) float frames in [0, 1], face-masked and
        edge-padded +/-12 (the reference's own preprocessed layout) ->
        (T, 1024) numpy, or a device tensor with as_device=True."""
        gp = self._gestsync()
        frames = self._to_device(masked_frames)
        with torch.inference_mode():
            feats = G.extract_features(gp, frames, **self.tower_kw)
        return self._features_out(feats, feats.shape[0], as_device)

    def gestsync_features(self, frames, chin_rows=None, as_device=False):
        """The single-clip tower's front door: raw uint8 frames (T, 270,
        480, 3) with optional chin rows -> gestsync_features_from_raw;
        planar uint8 (T, 90, 27, 160), already masked (chin_rows must be
        None) -> gestsync_features_from_planar; float frames (T + 24, 270,
        480, 3) in [0, 1], masked and edge-padded (chin_rows must be None)
        -> gestsync_features_masked. The same features either way."""
        if tuple(frames.shape[1:]) == PLANAR_FRAME:
            if chin_rows is not None:
                raise ClientError("planar input is already masked; "
                                  "chin_rows must be None")
            return self.gestsync_features_from_planar(frames, as_device)
        if torch.as_tensor(frames).is_floating_point():
            if chin_rows is not None:
                raise ClientError("float frames are pre-masked and "
                                  "edge-padded; chin_rows must be None")
            return self.gestsync_features_masked(frames, as_device)
        return self.gestsync_features_from_raw(frames, chin_rows, as_device)

    def gestsync_features_from_raw(self, frames_u8, chin_rows=None,
                                   as_device=False):
        """Decoder-resized uint8 frames (T, 270, 480, 3) -> (T, 1024), the
        face mask applied on the device (chin rows, or the 111-row fallback
        without them)."""
        gp = self._gestsync()
        if self._frames_kind(frames_u8) != "raw":
            raise ClientError("gestsync_features_from_raw takes raw frames")
        t = frames_u8.shape[0]
        with torch.inference_mode():
            masked = mask_frames_device(
                self._to_device(frames_u8),
                self._to_device(self._chin(chin_rows, t)), self.dtype)
            feats = G.extract_features(gp, masked, **self.tower_kw)
        return self._features_out(feats, t, as_device)

    def gestsync_features_from_planar(self, planar_u8, as_device=False):
        """Host-repacked planar uint8 frames (T, 90, 27, 160), already
        masked (ops/video.s2d_repack) -> (T, 1024); the stem reads the
        bytes. The features of gestsync_features_from_raw on the same
        frames and chin rows."""
        gp = self._gestsync()
        if self._frames_kind(planar_u8) != "planar":
            raise ClientError("gestsync_features_from_planar takes planar "
                              "frames")
        with torch.inference_mode():
            feats = G.extract_features_planar(
                gp, self._to_device(planar_u8), **self.tower_kw)
        return self._features_out(feats, planar_u8.shape[0], as_device)

    def gestsync_features_from_raw_many(self, clips: list,
                                        batch_size: int = 16,
                                        as_device: bool = False,
                                        mesh=None) -> list:
        """Cross-clip tower batching: clips is a list of (frames_u8 (T, 270,
        480, 3), chin_rows (T,) | None), or of (planar_u8 (T, 90, 27, 160),
        None); a call is all raw or all planar. Clips of one T bucket run
        as one batched tower call per chunk of batch_size (padded to the
        power-of-two ladder), through the depth-1 pipeline. -> per clip
        (T, 1024) features (device tensors with as_device=True).

        The frames are host arrays, or uint8 tensors the caller already put
        on the engine's device (the extract-feats driver uploads on its
        decode threads): those stack on the device and never come back to
        the host. A call mixing the two is a client error.

        mesh: a ('data', 'model') DeviceMesh (parallel/mesh.make_mesh);
        the call is then collective: every rank of the mesh calls with the
        same clips, each chunk's padded batch rounds up to a multiple of
        the 'data' size dp, each rank fills, uploads and runs only its
        rows of it, and the features are gathered over 'data', so every
        rank returns every clip's (the JAX package's shard_map over
        'data'). Clips on the device are a client error under a mesh (the
        JAX package's device stacking is for mesh=None alone)."""
        self._gestsync()
        on_device = self._clips_on_device(clips)
        if on_device and mesh is not None:
            raise ClientError("clips on the device run without a mesh; "
                              "pass host arrays with mesh=")
        kinds = {self._frames_kind(f) for f, _ in clips}
        if len(kinds) > 1:
            raise ClientError("clips must be all raw or all planar")
        kind = kinds.pop() if kinds else "raw"
        if kind == "planar" and any(c is not None for _, c in clips):
            raise ClientError("planar input is already masked; chin_rows "
                              "must be None")
        groups: dict = {}
        for i, (frames, _) in enumerate(clips):
            groups.setdefault((kind, next_bucket(frames.shape[0], T_BUCKETS)),
                              []).append(i)
        M.check_same((batch_size, [f.shape[0] for f, _ in clips],
                      list(groups.items())), mesh, "the tower's chunks")
        results: list = [None] * len(clips)

        def settle(chunk, fetch):
            feats = fetch if as_device else self._finish_fetch(fetch)
            for bi, ci in enumerate(chunk):
                results[ci] = feats[bi, :clips[ci][0].shape[0]]

        with torch.inference_mode(), annotate("jt.tower_many"):
            self._pipeline(self._tower_chunks(
                groups, clips.__getitem__, batch_size, on_device, mesh,
                as_device), settle)
        return results

    def _clips_on_device(self, clips) -> bool:
        """True when every clip's frames are a tensor on the engine's
        device, False when every clip's are on the host (numpy or a CPU
        tensor); a mix, or frames on another device, is a client error."""
        where = {isinstance(f, torch.Tensor) and f.device.type != "cpu"
                 for f, _ in clips}
        if len(where) > 1:
            raise ClientError("clips must be all host arrays or all tensors "
                              "on the engine's device, not a mix")
        if where == {True} and any(f.device != self.device
                                   for f, _ in clips):
            raise ClientError(f"clip frames on another device than the "
                              f"engine's {self.device}")
        return where == {True}

    def _tower_chunks(self, groups: dict, clip_of, batch_size: int,
                      on_device: bool = False, mesh=None,
                      as_device: bool = False):
        """The batched tower's dispatches of gestsync_features_from_raw_many
        (eager: extract_many's chunks replay graphs instead). groups: {(kind,
        T bucket): [clip indices]}; clip_of(i) -> (frames, chin_rows |
        None). Each group runs in chunks of batch_size, padded to the
        power-of-two ladder (rounded up to a multiple of dp under a mesh),
        through one batched tower call a chunk on this rank's rows of it:
        host clips stacked in pinned memory and uploaded, device clips
        (on_device) stacked on the device by device-to-device copies
        (`_stack_on_device`). Yields (chunk, the features (b, T bucket,
        1024), every rank's rows gathered: on the device with
        as_device=True, else their fetch queued by `_start_fetch`)."""
        for (kind, t_bucket), idxs in groups.items():
            for lo in range(0, len(idxs), batch_size):
                chunk = idxs[lo:lo + batch_size]
                rows = M.batch_rows(M.round_to_data(
                    batch_ladder(len(chunk), batch_size), mesh), mesh)
                clips = [clip_of(i) for i in chunk[rows]]
                b = rows.stop - rows.start
                pinned = self.device.type == "cuda"
                shape = (b, t_bucket) + FRAME_SHAPES[kind]
                with annotate("jt.stage"):
                    cut = None if kind == "planar" else torch.empty(
                        (b, t_bucket), dtype=torch.int64, pin_memory=pinned)
                    if on_device:
                        fr = torch.empty(shape, dtype=torch.uint8,
                                         device=self.device)
                        self._stack_on_device(fr, clips)
                        if cut is not None:
                            self._fill_cut(cut.numpy(), clips)
                    else:
                        fr = torch.empty(shape, dtype=torch.uint8,
                                         pin_memory=pinned)
                        self._fill_frames(fr.numpy(), None if cut is None
                                          else cut.numpy(), clips)
                with annotate("jt.launch"):
                    feats = M.gather_rows(self._tower(
                        kind, self._to_device(fr), None if cut is None
                        else self._to_device(cut), batched=True), mesh)
                    if not as_device:
                        feats = self._start_fetch(feats)
                yield chunk, feats

    def _tower(self, kind: str, frames, cut, batched: bool):
        """GestSync features of device frames: (b, T bucket, ...) with
        batched=True, else one clip (T bucket, ...) -> (1, T bucket, 1024).
        Raw frames are masked by their chin rows `cut` on the device;
        planar frames come masked (cut is None)."""
        gp = self._gestsync()
        if batched:
            if kind == "planar":
                return G.extract_features_batch_planar(gp, frames,
                                                       **self.tower_kw)
            return G.extract_features_batch_raw(gp, frames, cut,
                                                **self.tower_kw)
        if kind == "planar":
            return G.extract_features_planar(gp, frames, **self.tower_kw)[None]
        return G.extract_features(gp, mask_frames_device(frames, cut,
                                                         self.dtype),
                                  **self.tower_kw)[None]

    @staticmethod
    def _chin(chin_rows, t: int) -> np.ndarray:
        """Per-frame chin rows (T,) as int64, the fallback row without
        them; a wrong length is a client error."""
        if chin_rows is None:
            return np.full((t,), FALLBACK_ROWS, np.int64)
        cr = np.asarray(chin_rows)
        if cr.shape != (t,) or not np.issubdtype(cr.dtype, np.number):
            raise ClientError(f"chin_rows must have one row per frame "
                              f"({t},), got shape {cr.shape}")
        return cr.astype(np.int64)

    def _fill_frames(self, fr, cut, clips) -> None:
        """Write n <= b clips [(frames, chin_rows | None)] into the host
        batch fr (b, T bucket, ...) uint8 and, for raw frames, their chin
        rows into cut (b, T bucket) (None for planar frames): each clip
        edge-repeats its last frame (and chin row) to the bucket, the frames
        of rows past n are zeros. Every element is written (the buffers of
        a graph are reused).

        The staging pool writes fr's b * T bucket frame slots in equal
        runs, one a worker (`_stage_workers`; each in a `jt.stage.fill`
        span on its thread), and the call returns when all are written.
        The chin rows are written here."""
        hosts = [np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f)
                 for f, _ in clips]
        with self._pool_lock:
            # not the prep pool: prep that overlaps a chunk's staging would
            # queue behind it
            if self._stage_pool is None:
                self._stage_pool = ThreadPoolExecutor(
                    max_workers=STAGE_WORKERS,
                    thread_name_prefix="jegal-stage")
            pool = self._stage_pool
        slots = fr.shape[0] * fr.shape[1]
        parts = min(_stage_workers(), slots)
        runs = [pool.submit(_fill_run, fr, hosts, slots * i // parts,
                            slots * (i + 1) // parts) for i in range(parts)]
        wait(runs)
        for run in runs:
            run.result()
        if cut is not None:
            self._fill_cut(cut, clips)

    @staticmethod
    def _stack_on_device(fr, clips) -> None:
        """`_fill_frames`'s frames for clips already on the device: each
        clip copied into the device batch fr (b, T bucket, ...) by a
        device-to-device copy, its last frame repeated to the bucket, rows
        past n zeros."""
        for bi, (frames, _) in enumerate(clips):
            t = frames.shape[0]
            fr[bi, :t].copy_(frames)
            fr[bi, t:] = frames[-1]
        fr[len(clips):] = 0

    def _fill_cut(self, cut, clips) -> None:
        """The chin rows of n <= b raw clips into the host batch cut (b, T
        bucket), each clip's last row repeated to the bucket and the
        fallback row past n."""
        for bi, (frames, chin) in enumerate(clips):
            t = frames.shape[0]
            cr = self._chin(chin, t)
            cut[bi, :t] = cr
            cut[bi, t:] = cr[-1]
        cut[len(clips):] = FALLBACK_ROWS

    # ------------------------------------------------------------------
    # Host-side preparation
    # ------------------------------------------------------------------

    def prepare_text(self, text: str):
        """-> (arrays dict, num_words), ids padded with the tokenizer's pad
        id to the S bucket; (None, 0) when the sample is invalid under the
        reference's rules (the tokenizer merged words)."""
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer (text modality)")
        with self._tok_lock:
            batch = self.tokenizer.encode_words([text])
        s_nat = batch.input_ids.shape[1]
        starts = text_word_starts(batch.input_ids, batch.offsets,
                                  batch.special_ids)
        n_words = len(batch.words[0])
        w_bucket = next_bucket(max(n_words, 1), W_BUCKETS)
        pool, valid, _ = build_text_pooling(starts, [n_words], s_nat,
                                            w_bucket)
        if not valid[0]:
            return None, 0
        s_bucket = next_bucket(s_nat, S_BUCKETS)
        return {
            "input_ids": pad_axis(batch.input_ids, 1, s_bucket,
                                  value=self.tokenizer.pad_id).astype(np.int64),
            "text_mask": pad_axis(batch.attention_mask, 1,
                                  s_bucket).astype(np.float32),
            "text_pool": pad_axis(pool, 2, s_bucket),
        }, n_words

    def prepare_audio(self, wav: np.ndarray, word_boundaries):
        """wav (S,) float32 at raw int16 scale -> (arrays dict, num_words),
        or (None, 0) when the pooling spans are invalid."""
        arrays, n_words = self._plan_audio(len(wav), word_boundaries)
        if arrays is not None:
            self._fill_mel(arrays, wav)
        return arrays, n_words

    @staticmethod
    def _plan_audio(num_samples: int, word_boundaries):
        """The audio arrays of a wav of num_samples, from its length alone:
        the pooling matrix, the valid mel length and a zero log-mel of the
        mel bucket that `_fill_mel` writes -> (arrays dict, num_words), or
        (None, 0) when the pooling spans are invalid."""
        t_mel = mel_frames(num_samples)
        # audio CNN token count (two stride-2 convs, k=3, p=1): (t-1)//4+1
        t_audio = (t_mel - 1) // 4 + 1
        n_words = len(word_boundaries)
        w_bucket = next_bucket(max(n_words, 1), W_BUCKETS)
        pool, valid, _ = build_audio_pooling([word_boundaries], t_audio,
                                             w_bucket)
        if not valid[0]:
            return None, 0
        mel_bucket = next_bucket(t_mel, MEL_BUCKETS)
        return {
            "audio_mel": np.zeros((1, mel_bucket, N_MELS), np.float32),
            "audio_pool": pad_axis(pool, 2, mel_bucket // 4),
            "audio_valid": np.asarray([t_mel], np.int64),
        }, n_words

    @staticmethod
    def _fill_mel(arrays: dict, wav) -> None:
        """Write the wav's log-mel into the planned `audio_mel`: the heavy
        part of a sample's prep, which the chunk plan does not need."""
        with annotate("jt.prep.audio"):
            mel = wav2filterbanks_np(np.asarray(wav).astype(np.float32))
            arrays["audio_mel"][:, :int(arrays["audio_valid"][0])] = mel

    def prepare_visual(self, visual_feats):
        """(T, 1024) GestSync features -> (arrays dict, T), padded to the T
        bucket with a validity mask."""
        t = visual_feats.shape[0]
        t_bucket = next_bucket(t, T_BUCKETS)
        mask = np.zeros((1, t_bucket), np.float32)
        mask[0, :t] = 1.0
        return {"visual_feats": pad_axis(visual_feats[None], 1, t_bucket),
                "visual_mask": mask}, t

    def _prepare_sample(self, modalities, visual_feats=None, text=None,
                        word_boundaries=None, wav=None):
        """-> (arrays dict, t_true, w_true), or None for an invalid sample."""
        plan = self._plan_sample(modalities, visual_feats, text,
                                 word_boundaries, wav)
        if plan is None:
            return None
        if plan[3] is not None:
            plan[3]()
        return plan[:3]

    def _plan_sample(self, modalities, visual_feats=None, text=None,
                     word_boundaries=None, wav=None):
        """A sample's prep less its log-mel: every check, the tokenizer and
        both pooling matrices, so its validity and its arrays' shapes, ->
        (arrays dict, t_true, w_true, fill), or None for an invalid sample.
        fill() writes the log-mel into arrays (None without 'a')."""
        arrays: dict = {}
        t_true = w_true = fill = None
        if "v" in modalities:
            if visual_feats is None:
                raise ClientError("modality 'v' requires visual_feats")
            vf = visual_feats
            if isinstance(vf, torch.Tensor):   # device-resident: no fetch
                numeric = vf.dtype != torch.bool and not vf.dtype.is_complex
            else:
                vf = np.asarray(vf)
                numeric = np.issubdtype(vf.dtype, np.number)
            if vf.ndim != 2 or vf.shape[1] != 1024 or vf.shape[0] == 0 \
                    or not numeric:
                raise ClientError(
                    f"visual_feats must be a non-empty (T, 1024) numeric "
                    f"array, got shape {tuple(vf.shape)} dtype {vf.dtype}")
            va, t_true = self.prepare_visual(vf)
            arrays.update(va)
        if "t" in modalities:
            if text is None:
                raise ClientError("modality 't' requires text")
            if not isinstance(text, str) or not text.strip():
                raise ClientError("text must be a non-empty string")
            with annotate("jt.prep.text"):
                ta, w_true = self.prepare_text(text)
            if ta is None:
                return None
            arrays.update(ta)
        if "a" in modalities:
            if wav is None or word_boundaries is None:
                raise ClientError(
                    "modality 'a' requires wav and word_boundaries")
            wv = np.asarray(wav)
            if wv.ndim != 1 or wv.size < 640 \
                    or not np.issubdtype(wv.dtype, np.number):
                raise ClientError(
                    f"wav must be a 1-D numeric array of >= 640 samples "
                    f"(one 40 ms frame at 16 kHz), got shape {wv.shape} "
                    f"dtype {wv.dtype}")
            try:
                wbs_ok = all(len(w) >= 3 and float(w[1]) <= float(w[2])
                             for w in word_boundaries)
            except (TypeError, ValueError, KeyError):
                wbs_ok = False
            if not wbs_ok or len(word_boundaries) == 0:
                raise ClientError(
                    "word_boundaries must be a non-empty list of "
                    "(word, start, end) with start <= end")
            aa, n_words = self._plan_audio(wv.size, word_boundaries)
            if aa is None:
                return None
            arrays.update(aa)
            fill = functools.partial(self._fill_mel, aa, wv)
            # with text too, both pooling matrices must count the same
            # words: the reference fails on its torch.cat (models/
            # jegal.py:407-408), the engine rejects the sample
            if w_true is not None and n_words != w_true:
                return None
            w_true = n_words
        if "t" in modalities and "a" in modalities:
            w = max(arrays["text_pool"].shape[1], arrays["audio_pool"].shape[1])
            arrays["text_pool"] = pad_axis(arrays["text_pool"], 1, w)
            arrays["audio_pool"] = pad_axis(arrays["audio_pool"], 1, w)
        return arrays, t_true, w_true, fill

    # ------------------------------------------------------------------
    # Device forward
    # ------------------------------------------------------------------

    def _to_device(self, v):
        """A host array or tensor -> a tensor on the engine's device,
        floats in the compute dtype. On the card the copy is made from
        pinned memory with non_blocking=True, so the host goes on while it
        runs."""
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        if t.is_floating_point():
            t = t.to(self.dtype)
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _start_fetch(self, t):
        """Queue the device->host copy of a dispatched result behind the
        kernels that compute it, into pinned memory, and return (host
        tensor, event) without waiting; `_finish_fetch` waits. A CPU
        engine's result is already on the host."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finish_fetch(fetch) -> np.ndarray:
        """The host fetch of a result `_start_fetch` queued: the one point
        where the host waits for the card."""
        host, done = fetch
        if done is not None:
            done.synchronize()
        return _numpy(host)

    # ------------------------------------------------------------------
    # Graphs per (key, shape bucket)
    # ------------------------------------------------------------------

    def _jegal(self, use_v: bool, use_t: bool, use_a: bool, **arrays):
        """The JEGAL forward of one combo -> packed embeddings."""
        return self._pack_emb(*J.forward_inference(
            self.jegal_params, self.roberta_params, use_v=use_v, use_t=use_t,
            use_a=use_a, roberta_cfg=self.roberta_cfg,
            fusion_strategy=self.fusion_strategy, **arrays))

    def _key_fn(self, key):
        """The eager forward of a graph key, over its named inputs: (v, t,
        a) is the two-stage forward; ("fused", kind, t, a, batched) runs
        the tower on the frames (raw frames with their chin rows `cut`)
        and the JEGAL forward on its features, which never leave the
        device."""
        if key[0] != "fused":
            return functools.partial(self._jegal, *key)
        _, kind, use_t, use_a, batched = key

        def fn(frames, visual_mask, cut=None, **content):
            return self._jegal(True, use_t, use_a, visual_feats=self._tower(
                kind, frames, cut, batched), visual_mask=visual_mask,
                **content)

        return fn

    def _graph(self, key, shapes: dict) -> _Graph:
        """The cache entry of `key` at the input shapes {name: shape},
        captured at its first use (the ledger is updated first, so that an
        eviction frees memory before the capture)."""
        sig = (key, tuple(sorted((k, tuple(v)) for k, v in shapes.items())))
        if self.dtype != torch.float32:   # a bf16 engine's end with its dtype
            sig += (str(self.dtype).split(".")[-1],)
        self._account_graph(sig)
        entry = self._graphs.get(sig)
        if entry is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            try:
                with annotate("jt.capture"):
                    entry = _Graph(self._key_fn(key), dict(sig[1]),
                                   self.device, self._graph_pool, self.dtype)
            except BaseException:
                self._graph_ledger.pop(sig, None)
                raise
            self._graphs[sig] = entry
        return entry

    def _account_graph(self, sig) -> None:
        """LRU ledger of the cached (key, shape signature) graphs, the JAX
        engine's policy (its api.py:441-470): past `max_cached_graphs`, the
        least recently used key loses all its graphs; when the active key
        alone exceeds the budget, only the signature in flight stays.

        All of an engine's graphs share one memory pool, so its memory
        follows the largest graph, not their sum. That is safe because the
        graphs replay one at a time on one stream, and each call copies its
        output out, in stream order, before the next replay (extract's host
        copy; extract_many's `_start_fetch`, queued right behind its
        replay): no replay can overwrite another graph's output before it
        was read. Dropping a graph frees it."""
        self._graph_seq += 1
        self._graph_ledger[sig] = self._graph_seq
        if len(self._graph_ledger) <= self.max_cached_graphs:
            return
        by_key: dict = {}
        for s, seq in self._graph_ledger.items():
            by_key[s[0]] = max(by_key.get(s[0], 0), seq)
        victim = min((k for k in by_key if k != sig[0]), key=by_key.get,
                     default=None)
        if victim is None:
            keep = {sig}
        else:
            keep = {s for s in self._graph_ledger if s[0] != victim}
        self._graph_ledger = {s: n for s, n in self._graph_ledger.items()
                              if s in keep}
        self._graphs = {s: g for s, g in self._graphs.items() if s in keep}

    @property
    def cached_graphs(self) -> list:
        """Cached (key, shape signature) graphs, oldest first."""
        return [s for s, _ in sorted(self._graph_ledger.items(),
                                     key=lambda kv: kv[1])]

    def _forward(self, use, arrays: dict):
        """The two-stage forward of combo `use` on `arrays` (each with its
        batch axis: host arrays, or tensors on the engine's device) through
        its graph -> packed embeddings on the device."""
        with annotate("jt.stage"):
            launch = self._staged_forward(use, arrays)
        with annotate("jt.launch"):
            return launch()

    def _staged_forward(self, use, arrays: dict):
        """`_forward`'s host half: its graph's staging buffers filled with
        `arrays` -> the call that uploads them and replays the graph."""
        on_device = {k: self._to_device(v) for k, v in arrays.items()
                     if isinstance(v, torch.Tensor) and v.device == self.device}
        entry = self._graph(tuple(use), {k: v.shape
                                         for k, v in arrays.items()})
        staged = entry.stage([k for k in arrays if k not in on_device])
        for k, buf in staged.items():
            _put(buf, arrays[k])
        return functools.partial(entry, staged, on_device)

    def _fused(self, kind: str, use_t: bool, use_a: bool, t_bucket: int, b,
               clips, content: dict):
        """One replay of a fused graph: n <= b clips [(frames, chin_rows |
        None)] padded to the T bucket (and the batch to b rows), and the
        content arrays (each with its batch axis), written into the graph's
        staging buffers -> packed embeddings on the device. b is None for
        the single-clip graph, whose frames have no batch axis."""
        with annotate("jt.stage"):
            launch = self._staged_fused(kind, use_t, use_a, t_bucket, b,
                                        clips, content)
        with annotate("jt.launch"):
            return launch()

    def _staged_fused(self, kind: str, use_t: bool, use_a: bool,
                      t_bucket: int, b, clips, content: dict):
        """`_fused`'s host half: its graph's staging buffers filled -> the
        call that uploads them and replays the graph."""
        lead = () if b is None else (b,)
        shapes = {"frames": lead + (t_bucket,) + FRAME_SHAPES[kind],
                  "visual_mask": (b or 1, t_bucket),
                  **{k: tuple(v.shape) for k, v in content.items()}}
        if kind == "raw":
            shapes["cut"] = lead + (t_bucket,)
        entry = self._graph(("fused", kind, use_t, use_a, b is not None),
                            shapes)
        staged = entry.stage(shapes)
        fr, cut = staged["frames"], staged.get("cut")
        if b is None:
            fr, cut = fr[None], None if cut is None else cut[None]
        self._fill_frames(fr, cut, clips)
        staged["visual_mask"][:] = 0.0
        for bi, (frames, _) in enumerate(clips):
            staged["visual_mask"][bi, :frames.shape[0]] = 1.0
        for k, v in content.items():
            _put(staged[k], v)
        return functools.partial(entry, staged)

    @staticmethod
    def _pack_emb(gesture, content):
        """Pack (gesture, content) along the row axis so one device->host
        copy fetches both; combos with one branch return it alone."""
        if gesture is None:
            return content
        if content is None:
            return gesture
        return torch.cat([gesture, content], dim=1)

    @staticmethod
    def _unpack_emb(packed, t_split, has_gesture, has_content):
        """Host inverse of _pack_emb: gesture rows are the first t_split
        (the T bucket)."""
        if not has_content:
            return packed, None
        if not has_gesture:
            return None, packed
        return packed[:, :t_split], packed[:, t_split:]

    @staticmethod
    def _postprocess(gesture, content, i, t_true, w_true, text,
                     word_boundaries, fname):
        """Batch row i's valid rows, L2-normalized in float32 on the host
        (the .pkl contract is exactly unit-norm float32 rows, reference
        inference_embs.py:629-646)."""
        def norm_rows(x, n):
            out = np.asarray(x[i, :n], np.float32)
            return out / np.maximum(
                np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)

        return {
            "gesture_emb": None if gesture is None
            else norm_rows(gesture, t_true),
            "content_emb": None if content is None
            else norm_rows(content, w_true),
            "info": {"fname": fname, "word_boundaries": word_boundaries,
                     "text": text},
        }

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    @staticmethod
    def _check_modalities(modalities):
        if not isinstance(modalities, str) or not modalities \
                or set(modalities) - set("vta"):
            raise ClientError(f"modalities must combine 'v', 't' and 'a', "
                              f"got {modalities!r}")

    @staticmethod
    def _frames_kind(frames) -> str:
        """'raw' | 'planar' for uint8 decoder frames (T, 270, 480, 3) or
        host-repacked planar (T, 90, 27, 160); anything else is a client
        error."""
        if frames.ndim != 4 or tuple(frames.shape[1:]) not in (RAW_FRAME,
                                                               PLANAR_FRAME) \
                or frames.shape[0] == 0:
            raise ClientError(
                "frames must be (T, 270, 480, 3) uint8 decoder-resized RGB "
                "or (T, 90, 27, 160) host-repacked planar, got "
                f"{tuple(frames.shape)}")
        if frames.dtype not in (np.uint8, torch.uint8):
            raise ClientError(f"frames must be uint8, got {frames.dtype}")
        return "planar" if tuple(frames.shape[1:]) == PLANAR_FRAME else "raw"

    def extract(self, modalities: str = "vta", visual_feats=None,
                text: str | None = None, word_boundaries: list | None = None,
                wav=None, fname: str | None = None, frames=None,
                chin_rows=None) -> dict | None:
        """-> {"gesture_emb": (T, 512) | None, "content_emb": (W, 512) |
        None, "info": {...}}, L2-normalized float32 numpy rows; None when
        the sample is invalid under the reference's rules.

        For 'v', pass EITHER visual_feats (T, 1024) OR decoder frames:
        (T, 270, 480, 3) uint8 with optional per-frame chin_rows (T,), or
        planar (T, 90, 27, 160) uint8 from ops.video.s2d_repack (already
        masked: chin_rows must be None). Frames run the fused single-clip
        path."""
        self._check_modalities(modalities)
        with torch.inference_mode():
            if frames is not None:
                if "v" not in modalities:
                    raise ClientError("frames given but modalities lack 'v'")
                if visual_feats is not None:
                    raise ClientError(
                        "pass either frames or visual_feats, not both")
                return self._extract_fused(modalities, frames, chin_rows,
                                           text, word_boundaries, wav, fname)
            if chin_rows is not None:
                raise ClientError("chin_rows requires frames")
            prep = self._prepare_sample(modalities, visual_feats, text,
                                        word_boundaries, wav)
            if prep is None:
                return None
            arrays, t_true, w_true = prep
            use_v, use_t, use_a = (c in modalities for c in "vta")
            packed = _numpy(self._forward((use_v, use_t, use_a),
                                          arrays).cpu())
            t_split = arrays["visual_feats"].shape[1] if use_v else None
            gesture, content = self._unpack_emb(packed, t_split, use_v,
                                                use_t or use_a)
            return self._postprocess(gesture, content, 0, t_true, w_true,
                                     text, word_boundaries, fname)

    def _extract_fused(self, modalities, frames, chin_rows, text,
                       word_boundaries, wav, fname):
        """Frames -> tower -> JEGAL on the device through the single-clip
        graph of (kind, T bucket, content shapes), one host fetch at the
        end. The frames are padded to the bucket on the host, in the
        graph's pinned staging buffer: tail frames repeat the last frame
        (and its chin row); visual_mask keeps them out of every valid row's
        attention, and rows past T are sliced off. The true length reaches
        the graph only as data (frames, cut, visual_mask)."""
        self._gestsync()
        kind = self._frames_kind(frames)
        if kind == "planar" and chin_rows is not None:
            raise ClientError("planar input is already masked; "
                              "chin_rows must be None")
        use_t, use_a = "t" in modalities, "a" in modalities
        t = frames.shape[0]
        if kind == "raw":
            self._chin(chin_rows, t)
        prep = self._prepare_sample(modalities.replace("v", ""), None, text,
                                    word_boundaries, wav)
        if prep is None:
            return None
        arrays, _, w_true = prep
        t_bucket = next_bucket(t, T_BUCKETS)
        packed = self._fused(kind, use_t, use_a, t_bucket, None,
                             [(frames, chin_rows)], arrays)
        gesture, content = self._unpack_emb(_numpy(packed.cpu()), t_bucket,
                                            True, use_t or use_a)
        return self._postprocess(gesture, content, 0, t, w_true, text,
                                 word_boundaries, fname)

    # ------------------------------------------------------------------
    # Batched extraction
    # ------------------------------------------------------------------

    def _stack_parts(self, parts, b: int, like):
        """Stack per-sample arrays into a (b, ...) batch, zero rows past
        len(parts) (all b rows when parts is empty, a rank's rows that are
        all padding); `like` is one sample's array of the group. Device
        tensors stack on the device; host arrays stack on the host, for
        the graph's staging buffer."""
        if any(isinstance(p, torch.Tensor) and p.device == self.device
               for p in parts + [like]):
            pad = torch.zeros_like(self._to_device(like))
            return torch.stack([self._to_device(p) for p in parts]
                               + [pad] * (b - len(parts)))
        like = np.asarray(like)
        out = np.zeros((b,) + like.shape, like.dtype)
        if parts:
            out[:len(parts)] = [np.asarray(p) for p in parts]
        return out

    def _prep_pool_for(self, n: int):
        """The pool for n items of per-sample host prep: None for a few,
        which run inline (a pool would cost more than it saves); for more,
        one 4-thread pool, created under a lock at first use and shut by
        `close` (the mel FFT and the pooling matrices release the GIL)."""
        if n <= 4:
            return None
        with self._pool_lock:
            if self._prep_pool is None:
                self._prep_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="jegal-prep")
            return self._prep_pool

    def _prep_map(self, fn, items):
        """Order-preserving map of per-sample host prep (`_prep_pool_for`)."""
        with annotate("jt.prep"):
            pool = self._prep_pool_for(len(items))
            if pool is None:
                return [fn(x) for x in items]
            return list(pool.map(fn, items))

    @contextlib.contextmanager
    def _prep_stream(self, fills: dict, order: list, chunk_label):
        """The prep that no chunk plan needs (fills: sample index -> its
        log-mel's `_fill_mel`), run on the prep pool in dispatch order
        (`order`, every index of fills), so that later chunks are prepared
        while earlier ones run on the card. Yields ready(chunk): on the
        calling thread, in `jt.prep`, it waits for the chunk's fills (runs
        them, when few enough to run inline) and returns the chunk less any
        sample whose fill raised a ClientError; another error raises with
        a note naming the chunk's samples (chunk_label). On exit nothing
        is left running: fills not started are cancelled, running ones
        waited for."""
        pool = self._prep_pool_for(len(fills))
        jobs = {} if pool is None else {i: pool.submit(fills[i])
                                         for i in order if i in fills}

        def ready(chunk):
            kept = []
            with annotate("jt.prep"):
                for i in chunk:
                    try:
                        if i in jobs:
                            jobs.pop(i).result()
                        elif i in fills:
                            fills[i]()
                    except ClientError:
                        continue
                    except Exception as e:
                        e.add_note("while preparing chunk "
                                   + chunk_label(chunk))
                        raise
                    kept.append(i)
            return kept

        try:
            yield ready
        finally:
            for job in jobs.values():
                job.cancel()
            wait(jobs.values())

    @staticmethod
    def _pipeline(dispatches, settle, chunk_label=None):
        """Depth-1 pipeline: chunk k+1 is prepared, uploaded and launched
        before chunk k is settled, so the host's stacking and the upload
        of one chunk overlap the card's work on the one before. On the card
        nothing in a dispatch waits for it: the upload starts from pinned
        memory, the kernels are queued, and the result's copy to the host
        is queued behind them (`_start_fetch`); settle's host fetch is the
        one wait.

        dispatches: iterator of (chunk indices, *dispatched outputs);
        settle(*item) fetches and post-processes a chunk. A settle error
        surfaces one chunk late, so it carries a note naming the chunk's
        samples (chunk_label maps a chunk's indices to that string)."""
        def guarded(item):
            try:
                with annotate("jt.settle"):
                    settle(*item)
            except Exception as e:
                if chunk_label is not None:
                    e.add_note("while settling pipelined chunk "
                               + chunk_label(item[0]))
                raise

        inflight = None
        for item in dispatches:
            if inflight is not None:
                guarded(inflight)
            inflight = item
        if inflight is not None:
            guarded(inflight)

    @staticmethod
    def _chunk_fnames(samples):
        """chunk_label for _pipeline: sample indices -> their fnames."""
        def label(chunk):
            return str([samples[i].get("fname") or f"#{i}" for i in chunk])

        return label

    @staticmethod
    def _chunk_b(n: int, batch_size: int, ladder: bool, mesh=None) -> int:
        """Padded batch length of an n-sample chunk: the power-of-two
        ladder, or always batch_size with ladder=False; rounded up to a
        multiple of the 'data' size under a mesh."""
        return M.round_to_data(batch_ladder(n, batch_size) if ladder
                               else batch_size, mesh)

    def extract_many(self, samples: list[dict], modalities: str = "vta",
                     batch_size: int = 16, ladder: bool = True,
                     mesh=None) -> list[dict | None]:
        """Batched extraction: samples sharing a shape bucket run as one
        batch on the device, in chunks of batch_size, each chunk one replay
        of its key's graph. ladder=True pads a straggler chunk to the
        power-of-two ladder, not to batch_size (less tail work, at most
        log2(batch_size) + 1 graphs a signature); ladder=False always pads
        to batch_size: one graph a signature, for callers that warmed it
        (a serving batcher warms exactly batch_size and must never meet a
        new ladder size inside a live request).

        samples: dicts with visual_feats / text / word_boundaries / wav /
        fname; for 'v' combos a sample may instead carry "frames" (T, 270,
        480, 3) raw with optional "chin_rows", or (T, 90, 27, 160) planar,
        uint8 host arrays: those run the fused batched path, tower and
        JEGAL forward per chunk with the features kept on the device.
        Returns per-sample result dicts in order, the rows `extract` gives
        (batch padding is neutral), and None for a sample that is invalid
        or malformed: one bad sample never fails the batch.

        mesh: a ('data', 'model') DeviceMesh; the call is then collective
        (every rank calls with the same samples in the same order and
        returns every result): the chunks are planned on every rank from
        the arguments alone (and checked equal across the ranks), each
        chunk's batch rounds up to a multiple of the 'data' size dp, each
        rank stages, uploads and replays only its rows of it in its own
        graph of b / dp rows, and the packed output is gathered over
        'data' before the fetch."""
        self._check_modalities(modalities)
        use = tuple(c in modalities for c in "vta")
        results: list = [None] * len(samples)
        is_fused = [use[0] and s.get("visual_feats") is None
                    and s.get("frames") is not None for s in samples]
        if any(is_fused):
            self._gestsync()     # misconfigured engine, not a bad sample

        def prep_fused(s):
            try:
                frames = np.asarray(s["frames"])
                kind = self._frames_kind(frames)
                chin = s.get("chin_rows")
                if kind == "planar" and chin is not None:
                    raise ClientError("planar input is already masked; "
                                      "chin_rows must be None")
                if chin is not None:
                    self._chin(chin, frames.shape[0])
                plan = self._plan_sample(
                    modalities.replace("v", ""), None, s.get("text"),
                    s.get("word_boundaries"), s.get("wav"))
            except ClientError:
                return None
            return None if plan is None else ((kind, frames, chin, plan[0],
                                               plan[2]), plan[3])

        def prep_two_stage(s):
            try:
                # extract()'s input contract; under the batch contract a
                # violation is a None result, never an ignored tensor
                if s.get("frames") is not None:
                    if not use[0]:
                        raise ClientError(
                            "frames given but modalities lack 'v'")
                    raise ClientError(
                        "pass either frames or visual_feats, not both")
                if s.get("chin_rows") is not None:
                    raise ClientError("chin_rows requires frames")
                plan = self._plan_sample(
                    modalities, s.get("visual_feats"), s.get("text"),
                    s.get("word_boundaries"), s.get("wav"))
            except ClientError:
                return None
            return None if plan is None else (plan[:3], plan[3])

        with annotate("jt.extract_many"):
            plans = self._prep_map(
                lambda item: (prep_fused if is_fused[item[0]]
                              else prep_two_stage)(item[1]),
                list(enumerate(samples)))
            fused = {i: p[0] for i, p in enumerate(plans)
                     if is_fused[i] and p is not None}
            prepared = {i: p[0] for i, p in enumerate(plans)
                        if not is_fused[i] and p is not None}
            fills = {i: p[1] for i, p in enumerate(plans)
                     if p is not None and p[1] is not None}
            fgroups: dict = {}
            for i, (kind, frames, _, arrays, _) in fused.items():
                fgroups.setdefault(
                    (kind, next_bucket(frames.shape[0], T_BUCKETS),
                     self._shape_sig(arrays)), []).append(i)
            groups: dict = {}
            for i, prep in prepared.items():
                groups.setdefault(self._shape_sig(prep[0]), []).append(i)
            M.check_same((modalities, batch_size, ladder,
                          list(fgroups.items()), list(groups.items())),
                         mesh, "extract_many's chunks")
            order = [i for g in (fgroups, groups) for idxs in g.values()
                     for i in idxs]
            with self._prep_stream(fills, order,
                                   self._chunk_fnames(samples)) as ready, \
                    torch.inference_mode():
                if fused:
                    self._extract_many_fused(samples, fused, fgroups, use,
                                             results, batch_size, ladder,
                                             mesh, ready)
                self._extract_many_two_stage(samples, prepared, groups, use,
                                             results, batch_size, ladder,
                                             mesh, ready)
        return results

    @staticmethod
    def _shape_sig(arrays: dict) -> tuple:
        """A sample's arrays' names and per-sample shapes: samples with
        equal signatures stack into one batch."""
        return tuple(sorted((k, tuple(v.shape[1:])) for k, v in arrays.items()))

    def _extract_many_two_stage(self, samples, prepared, groups, use, results,
                                batch_size, ladder, mesh, ready):
        """extract_many's samples without frames: per shape signature
        (groups), chunks of stacked arrays through the JEGAL forward, this
        rank's rows of each under a mesh, each once `ready` (the
        `_prep_stream`'s) has its samples. Writes into `results`."""

        def settle(chunk, fetch):
            packed = self._finish_fetch(fetch)
            t_split = (prepared[chunk[0]][0]["visual_feats"].shape[1]
                       if use[0] else None)
            gesture, content = self._unpack_emb(packed, t_split, use[0],
                                                use[1] or use[2])
            for bi, i in enumerate(chunk):
                _, t_true, w_true = prepared[i]
                s = samples[i]
                results[i] = self._postprocess(
                    gesture, content, bi, t_true, w_true, s.get("text"),
                    s.get("word_boundaries"), s.get("fname"))

        def dispatches():
            for idxs in groups.values():
                for lo in range(0, len(idxs), batch_size):
                    chunk = ready(idxs[lo:lo + batch_size])
                    if not chunk:
                        continue
                    rows = M.batch_rows(self._chunk_b(
                        len(chunk), batch_size, ladder, mesh), mesh)
                    like = prepared[chunk[0]][0]
                    with annotate("jt.stage"):
                        arrays = {k: self._stack_parts(
                            [prepared[i][0][k][0] for i in chunk[rows]],
                            rows.stop - rows.start, like[k][0]) for k in like}
                        launch = self._staged_forward(use, arrays)
                    with annotate("jt.launch"):
                        fetch = self._start_fetch(M.gather_rows(launch(),
                                                                mesh))
                    yield chunk, fetch

        self._pipeline(dispatches(), settle, self._chunk_fnames(samples))

    def _extract_many_fused(self, samples, fused, groups, use, results,
                            batch_size, ladder, mesh, ready):
        """extract_many's frame-carrying samples: per (kind, T bucket,
        content shapes) chunk (groups), one replay of the batched fused
        graph (tower and JEGAL forward, the features never leaving the
        device) on this rank's rows of the chunk under a mesh, its frames,
        chin rows, mask and content written into the graph's pinned
        staging buffers, each once `ready` has its samples. Writes into
        `results`."""
        self._gestsync()

        def settle(chunk, t_bucket, fetch):
            gesture, content = self._unpack_emb(
                self._finish_fetch(fetch), t_bucket, True, use[1] or use[2])
            for bi, i in enumerate(chunk):
                _, frames, _, _, w_true = fused[i]
                s = samples[i]
                results[i] = self._postprocess(
                    gesture, content, bi, frames.shape[0], w_true,
                    s.get("text"), s.get("word_boundaries"), s.get("fname"))

        def dispatches():
            for (kind, t_bucket, _), idxs in groups.items():
                for lo in range(0, len(idxs), batch_size):
                    chunk = ready(idxs[lo:lo + batch_size])
                    if not chunk:
                        continue
                    rows = M.batch_rows(self._chunk_b(
                        len(chunk), batch_size, ladder, mesh), mesh)
                    mine, b = chunk[rows], rows.stop - rows.start
                    like = fused[chunk[0]][3]
                    with annotate("jt.stage"):
                        arrays = {k: self._stack_parts(
                            [fused[i][3][k][0] for i in mine], b, like[k][0])
                            for k in like}
                        launch = self._staged_fused(
                            kind, use[1], use[2], t_bucket, b,
                            [fused[i][1:3] for i in mine], arrays)
                    with annotate("jt.launch"):
                        fetch = self._start_fetch(M.gather_rows(launch(),
                                                                mesh))
                    yield chunk, t_bucket, fetch

        self._pipeline(dispatches(), settle, self._chunk_fnames(samples))

    # ------------------------------------------------------------------
    # Warm start and the .pkl output
    # ------------------------------------------------------------------

    def warmup(self, modalities: str = "vta", t: int = 128, s: int = 64,
               w: int = 16, mel: int = 512, batch: int = 1,
               frames_kind: str | None = None, mesh=None) -> None:
        """Capture (on the CPU: run) the graph of one (combo, bucket) so
        that the first real request replays it (the JAX engine's warmup,
        api.py:1187). Shapes are bucket values from
        jegal_torch.data.bucketing.

        frames_kind ('planar' | 'raw'): the fused frames -> embeddings
        graph instead of the two-stage forward: batch == 1 warms the
        single-clip graph (`extract(frames=...)`), batch > 1 the batched
        chunk graph (`extract_many`'s chunks of that padded batch). The
        inputs take the shapes, dtypes and staging that live requests use,
        so that they hit the graph warmed here.

        mesh: warm what an `extract_many(mesh=)` chunk of `batch` samples
        replays (a collective call, as that one): batch rounds up to a
        multiple of the 'data' size dp, each rank captures its graph of
        batch / dp rows, the batched graph even at batch 1 (as the JAX
        engine), and the output is gathered over 'data' (which also sets
        up the group's communicator ahead of traffic)."""
        self._check_modalities(modalities)
        use_v, use_t, use_a = (c in modalities for c in "vta")
        batch = M.round_to_data(batch, mesh)
        batched = batch > 1 or mesh is not None
        batch //= M.data_size(mesh)       # this rank's rows
        arrays: dict = {}
        if use_t:
            ids = np.full((batch, s), 1, np.int64)
            ids[:, 0] = 0
            arrays.update(input_ids=ids,
                          text_mask=(ids != 1).astype(np.float32),
                          text_pool=np.zeros((batch, w, s), np.float32))
        if use_a:
            arrays.update(audio_mel=np.zeros((batch, mel, 80), np.float32),
                          audio_pool=np.zeros((batch, w, mel // 4),
                                              np.float32),
                          audio_valid=np.full((batch,), mel, np.int64))
        with torch.inference_mode():
            if frames_kind is None:
                if use_v:
                    arrays.update(
                        visual_feats=np.zeros((batch, t, 1024), np.float32),
                        visual_mask=np.ones((batch, t), np.float32))
                out = self._forward((use_v, use_t, use_a), arrays)
            else:
                if not use_v:
                    raise ValueError("frames_kind requires a 'v' combo")
                if frames_kind not in FRAME_SHAPES:
                    raise ValueError(f"frames_kind must be one of "
                                     f"{tuple(FRAME_SHAPES)}, got "
                                     f"{frames_kind!r}")
                # no clip: zero frames, the fallback chin rows
                out = self._fused(frames_kind, use_t, use_a, t,
                                  batch if batched else None, [], arrays)
            M.gather_rows(out, mesh).reshape(-1)[:1].cpu()  # waits for it

    def warmup_all(self, combos=("vta", "vt", "va", "ta", "v", "t", "a"),
                   t_buckets=(128,), s_buckets=(64,), w_buckets=(16,),
                   mel_buckets=(512,), batch: int = 1) -> list[dict]:
        """Warm the two-stage graphs of every combo at the given buckets
        (the cross product of each combo's axes), as the JAX engine's
        warmup_all (api.py:1283). -> one record a graph: combo, its axes,
        batch, and the seconds its capture and first run took."""
        records = []
        for combo in combos:
            axes: dict = {}
            if "v" in combo:
                axes["t"] = t_buckets
            if "t" in combo:
                axes["s"] = s_buckets
                axes["w"] = w_buckets
            if "a" in combo:
                axes["w"] = w_buckets
                axes["mel"] = mel_buckets
            keys = sorted(axes)
            for shape in itertools.product(*(axes[k] for k in keys)):
                kw = dict(zip(keys, shape))
                t0 = time.perf_counter()
                self.warmup(modalities=combo, batch=batch, **kw)
                records.append({"combo": combo, **kw, "batch": batch,
                                "seconds": round(time.perf_counter() - t0,
                                                 3)})
        return records

    def extract_to_pkl(self, res_dir: str, **kw) -> str | None:
        """`extract(**kw)` written to <res_dir>/<fname or "sample">.pkl (the
        reference's .pkl schema: gesture_emb, content_emb, info) -> its
        path, or None (and no file) for an invalid sample."""
        feats = self.extract(**kw)
        if feats is None:
            return None
        os.makedirs(res_dir, exist_ok=True)
        out = os.path.join(res_dir,
                           (feats["info"]["fname"] or "sample") + ".pkl")
        with open(out, "wb") as f:
            pickle.dump(feats, f)
        return out

"""Fused transformer encoder kernels: the sublayer kernels of
csrc/fused_layer.cu, the whole-stack kernel of csrc/encoder_stack.cu, and
their plain PyTorch twins.

Port of jegal_tpu/ops/pallas/fused_layer.py (`_attn_kernel`, `_ffn_kernel`,
`_stack_kernel` and the stack functions `fused_torch_stack`,
`fused_prenorm_stack`, `fused_roberta_stack`). Rows are (R, d) with R a
whole number of contiguous `seg`-row segments (21-token GestSync windows,
or one T- or S-token sequence); attention never crosses a segment.

  * post-norm (prenorm=False): x = LN1(x + Attn(x)); x = LN2(x + FFN(x))
    — torch nn.TransformerEncoderLayer and XLM-R, std LayerNorm;
  * pre-norm (prenorm=True): x = x + Attn(LN1(x)); x = x + FFN(LN2(x))
    — the JEGAL layer, reference LayerNorm; the stack's final norm is the
    caller's.

`attn_sublayer`, `ffn_sublayer` and `encoder_stack` launch their kernel
for a CUDA tensor and run the plain twin for a CPU tensor. Their products
run on the shared 3xTF32 GEMM of csrc/gemm.cuh: the wrapper plans each
product (gemm_plan.plan) and allocates the split-K workspace they share.
Their attention runs on the attention core of csrc/encoder.cuh, on the
same tensor cores, which also sums a split QKV product's partials.
The kernels take float32 only and have no backward: on a CUDA tensor that
needs a gradient they raise (training runs the layer loop,
core/transformer.encoder_stack with fused=False).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import ref_layer_norm, std_layer_norm
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import gemm_plan as GP

_VP, _INT, _PLANS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_SIGS = {
    "jt_attn_sublayer": [_VP] * 13 + [_PLANS] + [_INT] * 6 + [_VP],
    "jt_ffn_sublayer": [_VP] * 11 + [_PLANS] + [_INT] * 6 + [_VP],
    "jt_attention_info": [_INT, _INT, _PLANS],
}
_STACK_SIG = [_VP] * 21 + [_PLANS] + [_INT] * 9 + [_VP]
_ACT = {"relu": 1, "gelu": 2}
_LN_KIND = {"std": 0, "ref": 1}
HEAD_DIMS = (64, 96)   # head widths the attention kernel is built for
# per-layer operands of the stack kernel, in jt_encoder_stack's order
STACK_KEYS = ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2", "g1", "be1",
              "g2", "be2")

# The JAX package's gate of its fused path (fused_layer.py:65-86), kept so
# that the port takes the fused sublayers exactly where the JAX package
# does: segments are packed into blocks of ~336 rows, and one segment must
# fit a block. The CUDA kernels themselves take any segment length; a
# longer sequence (a clip past 512 frames) runs the layer loop and its
# flash attention, as in the JAX package.
_TARGET_ROWS = 336
_MAX_SEG = 512


def block_rows(seg: int) -> int:
    """Rows per block of the JAX package's fused kernels for segment
    length `seg` (whole segments)."""
    if seg > _MAX_SEG:
        raise ValueError(f"segment length {seg} > {_MAX_SEG}")
    return seg * max(1, _TARGET_ROWS // seg)


def fused_stack_ok(seg: int, d: int, num_heads: int) -> bool:
    """Shape gate of the fused path: whole segments tile into 8-row
    aligned blocks and the heads split d evenly."""
    if seg > _MAX_SEG or d % num_heads or d % 128:
        return False
    return block_rows(seg) % 8 == 0


def _ln(x, g, b, kind: str):
    p = {"scale": g, "bias": b}
    return ref_layer_norm(p, x) if kind == "ref" else std_layer_norm(p, x)


def fused_weights(layer) -> dict:
    """One layer's tree (core/transformer layout) -> the sublayer operands:
    QKV kernels concatenated into one (d, 3d) product."""
    a, f = layer["attn"], layer["ff"]
    return dict(
        wqkv=torch.cat([a["q"]["kernel"], a["k"]["kernel"], a["v"]["kernel"]],
                       dim=1).contiguous(),
        bqkv=torch.cat([a["q"]["bias"], a["k"]["bias"], a["v"]["bias"]]),
        wo=a["o"]["kernel"].contiguous(), bo=a["o"]["bias"].contiguous(),
        g1=layer["norm1"]["scale"].contiguous(),
        be1=layer["norm1"]["bias"].contiguous(),
        w1=f["w1"]["kernel"].contiguous(), b1=f["w1"]["bias"].contiguous(),
        w2=f["w2"]["kernel"].contiguous(), b2=f["w2"]["bias"].contiguous(),
        g2=layer["norm2"]["scale"].contiguous(),
        be2=layer["norm2"]["bias"].contiguous(),
    )


def stacked_weights(layers) -> dict:
    """Layer trees (core/transformer layout) -> the stack kernel's operands:
    each of STACK_KEYS as one contiguous (L, ...) tensor, QKV concatenated
    (the layout of the JAX package's `_stacked_weights`, without its
    singleton middle axis on the vectors). Build it once at load time: the
    stack kernel reads layer l at offset l and copies nothing per call."""
    per_layer = [fused_weights(layer) for layer in layers]
    return {k: torch.stack([w[k] for w in per_layer]).contiguous()
            for k in STACK_KEYS}


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def attention_plain(qkv, seg: int, heads: int, kmask=None):
    """Per-segment multi-head attention of (R, 3d) QKV rows -> (R, d), with
    the kernels' -1e9 fill of masked keys: the attention core's twin."""
    r, d = qkv.shape[0], qkv.shape[1] // 3
    n, dk = r // seg, d // heads

    def split(t):  # (R, d) -> (n, heads, seg, dk)
        return t.reshape(n, seg, heads, dk).transpose(1, 2)

    q, k, v = (split(t) for t in qkv.split(d, dim=1))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
    if kmask is not None:
        s = s.masked_fill(kmask.reshape(n, 1, 1, seg) == 0, -1e9)
    a = torch.matmul(torch.softmax(s, dim=-1), v)
    return a.transpose(1, 2).reshape(r, d)


def attn_sublayer_plain(x, w, seg: int, heads: int, *, prenorm: bool,
                        ln_kind: str, kmask=None):
    h = _ln(x, w["g1"], w["be1"], ln_kind) if prenorm else x
    qkv = torch.matmul(h, w["wqkv"]) + w["bqkv"]
    a = attention_plain(qkv, seg, heads, kmask)
    y = x + (torch.matmul(a, w["wo"]) + w["bo"])
    return y if prenorm else _ln(y, w["g1"], w["be1"], ln_kind)


def ffn_sublayer_plain(x, w, *, prenorm: bool, ln_kind: str,
                       activation: str = "relu"):
    h = _ln(x, w["g2"], w["be2"], ln_kind) if prenorm else x
    h1 = torch.matmul(h, w["w1"]) + w["b1"]
    h1 = F.gelu(h1) if activation == "gelu" else torch.relu(h1)
    y = x + (torch.matmul(h1, w["w2"]) + w["b2"])
    return y if prenorm else _ln(y, w["g2"], w["be2"], ln_kind)


def encoder_stack_plain(x, w, seg: int, heads: int, *, prenorm: bool,
                        ln_kind: str, activation: str = "relu", kmask=None):
    """L x (attention sublayer, FFN sublayer) over the stacked operands,
    with the kernel's -1e9 fill of masked keys."""
    for l in range(w["wqkv"].shape[0]):
        wl = {k: w[k][l] for k in STACK_KEYS}
        x = attn_sublayer_plain(x, wl, seg, heads, prenorm=prenorm,
                                ln_kind=ln_kind, kmask=kmask)
        x = ffn_sublayer_plain(x, wl, prenorm=prenorm, ln_kind=ln_kind,
                               activation=activation)
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(x, seg: int | None = None, heads: int | None = None):
    if x.dim() != 2:
        raise ValueError(f"rows must be (R, d), got {tuple(x.shape)}")
    _build.check_operand("x", x, x.shape, x.device)
    r, d = x.shape
    if seg is not None and (seg <= 0 or r % seg):
        raise ValueError(f"{r} rows do not split into segments of {seg}")
    if heads is not None and (d % heads or d // heads not in HEAD_DIMS):
        raise ValueError(f"d={d} over {heads} heads: the attention kernel "
                         f"takes head widths {HEAD_DIMS}")


def stack_products(r: int, d: int, dff: int):
    """(M, N, K) of a layer's four products, in the order the sublayer
    and stack entries take their plans: QKV, output, W1, W2."""
    return ((r, 3 * d, d), (r, d, d), (r, dff, d), (r, d, dff))


def _lib():
    lib = _build.library("fused_layer")
    for fn, args in _SIGS.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _stack_lib():
    lib = _build.library("encoder_stack")
    lib.jt_encoder_stack.argtypes = _STACK_SIG
    lib.jt_encoder_stack.restype = ctypes.c_int
    return lib


def gemm_operands(products, sms: int, dev):
    """Plans of the products (M, N, K), in the C entry's order, as the
    entry's int array ({BM, BN, splits} each), and the split-K workspace
    they share in turn (None when no product splits)."""
    plans = [GP.plan(m, n, k, sms) for m, n, k in products]
    n_ws = max(GP.workspace_floats(m, n, p[2])
               for (m, n, _), p in zip(products, plans))
    ws = (torch.empty(n_ws, device=dev, dtype=torch.float32) if n_ws
          else None)
    flat = [v for p in plans for v in p]
    return (ctypes.c_int * len(flat))(*flat), ws


def _kmask_operand(kmask, r: int, dev):
    """A key mask of any numeric type -> the kernels' contiguous float32
    (R,) operand, in which 0.0 is masked."""
    if kmask is None:
        return None
    kmask = kmask.to(dtype=torch.float32).reshape(-1).contiguous()
    _build.check_operand("kmask", kmask, (r,), dev)
    return kmask


def attention_info(dk: int, packed: bool) -> dict:
    """What the compiler and the occupancy calculator say of the attention
    core (csrc/encoder.cuh) for head width `dk` under one schedule, packed
    (segments of up to 64 rows) or streamed: registers and spill bytes a
    thread, dynamic shared memory a block and resident blocks an SM (on the
    current card)."""
    lib = _lib()
    info = (ctypes.c_int * 4)()
    _build.check(lib, lib.jt_attention_info(dk, int(packed), info),
                 "attention core info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def attn_sublayer(x, w, seg: int, heads: int, *, prenorm: bool, ln_kind: str,
                  kmask=None):
    """One attention sublayer over (R, d) rows of `seg`-row segments.
    kmask: optional (R,) key validity, 0 = masked."""
    if not x.is_cuda:
        return attn_sublayer_plain(x, w, seg, heads, prenorm=prenorm,
                                   ln_kind=ln_kind, kmask=kmask)
    _build.refuse_grad("attention sublayer kernel", x, kmask, *w.values())
    _check_rows(x, seg, heads)
    r, d = x.shape
    dev = x.device
    for name, shape in (("wqkv", (d, 3 * d)), ("bqkv", (3 * d,)),
                        ("wo", (d, d)), ("bo", (d,)), ("g1", (d,)),
                        ("be1", (d,))):
        _build.check_operand(name, w[name], shape, dev)
    kmask = _kmask_operand(kmask, r, dev)
    out = torch.empty_like(x)
    qkv = torch.empty((r, 3 * d), device=dev, dtype=torch.float32)
    att = torch.empty_like(x)
    h = torch.empty_like(x) if prenorm else None
    plans, ws = gemm_operands(((r, 3 * d, d), (r, d, d)), GP.sm_count(dev),
                              dev)
    lib = _lib()
    P = _build.ptr
    rc = lib.jt_attn_sublayer(
        P(x), P(w["wqkv"]), P(w["bqkv"]), P(w["wo"]), P(w["bo"]), P(w["g1"]),
        P(w["be1"]), P(kmask), P(h), P(qkv), P(att), P(out), P(ws), plans, r,
        d, heads, seg, int(prenorm), _LN_KIND[ln_kind],
        _build.stream_ptr(dev))
    _build.check(lib, rc, "attention sublayer kernel")
    _build.LAUNCHES["attn_sublayer"] += 1
    return out


def ffn_sublayer(x, w, *, prenorm: bool, ln_kind: str,
                 activation: str = "relu"):
    """One FFN sublayer over (R, d) rows."""
    if not x.is_cuda:
        return ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind=ln_kind,
                                  activation=activation)
    _build.refuse_grad("FFN sublayer kernel", x, *w.values())
    _check_rows(x)
    r, d = x.shape
    dff = w["w1"].shape[1]
    dev = x.device
    for name, shape in (("w1", (d, dff)), ("b1", (dff,)), ("w2", (dff, d)),
                        ("b2", (d,)), ("g2", (d,)), ("be2", (d,))):
        _build.check_operand(name, w[name], shape, dev)
    out = torch.empty_like(x)
    h1 = torch.empty((r, dff), device=dev, dtype=torch.float32)
    h = torch.empty_like(x) if prenorm else None
    plans, ws = gemm_operands(((r, dff, d), (r, d, dff)), GP.sm_count(dev),
                              dev)
    lib = _lib()
    P = _build.ptr
    rc = lib.jt_ffn_sublayer(
        P(x), P(w["w1"]), P(w["b1"]), P(w["w2"]), P(w["b2"]), P(w["g2"]),
        P(w["be2"]), P(h), P(h1), P(out), P(ws), plans, r, d, dff,
        int(prenorm), _LN_KIND[ln_kind], _ACT[activation],
        _build.stream_ptr(dev))
    _build.check(lib, rc, "FFN sublayer kernel")
    _build.LAUNCHES["ffn_sublayer"] += 1
    return out


def encoder_stack(x, w, seg: int, heads: int, *, prenorm: bool,
                  ln_kind: str, activation: str = "relu", kmask=None):
    """A whole L-layer stack over (R, d) rows of `seg`-row segments, in one
    call. w: the `stacked_weights` dict. kmask: optional (R,) key
    validity, 0 = masked."""
    if not x.is_cuda:
        return encoder_stack_plain(x, w, seg, heads, prenorm=prenorm,
                                   ln_kind=ln_kind, activation=activation,
                                   kmask=kmask)
    _build.refuse_grad("encoder stack kernel", x, kmask, *w.values())
    _check_rows(x, seg, heads)
    r, d = x.shape
    n_l, dff = w["w1"].shape[0], w["w1"].shape[-1]
    dev = x.device
    for name, shape in (("wqkv", (d, 3 * d)), ("bqkv", (3 * d,)),
                        ("wo", (d, d)), ("bo", (d,)), ("w1", (d, dff)),
                        ("b1", (dff,)), ("w2", (dff, d)), ("b2", (d,)),
                        ("g1", (d,)), ("be1", (d,)), ("g2", (d,)),
                        ("be2", (d,))):
        _build.check_operand(name, w[name], (n_l, *shape), dev)
    kmask = _kmask_operand(kmask, r, dev)
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    att = torch.empty_like(x)
    qkv = torch.empty((r, 3 * d), device=dev, dtype=torch.float32)
    h1 = torch.empty((r, dff), device=dev, dtype=torch.float32)
    h = torch.empty_like(x) if prenorm else None
    plans, ws = gemm_operands(stack_products(r, d, dff), GP.sm_count(dev),
                              dev)
    lib = _stack_lib()
    P = _build.ptr
    rc = lib.jt_encoder_stack(
        P(x), *(P(w[k]) for k in STACK_KEYS), P(kmask), P(h), P(qkv), P(att),
        P(y), P(h1), P(out), P(ws), plans, r, d, dff, heads, seg, n_l,
        int(prenorm), _LN_KIND[ln_kind], _ACT[activation],
        _build.stream_ptr(dev))
    _build.check(lib, rc, "encoder stack kernel")
    _build.LAUNCHES["encoder_stack"] += 1
    return out


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def fused_encoder_stack(layers, x, seg: int, num_heads: int, *,
                        prenorm: bool, ln_kind: str, kmask=None,
                        activation: str = "relu"):
    """All layers over (R, d) rows of contiguous `seg`-row segments, one
    attention and one FFN sublayer call per layer."""
    if x.shape[0] % seg:
        raise ValueError(f"{x.shape[0]} rows do not split into segments "
                         f"of {seg}")
    for layer in layers:
        w = fused_weights(layer)
        x = attn_sublayer(x, w, seg, num_heads, prenorm=prenorm,
                          ln_kind=ln_kind, kmask=kmask)
        x = ffn_sublayer(x, w, prenorm=prenorm, ln_kind=ln_kind,
                         activation=activation)
    return x


def fused_torch_stack(stack, x, seg: int, num_heads: int, kmask=None):
    """core/transformer.torch_encoder_stack over (R, d) rows (post-norm,
    std LN)."""
    return fused_encoder_stack(stack["layers"], x, seg, num_heads,
                               prenorm=False, ln_kind="std", kmask=kmask)


def fused_prenorm_stack(stack, x, seg: int, num_heads: int, kmask=None):
    """The JEGAL pre-norm stack (ref LN) WITHOUT its final norm."""
    return fused_encoder_stack(stack["layers"], x, seg, num_heads,
                               prenorm=True, ln_kind="ref", kmask=kmask)


def fused_roberta_stack(layers, x, seg: int, num_heads: int, kmask=None):
    """BERT/XLM-R encoder layers (post-norm, std LN eps 1e-5, exact-GELU
    FFN) over (R, d) rows of contiguous `seg`-token sequences, as ONE
    encoder_stack call. `layers`: a `stacked_weights` dict (what
    models/roberta.stack_layers precomputes), or a list of layer trees in
    the core/transformer layout, stacked here. The kernel FILLS masked
    scores with -1e9 where HF ADDS finfo.min: after the softmax's max
    subtraction both weigh a masked key exactly 0, so every valid query row
    matches HF (models/roberta.py)."""
    w = layers if isinstance(layers, dict) else stacked_weights(layers)
    return encoder_stack(x, w, seg, num_heads, prenorm=False, ln_kind="std",
                         activation="gelu", kmask=kmask)

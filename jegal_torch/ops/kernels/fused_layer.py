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
run on the shared 3xTF32 GEMM of csrc/gemm.cuh (bf16: its wgmma product):
the wrapper plans each product (gemm_plan.plan, or plan_bf16) and
allocates the split-K workspace they share (bf16: and the tiles'
counters). Their attention runs on the attention core of csrc/encoder.cuh,
on the same tensor cores, which also sums a split float32 QKV product's
partials (bf16: its own core over the QKV product's bf16 rows).
Each entry takes float32 rows or bf16 rows, the JAX engine's two compute
dtypes, and dispatches on the rows' dtype to the kernel (or twin) of that
dtype; any other dtype raises, nothing is cast quietly (but for the
exact upcast of mixed bf16 and float32 biases and norms). The bf16 kernels
and twins round where the JAX package's kernels round a bf16 block
(`_attn_kernel`, `_ffn_kernel`, `_stack_kernel`): products of bf16
operands summed in float32, LayerNorm, softmax and the residual in
float32, and bf16 at the product inputs, q * scale, k, v, p, the attention
output, the activated FFN hidden rows and the output. Weights are bf16,
biases and norms bf16 or float32, read as float32. The kernels have no
backward: on a CUDA tensor that needs a gradient they raise (training runs
the layer loop, core/transformer.encoder_stack with fused=False).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
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
    "jt_attn_sublayer_bf16": [_VP] * 14 + [_PLANS] + [_INT] * 8 + [_VP],
    "jt_ffn_sublayer_bf16": [_VP] * 12 + [_PLANS] + [_INT] * 8 + [_VP],
    "jt_attention_info_bf16": [_INT, _INT, _PLANS],
    "jt_gemm_info_bf16": [_INT, _INT, _PLANS],
}
DTYPES = (torch.float32, torch.bfloat16)   # row dtypes the kernels take
# the launch counter of each kernel, by row dtype
_COUNTER = {("attn", torch.float32): "attn_sublayer",
            ("attn", torch.bfloat16): "attn_sublayer_bf16",
            ("ffn", torch.float32): "ffn_sublayer",
            ("ffn", torch.bfloat16): "ffn_sublayer_bf16",
            ("stack", torch.float32): "encoder_stack",
            ("stack", torch.bfloat16): "encoder_stack_bf16"}
_STACK_SIG = [_VP] * 21 + [_PLANS] + [_INT] * 9 + [_VP]
_STACK_BF16_SIG = [_VP] * 24 + [_PLANS] + [_INT] * 11 + [_VP]
_ACT = {"relu": 1, "gelu": 2}
_LN_KIND = {"std": 0, "ref": 1}
HEAD_DIMS = (64, 96)   # head widths the attention kernel is built for
# the longest segment the bf16 attention core stages whole
# (csrc/encoder.cuh: AB_MAX_SEG); the engines route longer sequences to the
# layer loop, as the fused gate's _MAX_SEG
MAX_SEG_BF16 = 512
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

def _row_dtype(x):
    """The rows' dtype, which picks the kernel or twin; raise for a dtype
    that none takes."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the encoder kernels take float32 or bfloat16 rows, "
                        f"got {x.dtype}")
    return x.dtype


def _f32(t):
    return None if t is None else t.to(torch.float32)


def _bf(t):
    """Round a float32 tensor to bf16 and keep it in float32 (exact)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _ln_f32(x, g, b, kind: str):
    """LayerNorm in float32 in the order of the JAX package's `_ln_f32`
    (fused_layer.py:88-101), on float32 operands."""
    mean = x.mean(dim=-1, keepdim=True)
    cen = x - mean
    if kind == "ref":
        var = (cen * cen).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
        y = cen / (torch.sqrt(var) + np.float32(1e-6))
    else:
        var = (cen * cen).mean(dim=-1, keepdim=True)
        y = cen * torch.rsqrt(var + np.float32(1e-5))
    return y * g + b


def _attention_bf16(qkv, seg: int, heads: int, kmask):
    """The bf16 attention of `_attn_kernel` over float32 QKV rows (bias
    added): q * scale, k and v rounded to bf16, float32 scores, the -1e9
    fill and the softmax in float32, p rounded to bf16, the output rounded
    to bf16 -> (R, d) float32 holding bf16 values."""
    r, d = qkv.shape[0], qkv.shape[1] // 3
    n, dk = r // seg, d // heads
    scale = np.float32(1.0 / math.sqrt(dk))

    def split(t):  # (R, d) -> (n, heads, seg, dk)
        return t.reshape(n, seg, heads, dk).transpose(1, 2)

    q = split(_bf(qkv[:, :d] * scale))
    k, v = split(_bf(qkv[:, d:2 * d])), split(_bf(qkv[:, 2 * d:]))
    s = torch.matmul(q, k.transpose(-1, -2))
    if kmask is not None:
        s = s.masked_fill(kmask.reshape(n, 1, 1, seg) == 0, np.float32(-1e9))
    a = torch.matmul(_bf(torch.softmax(s, dim=-1)), v)
    return _bf(a.transpose(1, 2).reshape(r, d))


def _attn_f32_rows(x32, w, seg, heads, prenorm, ln_kind, kmask):
    """`_attn_kernel`'s bf16 arithmetic on the float32 residual stream x32
    -> float32 rows (not yet rounded)."""
    g, b = _f32(w["g1"]), _f32(w["be1"])
    h = _ln_f32(x32, g, b, ln_kind) if prenorm else x32
    qkv = torch.matmul(_bf(h), _f32(w["wqkv"])) + _f32(w["bqkv"])
    a = _attention_bf16(qkv, seg, heads, kmask)
    y = x32 + torch.matmul(a, _f32(w["wo"])) + _f32(w["bo"])
    return y if prenorm else _ln_f32(y, g, b, ln_kind)


def _ffn_f32_rows(x32, w, prenorm, ln_kind, activation):
    """`_ffn_kernel`'s bf16 arithmetic on x32 -> float32 rows."""
    g, b = _f32(w["g2"]), _f32(w["be2"])
    h = _ln_f32(x32, g, b, ln_kind) if prenorm else x32
    h1 = torch.matmul(_bf(h), _f32(w["w1"])) + _f32(w["b1"])
    h1 = _bf(F.gelu(h1) if activation == "gelu" else torch.relu(h1))
    y = x32 + torch.matmul(h1, _f32(w["w2"])) + _f32(w["b2"])
    return y if prenorm else _ln_f32(y, g, b, ln_kind)


def attn_sublayer_plain_bf16(x, w, seg: int, heads: int, *, prenorm: bool,
                             ln_kind: str, kmask=None):
    """The bf16 attention sublayer's twin: bf16 rows -> bf16 rows. Every
    operand is upcast to float32 (exact) and every product runs in float32
    (no bf16 matmul, whose reduction may be in reduced precision), with
    bf16 rounding at `_attn_kernel`'s sites."""
    return _attn_f32_rows(_f32(x), w, seg, heads, prenorm, ln_kind,
                          kmask).to(torch.bfloat16)


def ffn_sublayer_plain_bf16(x, w, *, prenorm: bool, ln_kind: str,
                            activation: str = "relu"):
    """The bf16 FFN sublayer's twin, as `attn_sublayer_plain_bf16`."""
    return _ffn_f32_rows(_f32(x), w, prenorm, ln_kind,
                         activation).to(torch.bfloat16)


def encoder_stack_plain_bf16(x, w, seg: int, heads: int, *, prenorm: bool,
                             ln_kind: str, activation: str = "relu",
                             kmask=None):
    """The bf16 stack's twin: as `_stack_kernel`, the residual stream stays
    float32 from layer to layer (its VMEM scratch) and only the output is
    rounded to bf16; each product's input is rounded to bf16."""
    x32 = _f32(x)
    for l in range(w["wqkv"].shape[0]):
        wl = {k: w[k][l] for k in STACK_KEYS}
        x32 = _attn_f32_rows(x32, wl, seg, heads, prenorm, ln_kind, kmask)
        x32 = _ffn_f32_rows(x32, wl, prenorm, ln_kind, activation)
    return x32.to(torch.bfloat16)


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
    if _row_dtype(x) == torch.bfloat16:
        return attn_sublayer_plain_bf16(x, w, seg, heads, prenorm=prenorm,
                                        ln_kind=ln_kind, kmask=kmask)
    h = _ln(x, w["g1"], w["be1"], ln_kind) if prenorm else x
    qkv = torch.matmul(h, w["wqkv"]) + w["bqkv"]
    a = attention_plain(qkv, seg, heads, kmask)
    y = x + (torch.matmul(a, w["wo"]) + w["bo"])
    return y if prenorm else _ln(y, w["g1"], w["be1"], ln_kind)


def ffn_sublayer_plain(x, w, *, prenorm: bool, ln_kind: str,
                       activation: str = "relu"):
    if _row_dtype(x) == torch.bfloat16:
        return ffn_sublayer_plain_bf16(x, w, prenorm=prenorm,
                                       ln_kind=ln_kind, activation=activation)
    h = _ln(x, w["g2"], w["be2"], ln_kind) if prenorm else x
    h1 = torch.matmul(h, w["w1"]) + w["b1"]
    h1 = F.gelu(h1) if activation == "gelu" else torch.relu(h1)
    y = x + (torch.matmul(h1, w["w2"]) + w["b2"])
    return y if prenorm else _ln(y, w["g2"], w["be2"], ln_kind)


def encoder_stack_plain(x, w, seg: int, heads: int, *, prenorm: bool,
                        ln_kind: str, activation: str = "relu", kmask=None):
    """L x (attention sublayer, FFN sublayer) over the stacked operands,
    with the kernel's -1e9 fill of masked keys."""
    if _row_dtype(x) == torch.bfloat16:
        return encoder_stack_plain_bf16(x, w, seg, heads, prenorm=prenorm,
                                        ln_kind=ln_kind,
                                        activation=activation, kmask=kmask)
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
    _build.check_operand("x", x, x.shape, x.device, _row_dtype(x))
    r, d = x.shape
    if seg is not None and (seg <= 0 or r % seg):
        raise ValueError(f"{r} rows do not split into segments of {seg}")
    if seg is not None and x.dtype == torch.bfloat16 and seg > MAX_SEG_BF16:
        raise ValueError(f"segments of {seg} rows: the bf16 attention core "
                         f"takes up to {MAX_SEG_BF16}")
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
    lib.jt_encoder_stack_bf16.argtypes = _STACK_BF16_SIG
    lib.jt_encoder_stack_bf16.restype = ctypes.c_int
    return lib


def _int_array(plans):
    flat = [v for p in plans for v in p]
    return (ctypes.c_int * len(flat))(*flat)


def gemm_operands(products, sms: int, dev):
    """Plans of the products (M, N, K), in the C entry's order, as the
    entry's int array ({BM, BN, splits} each), and the split-K workspace
    they share in turn (None when no product splits)."""
    plans = [GP.plan(m, n, k, sms) for m, n, k in products]
    n_ws = max(GP.workspace_floats(m, n, p[2])
               for (m, n, _), p in zip(products, plans))
    ws = (torch.empty(n_ws, device=dev, dtype=torch.float32) if n_ws
          else None)
    return _int_array(plans), ws


def gemm_operands_bf16(products, sms: int, dev, ln):
    """`gemm_operands` of the bf16 products (gemm_plan.plan_bf16): the
    plans, the float32 workspace they share in turn (split partials, and
    the rows of a product a LayerNorm follows: `ln`, per product), None
    when none needs it, and the tiles' int32 counters (None when no
    product splits; the C entry zeroes them)."""
    plans = [GP.plan_bf16(m, n, k, sms) for m, n, k in products]
    need = [GP.workspace_bf16(m, n, p, rows)
            for (m, n, _), p, rows in zip(products, plans, ln)]
    n_ws = max(f for f, _ in need)
    n_cnt = max(c for _, c in need)
    ws = (torch.empty(n_ws, device=dev, dtype=torch.float32) if n_ws
          else None)
    cnt = (torch.empty(n_cnt, device=dev, dtype=torch.int32) if n_cnt
           else None)
    return _int_array(plans), ws, cnt


def _numel(t) -> int:
    return 0 if t is None else t.numel()


def _kmask_operand(kmask, r: int, dev):
    """A key mask of any numeric type -> the kernels' contiguous float32
    (R,) operand, in which 0.0 is masked."""
    if kmask is None:
        return None
    kmask = kmask.to(dtype=torch.float32).reshape(-1).contiguous()
    _build.check_operand("kmask", kmask, (r,), dev)
    return kmask


def _operands(w, shapes: dict, dev, dt, lead=()):
    """The weights of `shapes` checked for the kernel of row dtype `dt`, and
    the dtype the kernel reads the biases and norms in. float32 rows: all as
    they are, float32. bf16 rows: the product weights (`w*`) bf16; the
    biases and norms bf16 when all of them are (the kernels read them as
    float32 in registers, exact), else all upcast to float32 (exact), as
    the JAX package passes them to its kernels (`_row2(..., jnp.float32)`)."""
    vec = [n for n in shapes if not n.startswith("w")]
    vdt = torch.float32
    if dt == torch.bfloat16 and all(w[n].dtype == dt for n in vec):
        vdt = dt
    out = {}
    for name, shape in shapes.items():
        t = w[name]
        if dt == torch.bfloat16 and name in vec and t.dtype != vdt:
            t = t.to(vdt).contiguous()
        want = dt if name.startswith("w") else vdt
        _build.check_operand(name, t, lead + shape, dev, want)
        out[name] = t
    return out, vdt


_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")


def attention_info(dk: int, packed: bool, bf16: bool = False) -> dict:
    """What the compiler and the occupancy calculator say of the attention
    core (csrc/encoder.cuh; its bf16 core with bf16=True, streamed at its
    longest segment) for head width `dk` under one schedule, packed
    (segments of up to 64 rows) or streamed: registers and spill bytes a
    thread, dynamic shared memory a block and resident blocks an SM (on
    the current card)."""
    lib = _lib()
    info = (ctypes.c_int * 4)()
    fn = lib.jt_attention_info_bf16 if bf16 else lib.jt_attention_info
    _build.check(lib, fn(dk, int(packed), info), "attention core info")
    return dict(zip(_INFO_KEYS, info))


def gemm_info_bf16(tile) -> dict:
    """`attention_info`'s keys for the bf16 product's (BM, BN) tile
    (gemm_plan.TILES_BF16)."""
    lib = _lib()
    info = (ctypes.c_int * 4)()
    _build.check(lib, lib.jt_gemm_info_bf16(*tile, info), "bf16 GEMM info")
    return dict(zip(_INFO_KEYS, info))


def attn_sublayer(x, w, seg: int, heads: int, *, prenorm: bool, ln_kind: str,
                  kmask=None):
    """One attention sublayer over (R, d) rows of `seg`-row segments, float32
    or bf16 (the kernel of that dtype). kmask: optional (R,) key validity,
    0 = masked."""
    if not x.is_cuda:
        return attn_sublayer_plain(x, w, seg, heads, prenorm=prenorm,
                                   ln_kind=ln_kind, kmask=kmask)
    _build.refuse_grad("attention sublayer kernel", x, kmask, *w.values())
    _check_rows(x, seg, heads)
    r, d = x.shape
    dev, dt = x.device, x.dtype
    w, vdt = _operands(w, {"wqkv": (d, 3 * d), "bqkv": (3 * d,),
                           "wo": (d, d), "bo": (d,), "g1": (d,), "be1": (d,)},
                       dev, dt)
    kmask = _kmask_operand(kmask, r, dev)
    out = torch.empty_like(x)
    att = torch.empty_like(x)
    h = torch.empty_like(x) if prenorm else None
    lib = _lib()
    P = _build.ptr
    products = ((r, 3 * d, d), (r, d, d))
    ops = (P(x), P(w["wqkv"]), P(w["bqkv"]), P(w["wo"]), P(w["bo"]),
           P(w["g1"]), P(w["be1"]), P(kmask), P(h))
    if dt == torch.bfloat16:
        qkv = torch.empty((r, 3 * d), device=dev, dtype=dt)
        plans, ws, cnt = gemm_operands_bf16(products, GP.sm_count(dev), dev,
                                            (False, not prenorm))
        rc = lib.jt_attn_sublayer_bf16(
            *ops, P(qkv), P(att), P(out), P(ws), P(cnt), plans, r, d, heads,
            seg, int(prenorm), _LN_KIND[ln_kind], int(vdt == torch.float32),
            _numel(cnt), _build.stream_ptr(dev))
    else:
        qkv = torch.empty((r, 3 * d), device=dev, dtype=torch.float32)
        plans, ws = gemm_operands(products, GP.sm_count(dev), dev)
        rc = lib.jt_attn_sublayer(
            *ops, P(qkv), P(att), P(out), P(ws), plans, r, d, heads, seg,
            int(prenorm), _LN_KIND[ln_kind], _build.stream_ptr(dev))
    _build.check(lib, rc, "attention sublayer kernel")
    _build.LAUNCHES[_COUNTER["attn", dt]] += 1
    return out


def ffn_sublayer(x, w, *, prenorm: bool, ln_kind: str,
                 activation: str = "relu"):
    """One FFN sublayer over (R, d) rows, float32 or bf16."""
    if not x.is_cuda:
        return ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind=ln_kind,
                                  activation=activation)
    _build.refuse_grad("FFN sublayer kernel", x, *w.values())
    _check_rows(x)
    r, d = x.shape
    dff = w["w1"].shape[1]
    dev, dt = x.device, x.dtype
    w, vdt = _operands(w, {"w1": (d, dff), "b1": (dff,), "w2": (dff, d),
                           "b2": (d,), "g2": (d,), "be2": (d,)}, dev, dt)
    out = torch.empty_like(x)
    h1 = torch.empty((r, dff), device=dev, dtype=dt)
    h = torch.empty_like(x) if prenorm else None
    lib = _lib()
    P = _build.ptr
    products = ((r, dff, d), (r, d, dff))
    ops = (P(x), P(w["w1"]), P(w["b1"]), P(w["w2"]), P(w["b2"]), P(w["g2"]),
           P(w["be2"]), P(h), P(h1), P(out))
    if dt == torch.bfloat16:
        plans, ws, cnt = gemm_operands_bf16(products, GP.sm_count(dev), dev,
                                            (False, not prenorm))
        rc = lib.jt_ffn_sublayer_bf16(
            *ops, P(ws), P(cnt), plans, r, d, dff, int(prenorm),
            _LN_KIND[ln_kind], _ACT[activation], int(vdt == torch.float32),
            _numel(cnt), _build.stream_ptr(dev))
    else:
        plans, ws = gemm_operands(products, GP.sm_count(dev), dev)
        rc = lib.jt_ffn_sublayer(
            *ops, P(ws), plans, r, d, dff, int(prenorm), _LN_KIND[ln_kind],
            _ACT[activation], _build.stream_ptr(dev))
    _build.check(lib, rc, "FFN sublayer kernel")
    _build.LAUNCHES[_COUNTER["ffn", dt]] += 1
    return out


def encoder_stack(x, w, seg: int, heads: int, *, prenorm: bool,
                  ln_kind: str, activation: str = "relu", kmask=None):
    """A whole L-layer stack over (R, d) rows of `seg`-row segments, in one
    call, float32 or bf16. w: the `stacked_weights` dict. kmask: optional
    (R,) key validity, 0 = masked."""
    if not x.is_cuda:
        return encoder_stack_plain(x, w, seg, heads, prenorm=prenorm,
                                   ln_kind=ln_kind, activation=activation,
                                   kmask=kmask)
    _build.refuse_grad("encoder stack kernel", x, kmask, *w.values())
    _check_rows(x, seg, heads)
    r, d = x.shape
    n_l, dff = w["w1"].shape[0], w["w1"].shape[-1]
    dev, dt = x.device, x.dtype
    w, vdt = _operands(w, {"wqkv": (d, 3 * d), "bqkv": (3 * d,),
                           "wo": (d, d), "bo": (d,), "w1": (d, dff),
                           "b1": (dff,), "w2": (dff, d), "b2": (d,),
                           "g1": (d,), "be1": (d,), "g2": (d,), "be2": (d,)},
                       dev, dt, (n_l,))
    kmask = _kmask_operand(kmask, r, dev)
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    att = torch.empty_like(x)
    h1 = torch.empty((r, dff), device=dev, dtype=dt)
    h = torch.empty_like(x) if prenorm else None
    lib = _stack_lib()
    P = _build.ptr
    if dt == torch.bfloat16:
        qkv = torch.empty((r, 3 * d), device=dev, dtype=dt)
        plans, ws, cnt = gemm_operands_bf16(
            stack_products(r, d, dff), GP.sm_count(dev), dev,
            (False, not prenorm, False, not prenorm))
        # the float32 residual stream between the sublayers and layers
        # (`_stack_kernel`'s scratch), beside its bf16 copies y and out
        y32 = torch.empty((r, d), device=dev, dtype=torch.float32)
        r32 = torch.empty((r, d), device=dev, dtype=torch.float32)
        rc = lib.jt_encoder_stack_bf16(
            P(x), *(P(w[k]) for k in STACK_KEYS), P(kmask), P(h), P(qkv),
            P(att), P(y32), P(y), P(h1), P(r32), P(out), P(ws), P(cnt),
            plans, r, d, dff, heads, seg, n_l, int(prenorm),
            _LN_KIND[ln_kind], _ACT[activation], int(vdt == torch.float32),
            _numel(cnt), _build.stream_ptr(dev))
    else:
        qkv = torch.empty((r, 3 * d), device=dev, dtype=torch.float32)
        plans, ws = gemm_operands(stack_products(r, d, dff),
                                  GP.sm_count(dev), dev)
        rc = lib.jt_encoder_stack(
            P(x), *(P(w[k]) for k in STACK_KEYS), P(kmask), P(h), P(qkv),
            P(att), P(y), P(h1), P(out), P(ws), plans, r, d, dff, heads,
            seg, n_l, int(prenorm), _LN_KIND[ln_kind], _ACT[activation],
            _build.stream_ptr(dev))
    _build.check(lib, rc, "encoder stack kernel")
    _build.LAUNCHES[_COUNTER["stack", dt]] += 1
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

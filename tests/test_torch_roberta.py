"""The port's XLM-R and its stack kernel's twin against the JAX package on
the CPU: position ids, the encoder forward on a tiny HuggingFace config
(converted by R.params_from_hf, as tests/test_roberta.py builds it), the
stack kernel's twin on the list of layers and on stack_layers' operands,
and encoder_stack_plain against the JAX package's single-kernel stack
(`_stack_kernel`) in interpret mode.

Tolerance rtol = atol = 2e-5 (the JAX suite's own bar for path equalities,
tests/test_fused_engine.py:77) unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.core import transformer as JT
from jegal_tpu.models import roberta as JR
from jegal_tpu.ops.pallas import fused_layer as JF
from jegal_torch.convert import roberta_params_from_jax, tree_to_torch
from jegal_torch.models import roberta as TR
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import fused_layer as TF
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def tiny():
    """A tiny HF XLM-R -> (JAX params, port params, port config)."""
    from transformers import XLMRobertaConfig, XLMRobertaModel

    hf_cfg = XLMRobertaConfig(
        vocab_size=120, hidden_size=48, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=40, pad_token_id=1)
    torch.manual_seed(0)
    model = XLMRobertaModel(hf_cfg).eval()
    kw = dict(vocab_size=120, hidden_size=48, num_layers=3, num_heads=4,
              intermediate_size=96, max_position_embeddings=40)
    jp = JR.params_from_hf(model.state_dict(), JR.RobertaConfig(**kw))
    return jp, roberta_params_from_jax(jp), TR.RobertaConfig(**kw)


IDS = np.array([[0, 5, 9, 17, 33, 2, 1, 1],
                [0, 7, 99, 2, 1, 1, 1, 1]], dtype=np.int64)


def test_position_ids_equal_jax():
    want = np.asarray(JR.create_position_ids(jnp.asarray(IDS)))
    got = TR.create_position_ids(torch.from_numpy(IDS)).numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_matches_jax(tiny):
    """Padded batch, every row (pad rows too: both add finfo.min)."""
    jp, tp, cfg = tiny
    mask = (IDS != 1).astype(np.int64)
    want = np.asarray(JR.forward(jp, jnp.asarray(IDS), jnp.asarray(mask),
                                 JR.RobertaConfig(**vars(cfg)), fused=False))
    got = TR.forward(tp, torch.from_numpy(IDS), torch.from_numpy(mask),
                     cfg).numpy()
    assert got.shape == (2, 8, 48)
    np.testing.assert_allclose(got, want, **TOL)


def test_stacked_layout_matches_list(tiny):
    """The stack kernel's twin on stack_layers' fused_ops, and on the list
    of layers, gives the plain loop's rows on every valid position (-1e9
    fill of masked keys against HF's added finfo.min)."""
    _, tp, cfg = tiny
    mask = torch.from_numpy((IDS != 1).astype(np.int64))
    ids = torch.from_numpy(IDS)
    ops = TR.stack_layers(tp)["fused_ops"]
    assert set(ops) == set(TF.STACK_KEYS)
    assert ops["wqkv"].shape == (3, 48, 144) and ops["b1"].shape == (3, 96)
    assert all(t.is_contiguous() for t in ops.values())
    want = TR.forward(tp, ids, mask, cfg)
    x = TR.embeddings(tp["embeddings"], ids, cfg).reshape(16, 48)
    valid = mask.bool()
    for layers in (ops, [TR._fused_layout(l) for l in tp["layers"]]):
        rows = TF.fused_roberta_stack(layers, x, 8, cfg.num_heads,
                                      kmask=mask.reshape(-1))
        torch.testing.assert_close(rows.reshape(2, 8, 48)[valid],
                                   want[valid], **TOL)


def _stack_layers(seed: int, n: int, d: int, dff: int):
    """n JAX encoder layers with randomized LayerNorm parameters."""
    rng = np.random.default_rng(seed)
    layers = [JT.init_encoder_layer(jax.random.PRNGKey(seed + i), d, dff)
              for i in range(n)]
    for layer in layers:
        for name in ("norm1", "norm2"):
            layer[name] = {
                "scale": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32),
                "bias": jnp.asarray(0.1 * rng.standard_normal(d),
                                    jnp.float32)}
    return layers


@pytest.mark.parametrize("prenorm,ln_kind,activation", [
    (False, "std", "gelu"),     # XLM-R
    (True, "ref", "relu"),      # the JEGAL encoders
])
def test_stack_twin_matches_stack_kernel(rng, prenorm, ln_kind, activation):
    """encoder_stack_plain == JAX fused_encoder_stack(single_kernel=True,
    interpret=True), which runs `_stack_kernel`: L=2, d=128, 2 heads, two
    16-token sequences, the second with a 6-token pad tail."""
    b, s, d, heads = 2, 16, 128, 2
    layers = _stack_layers(40, 2, d, 256)
    x = rng.standard_normal((b * s, d)).astype(np.float32)
    kmask = np.ones((b, s), np.float32)
    kmask[1, 10:] = 0.0
    kmask = kmask.reshape(-1)
    want = np.asarray(JF.fused_encoder_stack(
        layers, jnp.asarray(x), s, heads, prenorm=prenorm, ln_kind=ln_kind,
        kmask=jnp.asarray(kmask), interpret=True, activation=activation,
        single_kernel=True))
    w = TF.stacked_weights(tree_to_torch(layers))
    got = TF.encoder_stack_plain(
        torch.from_numpy(x), w, s, heads, prenorm=prenorm, ln_kind=ln_kind,
        activation=activation, kmask=torch.from_numpy(kmask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_stack_takes_the_twin_and_counts_nothing(rng):
    """On a CPU tensor encoder_stack runs its twin and launches nothing;
    the per-sublayer stack with the same activation agrees with it."""
    layers = tree_to_torch(_stack_layers(50, 2, 128, 256))
    x = torch.from_numpy(rng.standard_normal((42, 128)).astype(np.float32))
    w = TF.stacked_weights(layers)
    _build.reset_launches()
    got = TF.encoder_stack(x, w, 21, 2, prenorm=False, ln_kind="std",
                           activation="gelu")
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}
    torch.testing.assert_close(
        got, TF.encoder_stack_plain(x, w, 21, 2, prenorm=False, ln_kind="std",
                                    activation="gelu"), rtol=0, atol=0)
    per_layer = TF.fused_encoder_stack(layers, x, 21, 2, prenorm=False,
                                       ln_kind="std", activation="gelu")
    torch.testing.assert_close(got, per_layer, **TOL)

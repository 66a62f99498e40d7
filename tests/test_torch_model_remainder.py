"""The model's last entry points in the port against the JAX package on the
CPU: JEGAL's forward_validation in its four (use_t, use_a) combos, the
torch log-mel (wav2filterbanks and its STFT pieces), the inverse STFT, the
audio token mask, and the transcript parser.

forward_validation runs at tests/test_torch_training.py's batch shapes
(B 4, T 8, S 16, W 4, mel 32; encoders cut to 2 layers, a 1-layer XLM-R of
a 128-token vocabulary) within rtol = atol = 2e-5. The log-mel is held at
the JAX suite's own bar for its two mel paths, rtol 2e-4 / atol 2e-3
(tests/test_audio.py:100): a log of float32 sums near 0 magnifies their
rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jegal_tpu.models import jegal as JJ
from jegal_tpu.models import roberta as JR
from jegal_tpu.ops import audio as JA
from jegal_tpu.text import normalize as JN
from jegal_torch.convert import init_jegal_params, init_roberta_params
from jegal_torch.core import transformer as TT
from jegal_torch.models import jegal as TJ
from jegal_torch.models import roberta as TR
from jegal_torch.ops import audio as TA
from jegal_torch.ops import pooling as P
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as FL
from jegal_torch.text import normalize as TN
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
MEL_TOL = dict(rtol=2e-4, atol=2e-3)


def _batch(rng, b=4, t=8, s=16, w=4, mel=32, vocab=128):
    """test_torch_training.py's batch: masked frames, an 11-token text,
    pooling matrices, ragged audio lengths."""
    ids = np.full((b, s), 1, np.int32)
    ids[:, 0], ids[:, 12] = 0, 2
    ids[:, 1:12] = rng.integers(4, vocab, (b, 11))
    tpool, _, _ = P.build_text_pooling([[1, 3, 6, 8]] * b, [w] * b, s, w)
    wbs = [["w", 2 * i, 2 * i + 1] for i in range(w)]
    apool, _, _ = P.build_audio_pooling([wbs] * b, mel // 4, w)
    vmask = np.ones((b, t), np.float32)
    vmask[1, t - 2:] = 0.0
    return {
        "visual_feats": rng.standard_normal((b, t, 1024)).astype(np.float32),
        "visual_mask": vmask,
        "input_ids": ids,
        "text_mask": (ids != 1).astype(np.float32),
        "text_pool": tpool,
        "audio_mel": rng.standard_normal((b, mel, 80)).astype(np.float32),
        "audio_pool": apool,
        "audio_valid": np.array([mel, mel - 4, mel, mel - 12], np.int32)[:b],
    }


@pytest.fixture(scope="module")
def setup():
    jp = init_jegal_params(torch.Generator().manual_seed(1))
    for enc in ("encoder_rgb", "encoder_text"):
        jp[enc]["layers"] = jp[enc]["layers"][:2]
    cfg = TR.RobertaConfig(vocab_size=128, num_layers=1,
                           max_position_embeddings=32)
    rp = init_roberta_params(torch.Generator().manual_seed(2), cfg)
    batch = _batch(np.random.default_rng(0))
    return dict(jp=jp, rp=rp, cfg=cfg, batch=batch,
                tbatch={k: torch.from_numpy(v) for k, v in batch.items()})


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("use_t,use_a", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_forward_validation_matches_jax(setup, use_t, use_a):
    """Without text and audio there is no content to zero-fill: both
    packages raise TypeError there."""
    def jax_run():
        return JJ.forward_validation(
            _numpy(setup["jp"]), _numpy(setup["rp"]), use_t=use_t,
            use_a=use_a, roberta_cfg=JR.RobertaConfig(**vars(setup["cfg"])),
            **{k: jnp.asarray(v) for k, v in setup["batch"].items()})

    if not (use_t or use_a):
        with pytest.raises(TypeError):
            jax_run()
        with pytest.raises(TypeError):
            TJ.forward_validation(setup["jp"], setup["rp"], use_t=False,
                                  use_a=False, **setup["tbatch"])
        return
    want_g, want_c = jax_run()
    with torch.no_grad():
        got_g, got_c = TJ.forward_validation(
            setup["jp"], setup["rp"], use_t=use_t, use_a=use_a,
            roberta_cfg=setup["cfg"], **setup["tbatch"])
    assert got_g.shape == (4, 8, 512) and got_c.shape == (4, 4, 512)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


@pytest.fixture
def routes(monkeypatch):
    """The card's routing on the CPU (as in tests/test_torch_flash.py):
    the device test says "on the card", and the fused stacks and the flash
    entry are counted; CPU tensors then run the kernels' twins."""
    calls = {"fused": [], "flash": 0}
    fused, flash = FL.fused_prenorm_stack, FA.flash_attention_diff

    def count_fused(stack, x, seg, *a, **kw):
        calls["fused"].append((seg, x.shape[1]))
        return fused(stack, x, seg, *a, **kw)

    def count_flash(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    monkeypatch.setattr(TT, "_on_card", lambda t: True)
    monkeypatch.setattr(FL, "fused_prenorm_stack", count_fused)
    monkeypatch.setattr(FA, "flash_attention_diff", count_flash)
    return calls


@pytest.mark.parametrize("fused", [True, False])
def test_forward_validation_routes_like_forward_inference(setup, routes,
                                                          fused):
    """fused=True: the gesture (T 8, d 512) and text (S 16, d 768)
    encoders take the fused sublayers, no flash; fused=False: the layer
    loop's flash attention in every layer. Both give the same rows."""
    with torch.no_grad():
        got = TJ.forward_validation(setup["jp"], setup["rp"],
                                    roberta_cfg=setup["cfg"], fused=fused,
                                    **setup["tbatch"])
    if fused:
        assert routes == {"fused": [(8, 512), (16, 768)], "flash": 0}
    else:
        assert routes == {"fused": [], "flash": 4}
    with torch.no_grad():
        want = TJ.forward_validation(setup["jp"], setup["rp"],
                                     roberta_cfg=setup["cfg"], fused=False,
                                     **setup["tbatch"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8000, 16320, 80000])
def test_wav2filterbanks_matches_jax(s):
    wav = (np.random.default_rng(s).standard_normal((2, s)) * 1000) \
        .astype(np.float32)
    got = TA.wav2filterbanks(torch.from_numpy(wav)).numpy()
    want = np.asarray(JA.wav2filterbanks(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, s // 160, 80)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MEL_TOL)
    np.testing.assert_allclose(got, TA.wav2filterbanks_np(wav), **MEL_TOL)
    # the magnitudes reach 4.4e4, where a float32 ulp is 0.004: the two
    # FFTs, summed in another order, differ by up to two ulps there
    frames = TA.frame_signal(torch.from_numpy(wav)).numpy()
    np.testing.assert_array_equal(
        frames, np.asarray(JA.frame_signal(jnp.asarray(wav))))
    np.testing.assert_allclose(
        TA.stft_magnitude(torch.from_numpy(wav)).numpy(),
        np.asarray(JA.stft_magnitude(jnp.asarray(wav))), rtol=2e-5,
        atol=1e-2)


def test_mag_phase_round_trip_matches_jax():
    """wav -> |STFT|, phase -> istft recovers the interior (the JAX
    suite's bar, tests/test_audio.py:78-88), and the inverse agrees with
    the JAX package's on the same magnitude and phase."""
    wav = (np.random.default_rng(4).standard_normal((1, 8000)) * 1000) \
        .astype(np.float32)
    mag, phase = TA.stft_mag_phase(torch.from_numpy(wav))
    jmag, jphase = JA.stft_mag_phase(jnp.asarray(wav))
    assert mag.shape == phase.shape == (1, 257, 50)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=2e-5,
                               atol=1e-2)
    rec = TA.reconstruct_wav(mag[0], phase[0])
    n = min(len(rec), 8000)
    assert np.abs(rec[400:n - 400] - wav[0, 400:n - 400]).max() < 2.0
    np.testing.assert_allclose(
        TA.reconstruct_wav(np.asarray(jmag[0]), np.asarray(jphase[0])),
        JA.reconstruct_wav(np.asarray(jmag[0]), np.asarray(jphase[0])),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mel_t", [0, 3, 4, 500, 2001])
def test_audio_token_mask_matches_jax(mel_t):
    got, want = TA.audio_token_mask(mel_t), JA.audio_token_mask(mel_t)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Transcripts
# ---------------------------------------------------------------------------

HEADER = "Text: x\nLang: en\n\nWORD, START, END, SCORE\n"


@pytest.mark.parametrize("rows", [
    "Hello, 0.031, 0.255, 0.9\nworld!, 0.3, 0.52, 0.8\n",
    "Hello, 0.031, 0.255, 0.9\n??, 0.3, 0.4, 0.5\nHat., 0.5, 0.8, 0.7\n",
    # the last row normalizes to "": the reference's trailing space stays
    "One, 0.0, 0.2, 0.9\ntwo, 0.24, 0.5, 0.9\n..., 0.6, 0.7, 0.1\n",
    "",
])
def test_load_text_matches_jax(tmp_path, rows):
    path = tmp_path / "t.txt"
    path.write_text(HEADER + rows)
    got = TN.load_text(str(path))
    assert got == JN.load_text(str(path))
    assert TN.validate_text_file(str(path)) is True


def test_load_text_keeps_the_trailing_space(tmp_path):
    path = tmp_path / "t.txt"
    path.write_text(HEADER + "One, 0.0, 0.2, 0.9\n..., 0.6, 0.7, 0.1\n")
    assert TN.load_text(str(path)) == ("one ", [["one", 0, 5]])


@pytest.mark.parametrize("text", [
    "Text: x\nLang: en\n",
    "Txt: x\nLang: en\n\nWORD, START, END, SCORE\n",
    "Text: x\nLanguage: en\n\nWORD, START, END, SCORE\n",
    "Text: x\nLang: en\nnot empty\nWORD, START, END, SCORE\n",
    "Text: x\nLang: en\n\nWORD,START,END,SCORE\n",
])
def test_malformed_transcripts_raise_the_jax_messages(tmp_path, text):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        JN.validate_text_file(str(path))
    with pytest.raises(ValueError) as got:
        TN.load_text(str(path))
    assert str(got.value) == str(want.value)

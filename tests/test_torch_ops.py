"""jegal_torch host and device ops against the JAX package on the CPU:
bucketing, frame masking, the numpy log-mel, audio pooling, and the audio
branch over a bucket-padded mel. Tolerance rtol = atol = 2e-5 unless a
test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.data import bucketing as JB
from jegal_tpu.models import jegal as JJ
from jegal_tpu.ops import audio as JA
from jegal_tpu.ops import pooling as JP
from jegal_tpu.ops import video as JV
from jegal_torch.convert import init_jegal_params, jegal_params_from_jax
from jegal_torch.data import bucketing as TB
from jegal_torch.models import jegal as TJ
from jegal_torch.ops import audio as TA
from jegal_torch.ops import pooling as TP
from jegal_torch.ops import video as TV
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def test_bucketing_matches():
    assert (TB.T_BUCKETS, TB.W_BUCKETS, TB.MEL_BUCKETS) == (
        JB.T_BUCKETS, JB.W_BUCKETS, JB.MEL_BUCKETS)
    for n in (1, 31, 32, 33, 500, 513, 1100):
        assert TB.next_bucket(n) == JB.next_bucket(n)
        assert TB.next_bucket(n, TB.W_BUCKETS) == JB.next_bucket(
            n, JB.W_BUCKETS)
    with pytest.raises(ValueError):
        TB.next_bucket(0)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(TB.pad_axis(a, 1, 5),
                                  JB.pad_axis(a, 1, 5))
    np.testing.assert_array_equal(
        TB.pad_axis(torch.from_numpy(a), 0, 4, value=7.0).numpy(),
        JB.pad_axis(a, 0, 4, value=7.0))
    with pytest.raises(ValueError):
        TB.pad_axis(a, 1, 2)


@pytest.mark.parametrize("with_chin", [True, False])
def test_mask_frames_device(rng, with_chin):
    """Chin rows clipped to [0, h] (one below 0, one past h), or the
    111-row fallback; +/-12 edge pad. Bit-equal."""
    u8 = rng.integers(0, 255, (5, 270, 480, 3)).astype(np.uint8)
    y2 = np.array([-3, 0, 140, 269, 400], np.int32) if with_chin else None
    want = np.asarray(JV.mask_frames_device(
        jnp.asarray(u8), None if y2 is None else jnp.asarray(y2)))
    got = TV.mask_frames_device(
        torch.from_numpy(u8),
        None if y2 is None else torch.from_numpy(y2)).numpy()
    assert got.shape == (5 + 24, 270, 480, 3)
    np.testing.assert_array_equal(got, want)


def test_wav2filterbanks_np(rng):
    """The numpy log-mel copy against the JAX package's numpy and jnp
    versions; odd lengths exercise the drop-last-frame contract."""
    np.testing.assert_array_equal(TA.mel_filterbank(), JA.mel_filterbank())
    np.testing.assert_array_equal(TA._padded_hann(), JA._padded_hann())
    for n in (640, 16000 + 77):
        wav = (rng.standard_normal(n) * 500).astype(np.float32)
        got = TA.wav2filterbanks_np(wav)
        assert got.shape == (1, n // 160, 80)
        np.testing.assert_array_equal(got, JA.wav2filterbanks_np(wav))
        # log-mel of a float32 FFT (numpy) vs XLA's: log-domain values
        # of order 10 agree to ~1e-4 absolute
        np.testing.assert_allclose(
            got, np.asarray(JA.wav2filterbanks(jnp.asarray(wav[None]))),
            rtol=1e-4, atol=1e-4)


def test_build_audio_pooling():
    cases = [
        [["a", 3, 5], ["b", 6, 6], ["c", 7, 30]],   # last span clamped
        [["a", 4, 6], ["b", 2, 3]],                 # non-monotonic: invalid
        [["a", 30, 40]],                            # empty after clamp
        [],                                         # no words
    ]
    for t_audio, w_max in ((12, 8), (40, 4)):
        got = TP.build_audio_pooling(cases, t_audio, w_max)
        want = JP.build_audio_pooling(cases, t_audio, w_max)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_pool_words(rng):
    p = rng.random((2, 4, 9)).astype(np.float32)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TP.pool_words(torch.from_numpy(p), torch.from_numpy(x)).numpy(),
        np.asarray(JP.pool_words(jnp.asarray(p), jnp.asarray(x))), **TOL)


def test_forward_audio_bucket_padded(rng):
    """The audio CNN over a bucket-padded mel with its valid length equals
    the JAX branch, and its valid tokens equal the natural-length run."""
    jax_params = jax.tree.map(lambda t: t.numpy(), init_jegal_params(
        torch.Generator().manual_seed(5)))
    params = jegal_params_from_jax(jax_params)
    t_mel = 103
    mel = rng.standard_normal((1, t_mel, 80)).astype(np.float32)
    padded = np.pad(mel, ((0, 0), (0, 128 - t_mel), (0, 0)))
    valid = np.array([t_mel])
    got = TJ.forward_audio(params, torch.from_numpy(padded),
                           torch.from_numpy(valid)).numpy()
    want = np.asarray(JJ.forward_audio(jax_params, jnp.asarray(padded),
                                       jnp.asarray(valid, jnp.int32)))
    assert got.shape == (1, 32, 256)
    np.testing.assert_allclose(got, want, **TOL)
    natural = TJ.forward_audio(params, torch.from_numpy(mel)).numpy()
    n_tok = (t_mel - 1) // 4 + 1
    np.testing.assert_allclose(got[:, :n_tok], natural, **TOL)

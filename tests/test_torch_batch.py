"""The port's engine on planar frames and in batches, on the CPU, against
the JAX engine: `extract` on planar frames (host-repacked by
jegal_torch.ops.video.s2d_repack) against the port on the raw frames and
the JAX engine on the raw frames; `extract_many` over mixed samples (raw
frames, planar frames, visual features only, a malformed sample) against
the port's single-sample `extract` and the JAX engine's `extract_many` on
the raw equivalents; the batch ladder; the pipeline's order, error notes
and pool; frames written by the staging pool against the JAX engine; the
tower's front doors. `extract_many`'s plan (each sample's prep less its
log-mel, the mel length taken from the wav's) against the chunks grouped
from fully prepared arrays; its log-mels, streamed on the prep pool in
dispatch order, against a run that prepares every sample first, bit for
bit.

One 8-frame clip at the real 270x480 geometry (T bucket 32) serves every
tower run, with a tiny XLM-R (1 layer, d 768, 8 heads) and the tiny BPE
tokenizer of tests/tok_util.py. The JAX engine's planar path is no oracle
off the TPU (it interprets the stem at full size); the repack is an exact
permutation plus mask, so the JAX raw path on the same frames and chin rows
serves instead.

Tolerance: rtol = atol = 2e-5 on unit-norm embeddings, the JAX suite's
path-equality bar (a conv tower and three transformer stacks summed in
another order by oneDNN and XLA:CPU)."""

import threading

import numpy as np
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_tpu.models import roberta as JR
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.data.bucketing import (
    MEL_BUCKETS,
    T_BUCKETS,
    batch_ladder,
    next_bucket,
    pad_axis,
)
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops.audio import mel_frames, wav2filterbanks_np
from jegal_torch.parallel import mesh as M
from jegal_torch.ops.video import s2d_repack
from jegal_torch.text.tokenizer import WordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
T = 8
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
VF_LENGTHS = (20, 40, 50, 60)        # T buckets 32, 64, 64, 64


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees: JEGAL, GestSync (randomized BatchNorm
    statistics and LayerNorm parameters) and the tiny XLM-R."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(51))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(52))),
            _as_numpy(init_roberta_params(torch.Generator().manual_seed(53),
                                          RobertaConfig(**TINY_XLMR))))


@pytest.fixture(scope="module")
def content():
    rng = np.random.default_rng(54)
    return dict(wav=(rng.standard_normal(T * 640) * 1000).astype(np.float32),
                word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 5, 7]],
                text="hello world abc")


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(55)
    frames = rng.integers(0, 256, (T, 270, 480, 3), dtype=np.uint8)
    chin = rng.integers(90, 200, T).astype(np.int32)
    return frames, chin, s2d_repack(frames, chin)


@pytest.fixture(scope="module")
def jax_engine(weights):
    jp, gp, rp = weights
    return JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))


def _port_engine(weights, **kw):
    jp, gp, rp = weights
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu",
                            roberta_params=roberta_params_from_jax(rp),
                            roberta_cfg=RobertaConfig(**TINY_XLMR),
                            tokenizer=WordTokenizer(make_tiny_tokenizer()),
                            **kw)


@pytest.fixture(scope="module")
def port_engine(weights):
    engine = _port_engine(weights)
    yield engine
    engine.close()


@pytest.fixture(scope="module")
def single(port_engine, clip, content):
    """The port's single-clip `vta` on the raw and the planar frames."""
    frames, chin, planar = clip
    return {"raw": port_engine.extract("vta", frames=frames, chin_rows=chin,
                                       fname="clip", **content),
            "planar": port_engine.extract("vta", frames=planar, fname="clip",
                                          **content)}


@pytest.fixture(scope="module")
def jax_single(jax_engine, clip, content):
    frames, chin, _ = clip
    return jax_engine.extract("vta", frames=frames, chin_rows=chin,
                              fname="clip", **content)


def _same(got, want):
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None
            continue
        assert got[key].shape == want[key].shape
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **TOL)
    assert got["info"] == want["info"]


@pytest.mark.parametrize("kind", ["raw", "planar"])
def test_planar_extract_matches_raw_and_jax(single, jax_single, kind):
    assert single[kind]["gesture_emb"].shape == (T, 512)
    assert single[kind]["content_emb"].shape == (3, 512)
    _same(single[kind], jax_single)
    _same(single["planar"], single["raw"])


@pytest.mark.parametrize("frames,chin,match", [
    ("planar", "chin", "already masked"),
    (np.zeros((4, 90, 27, 161), np.uint8), None, "frames must be"),
    (np.zeros((4, 90, 27, 160), np.float32), None, "uint8"),
    (np.zeros((0, 90, 27, 160), np.uint8), None, "frames must be"),
])
def test_planar_client_errors(port_engine, clip, content, frames, chin,
                              match):
    if isinstance(frames, str):
        frames, chin = clip[2], clip[1]
    with pytest.raises(TAPI.ClientError, match=match):
        port_engine.extract("vta", frames=frames, chin_rows=chin, **content)


@pytest.fixture(scope="module")
def samples(clip, content):
    """Mixed samples, in an order that interleaves their groups: visual
    features of T = 20 (bucket 32) and T = 40, 50, 60 (bucket 64: a chunk
    of 2 and a straggler of 1 at batch_size 2), the clip's raw and planar
    frames, and a malformed planar sample. -> (the port's samples, the JAX
    engine's, with the planar sample as its raw frames)."""
    frames, chin, planar = clip
    rng = np.random.default_rng(56)
    vf = {n: dict(content, visual_feats=rng.standard_normal(
        (n, 1024)).astype(np.float32), fname=f"vf{n}") for n in VF_LENGTHS}
    raw = dict(content, frames=frames, chin_rows=chin, fname="raw")
    port = [vf[20], raw, vf[40], dict(content, fname="bad",
                                      frames=np.zeros((4, 90, 27, 161),
                                                      np.uint8)),
            dict(content, frames=planar, fname="planar"), vf[50], vf[60]]
    jax_side = list(port)
    jax_side[4] = dict(raw, fname="planar")
    return port, jax_side


@pytest.fixture(scope="module")
def many(port_engine, jax_engine, samples):
    port, jax_side = samples
    return (port_engine.extract_many(port, "vta", batch_size=2),
            jax_engine.extract_many(jax_side, "vta", batch_size=2))


@pytest.mark.parametrize("i", range(7))
def test_extract_many_matches_single_and_jax(port_engine, single, samples,
                                             many, i):
    s = samples[0][i]
    got, jax_got = many[0][i], many[1][i]
    assert got is not None or s["fname"] == "bad"
    if got is None:
        assert jax_got is None
        return
    assert got["info"]["fname"] == s["fname"]
    if s["fname"] in ("raw", "planar"):
        want = dict(single[s["fname"]],
                    info=dict(single[s["fname"]]["info"], fname=s["fname"]))
    else:
        want = port_engine.extract("vta", **s)
    _same(got, want)
    _same(got, jax_got)


def test_extract_many_straggler_padding_is_neutral(port_engine, samples):
    """Three samples at batch_size 4 run as one chunk padded to the ladder's
    4 (one zero row); padding rows are neutral, so the rows match
    unpadded chunks of one."""
    vf = [s for s in samples[0] if s["fname"] in ("vf40", "vf50", "vf60")]
    a = port_engine.extract_many(vf, "vta", batch_size=4)
    b = port_engine.extract_many(vf, "vta", batch_size=1)
    for x, y in zip(a, b):
        _same(x, y)


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_batch_ladder_matches_jax(cap):
    for n in range(1, 41):
        assert batch_ladder(n, cap) == JAPI._batch_ladder(n, cap)


def test_pipeline_dispatches_ahead_of_settle():
    """Chunk k+1 is dispatched before chunk k is settled; the last chunk
    is settled too."""
    log = []

    def dispatches():
        for k in range(3):
            log.append(f"d{k}")
            yield [k], k

    TAPI.JegalEngine._pipeline(dispatches(),
                               lambda chunk, k: log.append(f"s{k}"))
    assert log == ["d0", "d1", "s0", "d2", "s1", "s2"]


def test_settle_error_names_its_chunk(port_engine, samples, monkeypatch):
    def fail(fetch):
        raise RuntimeError("fetch failed")

    monkeypatch.setattr(port_engine, "_finish_fetch", fail)
    vf = [s for s in samples[0] if s["fname"] in ("vf40", "vf50")]
    with pytest.raises(RuntimeError, match="fetch failed") as info:
        port_engine.extract_many(vf, "vta", batch_size=2)
    assert any("['vf40', 'vf50']" in n for n in info.value.__notes__)


def test_close_shuts_the_prep_pool(weights, samples):
    """More than 4 samples share one prep pool; close() shuts it, and a
    later call starts a new one."""
    engine = _port_engine(weights)
    vf = [s for s in samples[0] if "visual_feats" in s] * 2
    engine.extract_many(vf, "v")
    pool = engine._prep_pool
    assert pool is not None
    engine.close()
    assert engine._prep_pool is None and pool._shutdown
    assert all(r is not None for r in engine.extract_many(vf, "v"))
    engine.close()


def test_tower_front_doors_agree(port_engine, clip):
    """gestsync_features on raw frames with chin rows, on planar frames,
    and the batched gestsync_features_from_raw_many on both, give one
    clip's (T, 1024) features."""
    frames, chin, planar = clip
    want = port_engine.gestsync_features(frames, chin)
    assert want.shape == (T, 1024)
    np.testing.assert_allclose(port_engine.gestsync_features(planar), want,
                               **TOL)
    for batch in ([(frames, chin)], [(planar, None)]):
        got, = port_engine.gestsync_features_from_raw_many(batch)
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(TAPI.ClientError, match="already masked"):
        port_engine.gestsync_features(planar, chin)
    with pytest.raises(TAPI.ClientError, match="all raw or all planar"):
        port_engine.gestsync_features_from_raw_many([(frames, chin),
                                                     (planar, None)])


def test_frames_staged_on_the_pool_match_jax(port_engine, jax_engine, clip,
                                             content, monkeypatch):
    """extract_many's fused path and the batched tower write their host
    frames through the staging pool, in several runs on `jegal-stage`
    threads, and give the JAX engine's answers on the same raw frames."""
    names = []
    fill = TAPI._fill_slots

    def spy(fr, clips, lo, hi):
        names.append(threading.current_thread().name)
        fill(fr, clips, lo, hi)

    monkeypatch.setattr(TAPI, "_fill_slots", spy)
    frames, chin, _ = clip
    sample = [dict(content, frames=frames, chin_rows=chin, fname="raw")]
    got, = port_engine.extract_many(sample, "vta", batch_size=2)
    want, = jax_engine.extract_many(sample, "vta", batch_size=2)
    _same(got, want)
    runs = len(names)
    assert runs > 1
    clips = [(frames, chin), (frames[:5], chin[:5])]
    got = port_engine.gestsync_features_from_raw_many(clips, batch_size=2)
    want = jax_engine.gestsync_features_from_raw_many(clips, batch_size=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert len(names) > runs + 1
    assert all(n.startswith("jegal-stage") for n in names)


def test_engine_passes_its_tower_settings(weights, clip):
    """JegalEngine(stem_impl="window", conv2_impl="dense"), the settings
    other than the defaults, runs every tower call with them (on the CPU,
    their twins: the same features to 2e-5); unknown settings raise."""
    planar = clip[2][:2]
    want = _port_engine(weights).gestsync_features(planar)
    got = _port_engine(weights, stem_impl="window",
                       conv2_impl="dense").gestsync_features(planar)
    np.testing.assert_allclose(got, want, **TOL)
    for kw in (dict(stem_impl="rotate"), dict(conv2_impl="mgrid")):
        with pytest.raises(ValueError, match="impl"):
            _port_engine(weights, **kw)


@pytest.mark.parametrize("n", [640, 641, 799, 800, 48000 + 159, 160000])
def test_planned_mel_is_the_log_mels(port_engine, n):
    """The mel length the plan takes from a wav's length is the log-mel's,
    and the log-mel written into the planned array is the log-mel padded
    to its bucket, bit for bit."""
    wav = (np.random.default_rng(n).standard_normal(n) * 1000
           ).astype(np.float32)
    mel = wav2filterbanks_np(wav)
    assert mel_frames(n) == mel.shape[1]
    arrays, n_words = port_engine.prepare_audio(wav, [["a", 0, 0]])
    assert n_words == 1
    np.testing.assert_array_equal(
        arrays["audio_mel"],
        pad_axis(mel, 1, next_bucket(mel.shape[1], MEL_BUCKETS)))
    assert arrays["audio_valid"].tolist() == [mel.shape[1]]


class _Planned(Exception):
    pass


def _words(n: int) -> tuple:
    """n words of a clip's text and their boundaries, spread over its
    frames as the benchmark's traffic spreads them."""
    words = ["w" + "abcdefgh"[k % 8] * (1 + k % 4) for k in range(n)]
    return " ".join(words), [[w, 3 * k, 3 * k + 2]
                             for k, w in enumerate(words)]


@pytest.fixture(scope="module")
def plan_samples():
    """`vta` samples of 3-10 s over T buckets 128 and 256 (planar frames as
    views of one zero frame; wavs of a few samples past whole hops) and
    feature samples, with word counts of three W buckets, and a sample
    each: text and audio counting other words, text the tokenizer cannot
    pool, audio pooling past the wav's last token (and one ending on it),
    a wav too short, frames of the wrong shape."""
    rng = np.random.default_rng(57)
    frame = np.zeros((1, 90, 27, 160), np.uint8)

    def clip(t, n_words, fname, **kw):
        text, wbs = _words(n_words)
        out = dict(frames=np.broadcast_to(frame, (t,) + frame.shape[1:]),
                   text=text, word_boundaries=wbs, fname=fname,
                   wav=(rng.standard_normal(t * 640 + 37) * 1000)
                   .astype(np.float32))
        out.update(kw)
        return out

    edge = _words(2)[0]
    short = [clip(75, 8, "c75"), clip(250, 25, "c250"), clip(100, 10, "c100"),
             clip(150, 16, "c150"), clip(200, 20, "c200"), clip(90, 9, "c90")]
    odd = [clip(100, 10, "words_differ", word_boundaries=_words(9)[1]),
           clip(100, 10, "text_unpooled", text=_words(10)[0] + "  x"),
           # 48159 samples: 300 mel frames, 75 audio tokens
           clip(75, 2, "audio_past", text=edge, wav=short[0]["wav"][:48159],
                word_boundaries=[["a", 0, 9], ["b", 75, 80]]),
           clip(75, 2, "audio_edge", text=edge, wav=short[0]["wav"][:48159],
                word_boundaries=[["a", 0, 9], ["b", 74, 80]]),
           clip(75, 8, "wav_short", wav=short[0]["wav"][:600]),
           clip(75, 8, "bad_frames", frames=np.zeros((4, 90, 27, 161),
                                                     np.uint8))]
    feats = [dict(clip(t, n, f"vf{t}"), frames=None,
                  visual_feats=rng.standard_normal((t, 1024))
                  .astype(np.float32)) for t, n in ((120, 12), (80, 8))]
    return short[:3] + odd[:3] + feats[:1] + short[3:] + odd[3:] + feats[1:]


def _prepared_plan(engine, samples, batch_size, ladder):
    """extract_many's check object as the chunks grouped from fully
    prepared arrays: every sample's log-mel made first, its length read
    from the log-mel."""
    fgroups, groups = {}, {}
    for i, s in enumerate(samples):
        try:
            if s.get("frames") is not None:
                kind = engine._frames_kind(np.asarray(s["frames"]))
                prep = engine._prepare_sample(
                    "ta", None, s["text"], s["word_boundaries"], s["wav"])
            else:
                prep = engine._prepare_sample(
                    "vta", s["visual_feats"], s["text"],
                    s["word_boundaries"], s["wav"])
        except TAPI.ClientError:
            continue
        if prep is None:
            continue
        assert prep[0]["audio_valid"][0] == \
            wav2filterbanks_np(s["wav"]).shape[1]
        if s.get("frames") is not None:
            fgroups.setdefault(
                (kind, next_bucket(len(s["frames"]), T_BUCKETS),
                 engine._shape_sig(prep[0])), []).append(i)
        else:
            groups.setdefault(engine._shape_sig(prep[0]), []).append(i)
    return ("vta", batch_size, ladder, list(fgroups.items()),
            list(groups.items()))


@pytest.mark.parametrize("ladder", [True, False])
def test_plan_groups_as_prepared_arrays(port_engine, plan_samples, ladder,
                                        monkeypatch):
    """The chunk plan that extract_many checks and dispatches, built before
    any log-mel, equals the one grouped from fully prepared arrays: the
    same samples in the same groups in the same order, the invalid and
    malformed ones left out."""
    planned = []

    def stop(obj, mesh, what):
        planned.append(obj)
        raise _Planned

    monkeypatch.setattr(M, "check_same", stop)
    log_mels = []
    log_mel = TAPI.wav2filterbanks_np
    monkeypatch.setattr(TAPI, "wav2filterbanks_np",
                        lambda *a: log_mels.append(1) or log_mel(*a))
    with pytest.raises(_Planned):
        port_engine.extract_many(plan_samples, "vta", batch_size=2,
                                 ladder=ladder)
    assert not log_mels
    want = _prepared_plan(port_engine, plan_samples, 2, ladder)
    assert planned == [want]
    kept = {plan_samples[i]["fname"] for g in want[3:] for _, idxs in g
            for i in idxs}
    assert kept == {s["fname"] for s in plan_samples if s["fname"][0] in "cv"
                    or s["fname"] == "audio_edge"}
    assert {key[1] for key, _ in want[3]} == {128, 256}
    assert len(want[4]) == 2


@pytest.fixture(scope="module")
def stream_samples(clip, samples):
    """Two planar clips and six feature samples (two more wav lengths than
    the fixture's), an audio sample invalid through its pooling and a
    malformed one, each wav tagged with its index in its first sample."""
    planar = clip[2]
    vf = [s for s in samples[0] if "visual_feats" in s]
    wav = vf[0]["wav"]
    rng = np.random.default_rng(58)
    more = [dict(vf[0], fname=f"vf30_{k}", wav=np.concatenate(
        [wav, wav[:800 * (k + 1)]]), visual_feats=rng.standard_normal(
            (30, 1024)).astype(np.float32)) for k in range(2)]
    out = [dict(vf[0], frames=planar, visual_feats=None, fname="p0"),
           *vf[:2], dict(vf[0], frames=planar[:6], visual_feats=None,
                         fname="p1"), *more, *vf[2:],
           dict(vf[1], fname="audio_past",
                word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 9, 9]]),
           dict(vf[1], fname="wav_short", wav=wav[:600])]
    for i, s in enumerate(out):
        s["wav"] = s["wav"].copy()
        s["wav"][0] = i
    return out


def _eager_log_mels(monkeypatch):
    """Every sample's log-mel made in its plan: extract_many then prepares
    every sample before its first chunk, as a run without the stream."""
    plan = TAPI.JegalEngine._plan_sample

    def eager(self, *a, **kw):
        out = plan(self, *a, **kw)
        if out is not None and out[3] is not None:
            out[3]()
            out = out[:3] + (None,)
        return out

    monkeypatch.setattr(TAPI.JegalEngine, "_plan_sample", eager)


@pytest.mark.parametrize("combo", ["vta", "vt", "va", "ta", "t", "a"])
def test_streamed_log_mels_equal_prepared_first(port_engine, stream_samples,
                                                combo, monkeypatch):
    """extract_many with the log-mels streamed on the prep pool (the fused
    path's planar clips, then the two-stage path's feature samples; for
    combos without v, the feature samples alone) returns a run that
    prepares every sample first, element for element."""
    batch = [s for s in stream_samples
             if "v" in combo or s.get("frames") is None]
    got = port_engine.extract_many(batch, combo, batch_size=2)
    _eager_log_mels(monkeypatch)
    want = port_engine.extract_many(batch, combo, batch_size=2)
    assert [g is None for g in got] == [
        "a" in combo and s["fname"] in ("wav_short", "audio_past")
        for s in batch]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for key in ("gesture_emb", "content_emb"):
            assert (g[key] is None) == (w[key] is None)
            if w[key] is not None:
                np.testing.assert_array_equal(g[key], w[key])
        assert g["info"] == w["info"]


def test_refused_log_mel_drops_only_its_sample(port_engine, stream_samples,
                                               monkeypatch):
    """A log-mel that raises a ClientError makes its sample's result None;
    its chunk runs without it and every other result stands."""
    batch = [s for s in stream_samples if s.get("frames") is None]
    want = port_engine.extract_many(batch, "ta", batch_size=2)
    log_mel = TAPI.wav2filterbanks_np

    def refuse(wav, *a):
        if int(wav[0]) == 5:
            raise TAPI.ClientError("refused")
        return log_mel(wav, *a)

    monkeypatch.setattr(TAPI, "wav2filterbanks_np", refuse)
    got = port_engine.extract_many(batch, "ta", batch_size=2)
    refused = [i for i, s in enumerate(batch) if int(s["wav"][0]) == 5]
    assert len(refused) == 1 and want[refused[0]] is not None
    for i, (g, w) in enumerate(zip(got, want)):
        if i in refused or w is None:
            assert g is None
        else:
            _same(g, w)

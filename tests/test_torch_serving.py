"""The port's HTTP server (jegal_torch/serving.py) against the JAX
package's (jegal_tpu/serving.py) on the CPU, both over engines with the
same weights: a full-width JEGAL and GestSync drawn from seeds, a one-layer
XLM-R (d 768, 8 heads) and the tiny BPE tokenizer of tests/tok_util.py.

- The same `ta`, `v` (visual_feats) and raw-frames `v` requests answer
  within rtol = atol = 2e-5 of the JAX server's, unbatched and through
  the batcher (batch_window_ms > 0, two concurrent requests a batch):
  tests/test_torch_api.py's bar on the same kind of weights.
- The binary wire: `encode_binary` gives the same bytes in both packages,
  and each package decodes the other's frames; a binary request answers
  as its JSON twin does.
- Every status code of tests/test_serving_http.py (but its data-parallel
  case, which waits for the multi-GPU port) from both servers on the same
  requests: 200, 400, 404, 413, 422 (unbatched and batched), binary bad
  framing; then the port's batcher alone, on fake engines: worker death,
  503, no ladder, a poison batch; a frames request through the fused
  graph; a mixed-combo load with poison requests; serve makes the JAX
  serve's warmup calls, and they leave a live batch at the default
  buckets nothing to capture; a repack library that
  fails to build raises when the server is created.
- `python -m jegal_torch serve --port 0 --device cpu` in a subprocess
  prints the JAX CLI's first line with the bound port and answers.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from jegal_torch import api as TAPI
from jegal_torch import serving as TS
from jegal_torch.convert import (
    checkpoints as TCK,
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.text.tokenizer import WordTokenizer
from jegal_tpu import api as JAPI
from jegal_tpu import serving as JS
from jegal_tpu.models import roberta as JR
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
WBS = [["hello", 2, 7], ["world", 8, 12], ["abc", 13, 18]]
MAX_BATCH = 2


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees: JEGAL, GestSync, the tiny XLM-R."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(41))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(42))),
            _as_numpy(init_roberta_params(torch.Generator().manual_seed(43),
                                          RobertaConfig(**TINY_XLMR))))


@pytest.fixture(scope="module")
def port_engine(weights):
    jp, gp, rp = weights
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu",
                            roberta_params=roberta_params_from_jax(rp),
                            roberta_cfg=RobertaConfig(**TINY_XLMR),
                            tokenizer=WordTokenizer(make_tiny_tokenizer()))


@pytest.fixture(scope="module")
def jax_engine(weights):
    jp, gp, rp = weights
    return JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))


@contextlib.contextmanager
def running(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def urls(port_engine, jax_engine):
    """{(package, batched): url}: an unbatched and a batched server of each
    package, each package's two over one engine."""
    with contextlib.ExitStack() as stack:
        out = {}
        for pkg, mod, eng in (("port", TS, port_engine),
                              ("jax", JS, jax_engine)):
            for batched in (False, True):
                kw = dict(batch_window_ms=200, max_batch=MAX_BATCH) \
                    if batched else {}
                out[pkg, batched] = stack.enter_context(running(
                    mod.create_server(eng, host="127.0.0.1", port=0, **kw)))
        yield out


def post_json(url, payload, path="/extract", headers=None):
    """-> (status, body dict), HTTP errors included."""
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_raw(url, body: bytes, content_type, accept=None):
    """-> (status, decoded body: (meta, arrays) for a binary answer, else
    the JSON dict)."""
    headers = {"Content-Type": content_type}
    if accept:
        headers["Accept"] = accept
    req = urllib.request.Request(url + "/extract", data=body,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req) as resp:
            data = resp.read()
            if resp.headers.get("Content-Type") == TS.BINARY_CONTENT_TYPE:
                return resp.status, TS.decode_binary(data)
            return resp.status, json.loads(data)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url, path="/healthz"):
    try:
        with urllib.request.urlopen(url + path) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# requests: (meta, arrays) of each kind, two samples each
# ---------------------------------------------------------------------------

def request(kind: str, i: int):
    rng = np.random.default_rng(100 + i)
    if kind == "ta":
        return ({"modalities": "ta", "text": "hello world abc",
                 "word_boundaries": WBS, "fname": f"ta{i}"},
                {"wav": (rng.standard_normal(16000 + 800 * i) * 500
                         ).astype(np.float32)})
    if kind == "v_feats":
        return ({"modalities": "v", "fname": f"vf{i}"},
                {"visual_feats": rng.standard_normal(
                    (17 + 2 * i, 1024)).astype(np.float32)})
    assert kind == "v_frames"
    return ({"modalities": "v", "fname": f"fr{i}"},
            {"frames": rng.integers(0, 256, (5 + i, 270, 480, 3),
                                    dtype=np.uint8)})


def send(url, meta, arrays, binary: bool):
    """One request, JSON (arrays as base64 .npy) or binary both ways ->
    (status, {"gesture_emb", "content_emb", "info"} | error body)."""
    if binary:
        status, body = post_raw(url, TS.encode_binary(meta, arrays),
                                TS.BINARY_CONTENT_TYPE,
                                accept=TS.BINARY_CONTENT_TYPE)
        if status != 200:
            return status, body
        rmeta, rarr = body
        return status, {"gesture_emb": rarr.get("gesture_emb"),
                        "content_emb": rarr.get("content_emb"),
                        "info": rmeta["info"]}
    status, body = post_json(url, {**meta, **{k: TS.encode_array(v)
                                              for k, v in arrays.items()}})
    if status != 200:
        return status, body
    return status, {k: TS.decode_array(body[k])
                    for k in ("gesture_emb", "content_emb")} | {
                        "info": body["info"]}


def assert_same(got, want):
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], **TOL)
    assert got["info"] == want["info"]


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batched"])
@pytest.mark.parametrize("kind", ["ta", "v_feats", "v_frames"])
def test_port_server_matches_jax_server(urls, kind, batched):
    """The same requests to both packages' servers: the port's answers
    within 2e-5 of the JAX server's. Batched: two concurrent requests, one
    batcher window; raw frames go binary (repacked on the request thread by
    each package's C++ repack), the rest JSON."""
    binary = kind == "v_frames"
    reqs = [request(kind, i) for i in range(2 if batched else 1)]
    answers = {}
    for pkg in ("port", "jax"):
        url = urls[pkg, batched]
        with ThreadPoolExecutor(len(reqs)) as ex:
            answers[pkg] = list(ex.map(lambda r: send(url, *r, binary),
                                       reqs))
    for (sp, port), (sj, ref) in zip(answers["port"], answers["jax"]):
        assert sp == sj == 200, (port, ref)
        assert_same(port, ref)


def test_batched_answers_equal_unbatched(urls):
    """Cross-request batching is neutral in the port: two concurrent `ta`
    requests through the batcher answer as one at a time does."""
    reqs = [request("ta", i) for i in range(2)]
    with ThreadPoolExecutor(2) as ex:
        batched = list(ex.map(lambda r: send(urls["port", True], *r, False),
                              reqs))
    for r, (status, got) in zip(reqs, batched):
        ref_status, ref = send(urls["port", False], *r, False)
        assert status == ref_status == 200
        assert_same(got, ref)


# ---------------------------------------------------------------------------
# the binary wire across the packages
# ---------------------------------------------------------------------------

def test_encode_binary_same_bytes_across_packages():
    meta, arrays = request("v_frames", 0)
    arrays = dict(arrays, wav=np.arange(640, dtype=np.float32))
    meta = dict(meta, text="hello world", word_boundaries=WBS)
    port, ref = TS.encode_binary(meta, arrays), JS.encode_binary(meta, arrays)
    assert port == ref
    assert TS.BINARY_MAGIC == JS.BINARY_MAGIC
    assert TS.BINARY_CONTENT_TYPE == JS.BINARY_CONTENT_TYPE
    for decode in (TS.decode_binary, JS.decode_binary):
        got_meta, got = decode(port)
        assert got_meta == meta and sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
    assert TS.encode_binary({"info": {}}, {"x": None}) == \
        JS.encode_binary({"info": {}}, {"x": None})
    a = np.random.default_rng(3).standard_normal((4, 512)).astype(np.float32)
    assert TS.encode_array(a) == JS.encode_array(a)
    np.testing.assert_array_equal(TS.decode_array(JS.encode_array(a)), a)
    assert TS.decode_array(None) is None and TS.encode_array(None) is None


def test_binary_request_answers_as_json(urls):
    """octet-stream framing (and the binary answer with Accept) gives the
    JSON protocol's embeddings; without Accept the answer is JSON; the
    body is near the raw array size."""
    url = urls["port", False]
    meta, arrays = request("ta", 0)
    sb, got = send(url, meta, arrays, binary=True)
    sj, ref = send(url, meta, arrays, binary=False)
    assert sb == sj == 200
    assert got["gesture_emb"] is None and got["content_emb"].shape == (3, 512)
    np.testing.assert_array_equal(got["content_emb"], ref["content_emb"])
    status, body = post_raw(url, TS.encode_binary(meta, arrays),
                            TS.BINARY_CONTENT_TYPE)
    assert status == 200 and isinstance(body["content_emb"], str)
    assert len(TS.encode_binary(meta, arrays)) < arrays["wav"].nbytes + 4096


# ---------------------------------------------------------------------------
# status codes, both servers on the same requests
# ---------------------------------------------------------------------------

def _b64(a):
    return TS.encode_array(a)


STATUS_CASES = {
    "healthz": (200, ("GET", "/healthz", None)),
    "get_unknown_path": (404, ("GET", "/nope", None)),
    "post_unknown_path": (404, ("POST", "/nope", {"modalities": "t"})),
    "v_without_visual": (400, ("POST", "/extract", {"modalities": "v"})),
    "visual_feats_rank": (400, ("POST", "/extract", {
        "modalities": "v",
        "visual_feats": _b64(np.zeros((4, 4, 4, 4), np.float32))})),
    "visual_feats_width": (400, ("POST", "/extract", {
        "modalities": "v",
        "visual_feats": _b64(np.zeros((4, 7), np.float32))})),
    "blank_text": (400, ("POST", "/extract", {"modalities": "t",
                                              "text": "   "})),
    "short_wav": (400, ("POST", "/extract", {
        "modalities": "a", "wav": _b64(np.zeros((8,), np.float32)),
        "word_boundaries": [["w", 0, 1]]})),
    "start_after_end": (400, ("POST", "/extract", {
        "modalities": "a", "wav": _b64(np.zeros((16000,), np.float32)),
        "word_boundaries": [["w", 9, 2]]})),
    "no_boundaries": (400, ("POST", "/extract", {
        "modalities": "a", "wav": _b64(np.zeros((16000,), np.float32)),
        "word_boundaries": []})),
    "frames_shape": (400, ("POST", "/extract", {
        "modalities": "v", "frames": _b64(np.zeros((2, 10, 9, 3),
                                                   np.uint8))})),
    "ta_without_boundaries": (400, ("POST", "/extract", {
        "modalities": "ta", "text": "hello world abc",
        "wav": _b64(np.zeros((16000,), np.float32))})),
    "bad_json": (400, ("RAW", "application/json", b"{nope")),
    "json_not_object": (400, ("RAW", "application/json", b"[1, 2]")),
    "binary_bad_magic": (400, ("RAW", TS.BINARY_CONTENT_TYPE, b"nope")),
    "binary_header_too_long": (400, (
        "RAW", TS.BINARY_CONTENT_TYPE,
        b"JGL1" + (10 ** 6).to_bytes(4, "big") + b"x")),
    "binary_header_not_object": (400, (
        "RAW", TS.BINARY_CONTENT_TYPE,
        b"JGL1" + (2).to_bytes(4, "big") + b"[]")),
    "word_count_mismatch": (422, ("POST", "/extract", {
        "modalities": "ta", "text": "one two",
        "word_boundaries": [["one", 1, 5]],
        "wav": _b64((np.random.default_rng(2).standard_normal(16000)
                     * 500).astype(np.float32))})),
    "oversized_body": (413, ("BIG", None, None)),
}


def _status(url, how):
    method, a, b = how
    if method == "GET":
        return get(url, a)
    if method == "POST":
        return post_json(url, b, path=a)
    if method == "RAW":
        return post_raw(url, b, a)
    req = urllib.request.Request(
        url + "/extract", data=json.dumps({"modalities": "t",
                                           "text": "x"}).encode(),
        headers={"Content-Type": "application/json",
                 "Content-Length": str(10 ** 12)})
    try:
        urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batched"])
@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_status_matches_jax(urls, case, batched):
    """Both servers answer each request with the same status code, the one
    tests/test_serving_http.py expects; the batched servers classify a
    batch's None results (400 or 422) as the unbatched ones do."""
    want, how = STATUS_CASES[case]
    got = {pkg: _status(urls[pkg, batched], how) for pkg in ("port", "jax")}
    assert got["port"][0] == got["jax"][0] == want, got
    body = got["port"][1]
    if want == 200:
        assert body["ok"] is True and body["graphs"] >= 0
        assert ("queue_depth" in body) == batched
        assert set(body) == set(got["jax"][1])
    else:
        assert isinstance(body["error"], str) and body["error"]
    if want == 413:
        assert "limit" in body["error"]
    if want == 422:
        assert "rejected" in body["error"]


def test_bad_batchmate_fails_alone(urls):
    """Per-request isolation in a batch: a malformed batchmate (ta without
    word_boundaries) answers 400, its valid batchmate 200."""
    meta, arrays = request("ta", 0)
    bad = {k: v for k, v in meta.items() if k != "word_boundaries"}
    url = urls["port", True]
    with ThreadPoolExecutor(2) as ex:
        ok = ex.submit(send, url, meta, arrays, False)
        err = ex.submit(send, url, bad, arrays, False)
        (s_ok, b_ok), (s_bad, b_bad) = ok.result(), err.result()
    assert s_ok == 200 and b_ok["content_emb"] is not None
    assert s_bad == 400 and "word_boundaries" in b_bad["error"]


def test_frames_request_runs_fused_graph(urls, port_engine):
    """A frames request answers through the fused frames -> embeddings
    graph (engine.extract(frames=...)), the raw frames repacked to planar
    on the request thread, and equals the engine called directly on the
    raw frames."""
    meta, arrays = request("v_frames", 0)
    status, got = send(urls["port", False], meta, arrays, binary=True)
    assert status == 200
    want = port_engine.extract(modalities="v", frames=arrays["frames"],
                               fname=meta["fname"])
    np.testing.assert_allclose(got["gesture_emb"], want["gesture_emb"],
                               **TOL)
    keys = [sig[0] for sig in port_engine.cached_graphs]
    assert ("fused", "planar", False, False, False) in keys


# ---------------------------------------------------------------------------
# the batcher on fake engines (as tests/test_serving_http.py)
# ---------------------------------------------------------------------------

class Boom(BaseException):
    pass


def test_batcher_worker_death_does_not_hang():
    """A BaseException from the engine kills the worker: waiting clients
    get an error instead of blocking, and later submits fail fast."""
    class DyingEngine:
        cached_graphs = []

        def extract_many(self, *a, **kw):
            raise Boom("card on fire")

        def extract(self, *a, **kw):
            raise Boom("card on fire")

    b = TS._Batcher(DyingEngine(), window_ms=5, max_batch=4,
                    lock=threading.Lock())
    with pytest.raises(RuntimeError, match="died"):
        b.submit("ta", {"text": "x"})
    assert b.dead is not None
    with pytest.raises(RuntimeError, match="died"):
        b.submit("ta", {"text": "y"})


def test_healthz_503_when_batcher_dead():
    class FakeEngine:
        cached_graphs = []

    b = TS._Batcher(FakeEngine(), window_ms=5, max_batch=2,
                    lock=threading.Lock())
    b.dead = RuntimeError("card on fire")
    srv = TS.create_server(FakeEngine(), host="127.0.0.1", port=0)
    srv.RequestHandlerClass = TS._make_handler(
        FakeEngine(), threading.Lock(), b, max_body_bytes=1 << 20)
    with running(srv) as url:
        status, body = get(url)
    assert status == 503
    assert body["ok"] is False and "died" in body["error"]


def test_batcher_dispatches_without_ladder():
    calls = []

    class SpyEngine:
        cached_graphs = []

        def extract_many(self, samples, **kw):
            calls.append(kw)
            return [{"ok": True} for _ in samples]

    b = TS._Batcher(SpyEngine(), window_ms=5, max_batch=4,
                    lock=threading.Lock())
    assert b.submit("t", {"text": "ab hello"}) == {"ok": True}
    assert calls and calls[0]["ladder"] is False
    assert calls[0]["batch_size"] == 4 and calls[0]["mesh"] is None


def test_poison_batch_does_not_stall_healthy_clients():
    """A batchmate that makes the batched call raise fails alone: the
    batcher retries each sample alone, healthy requests answer."""
    class PoisonEngine:
        cached_graphs = []

        def _ok(self, s):
            return {"gesture_emb": None, "content_emb": None,
                    "info": {"fname": s.get("fname")}}

        def extract_many(self, samples, **kw):
            if any(s.get("fname") == "poison" for s in samples):
                raise RuntimeError("batch blew up")
            return [self._ok(s) for s in samples]

        def extract(self, modalities=None, **s):
            if s.get("fname") == "poison":
                raise RuntimeError("still broken")
            return self._ok(s)

    b = TS._Batcher(PoisonEngine(), window_ms=50, max_batch=8,
                    lock=threading.Lock())

    def go(name):
        t0 = time.monotonic()
        try:
            out = b.submit("t", {"fname": name, "text": "x"})
        except RuntimeError as e:
            out = e
        return name, out, time.monotonic() - t0

    names = ["h0", "h1", "poison", "h2", "h3"]
    with ThreadPoolExecutor(5) as ex:
        results = {n: (r, dt) for n, r, dt in ex.map(go, names)}
    for n in ("h0", "h1", "h2", "h3"):
        r, dt = results[n]
        assert isinstance(r, dict) and r["info"]["fname"] == n
        assert dt < 30, (n, dt)
    assert isinstance(results["poison"][0], RuntimeError)
    assert b.dead is None


# ---------------------------------------------------------------------------
# load, warm-up, the repack build, the CLI
# ---------------------------------------------------------------------------

def load_payloads(n: int, poison_every: int):
    """Mixed ta / t / a requests, every poison_every-th one invalid: a
    word-count mismatch (422 from inside a batch) for ta, blank text (400)
    for t, start > end (400) for a."""
    rng = np.random.default_rng(9)
    out = []
    for i in range(n):
        combo = ("ta", "t", "a")[i % 3]
        meta = {"modalities": combo, "fname": f"r{i}",
                "word_boundaries": WBS}
        arrays = {}
        if "t" in combo:
            meta["text"] = "hello world abc"
        if "a" in combo:
            arrays["wav"] = (rng.standard_normal(16000) * 500
                             ).astype(np.float32)
        poison = i % poison_every == poison_every - 1
        if poison:
            if combo == "ta":
                meta["word_boundaries"] = [["zzz", 2, 7]]
            elif combo == "t":
                meta["text"] = " "
            else:
                meta["word_boundaries"] = [["x", 50, 10]]
        out.append((meta, arrays, poison))
    return out


def test_mixed_combo_load_with_poison(port_engine):
    """Concurrent mixed-combo binary load through a batched server: every
    healthy request answers 200 as the unbatched engine does, every poison
    request 4xx, and the latency quantiles are positive."""
    payloads = load_payloads(14, poison_every=7)
    with running(TS.create_server(port_engine, host="127.0.0.1", port=0,
                                  batch_window_ms=20, max_batch=4)) as url:
        def go(p):
            t0 = time.perf_counter()
            status, body = send(url, p[0], p[1], binary=True)
            return status, body, time.perf_counter() - t0

        with ThreadPoolExecutor(6) as ex:
            results = list(ex.map(go, payloads))
    lat = sorted(dt for _, _, dt in results)
    assert np.percentile(lat, 99) >= np.percentile(lat, 50) > 0
    for (meta, arrays, poison), (status, body, _) in zip(payloads, results):
        if poison:
            assert status in (400, 422), (meta, status)
            continue
        assert status == 200, (meta, body)
        want = port_engine.extract(modalities=meta["modalities"],
                                   text=meta.get("text"),
                                   word_boundaries=meta["word_boundaries"],
                                   wav=arrays.get("wav"), fname=meta["fname"])
        np.testing.assert_allclose(body["content_emb"], want["content_emb"],
                                   **TOL)


class _WarmupLog:
    """An engine stand-in that records each warmup call."""

    def __init__(self):
        self.calls = []

    def warmup(self, modalities, batch=1, mesh=None, frames_kind=None,
               **kw):
        assert mesh is None and not kw
        self.calls.append((modalities, batch, frames_kind))


@pytest.mark.parametrize("window_ms, frames", [(0, None), (5, "planar"),
                                               (5, "raw")])
def test_serve_warms_what_jax_serve_warms(monkeypatch, capsys, window_ms,
                                          frames):
    """`serve` in either package makes the same warmup calls (combo, batch,
    frames kind) for the same flags, in the same order, before it serves."""
    class NoServer:
        server_address = ("127.0.0.1", 1234)
        batcher = None

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    logs = {}
    for name, mod in (("port", TS), ("jax", JS)):
        monkeypatch.setattr(mod, "create_server",
                            lambda *a, **kw: NoServer())
        logs[name] = _WarmupLog()
        mod.serve(logs[name], port=0, warmup_combos=("vta", "ta", "v"),
                  batch_window_ms=window_ms, max_batch=MAX_BATCH,
                  warmup_frames=frames)
    batch = MAX_BATCH if window_ms else 1
    want = [("vta", batch, None)] + ([("vta", batch, frames)] if frames
                                     else []) + [("ta", batch, None),
                                                 ("v", batch, None)] + (
        [("v", batch, frames)] if frames else [])
    assert logs["port"].calls == logs["jax"].calls == want
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] == json.dumps({
        "serving": "http://127.0.0.1:1234", "warmed": ["vta", "ta", "v"],
        "batch_window_ms": window_ms})


def test_warmup_leaves_live_batches_nothing_to_capture(weights):
    """After `serving.warmup` (what serve runs) live batched requests at the
    engine's default buckets (ta: S 64, W 16, mel 512; v: T 128) add no
    graph to the engine's cache."""
    jp, gp, rp = weights
    eng = TAPI.JegalEngine(jegal_params_from_jax(jp),
                           gestsync_params_from_jax(gp), device="cpu",
                           roberta_params=roberta_params_from_jax(rp),
                           roberta_cfg=RobertaConfig(**TINY_XLMR),
                           tokenizer=WordTokenizer(make_tiny_tokenizer()))
    TS.warmup(eng, ("ta", "v"), batch_window_ms=5, max_batch=MAX_BATCH)
    n = len(eng.cached_graphs)
    assert n == 2
    # 10 words of 45 tokens, 4.5 s of audio, 100 frames of features
    words = "abcdef ghijk lmnop qrstu vwxyz hello world 012345 678 abc"
    wbs = [[w, 10 * i, 10 * i + 8] for i, w in enumerate(words.split())]
    rng = np.random.default_rng(7)
    reqs = [({"modalities": "ta", "text": words, "word_boundaries": wbs,
              "fname": f"ta{i}"},
             {"wav": (rng.standard_normal(72000) * 500).astype(np.float32)})
            for i in range(2)]
    reqs += [({"modalities": "v", "fname": f"vf{i}"},
              {"visual_feats": rng.standard_normal(
                  (100 - i, 1024)).astype(np.float32)}) for i in range(2)]
    with running(TS.create_server(eng, host="127.0.0.1", port=0,
                                  batch_window_ms=5,
                                  max_batch=MAX_BATCH)) as url:
        with ThreadPoolExecutor(4) as ex:
            answers = list(ex.map(lambda r: send(url, *r, True), reqs))
    assert [s for s, _ in answers] == [200] * 4
    assert answers[0][1]["content_emb"].shape == (10, 512)
    assert len(eng.cached_graphs) == n


def test_repack_build_failure_raises_at_create_server(port_engine,
                                                      monkeypatch):
    """No silent fallback: a repack library that does not build makes
    create_server raise (for an engine with GestSync weights); a text-only
    engine's server does not need it."""
    from jegal_torch.host import media

    def broken():
        raise RuntimeError("building the s2d repack failed")

    monkeypatch.setattr(media, "get_repack_lib", broken)
    with pytest.raises(RuntimeError, match="repack"):
        TS.create_server(port_engine, host="127.0.0.1", port=0)

    class TextEngine:
        gestsync_params = None
        cached_graphs = []

    TS.create_server(TextEngine(), host="127.0.0.1", port=0).server_close()


@pytest.fixture(scope="module")
def ckpt_files(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ckpts")
    jp, gp, rp = weights
    paths = {k: str(d / f"{k}.npz") for k in ("jegal", "gestsync", "roberta")}
    TCK.save_npz(jegal_params_from_jax(jp), paths["jegal"])
    TCK.save_npz(gestsync_params_from_jax(gp), paths["gestsync"])
    TCK.save_roberta_npz(roberta_params_from_jax(rp), paths["roberta"],
                         num_heads=8)
    paths["tok"] = str(d / "tokenizer.json")
    make_tiny_tokenizer().save(paths["tok"])
    return paths


def test_cli_serve_prints_url_and_answers(ckpt_files, port_engine):
    """`python -m jegal_torch serve --port 0 --device cpu` warms, prints
    {"serving": url, "warmed": [...], "batch_window_ms": ...} with the
    bound port as its first line, and answers as the engine does."""
    cmd = [sys.executable, "-m", "jegal_torch", "serve",
           "--checkpoint_path", ckpt_files["jegal"],
           "--checkpoint_path_gestsync", ckpt_files["gestsync"],
           "--roberta_path", ckpt_files["roberta"],
           "--tokenizer_path", ckpt_files["tok"], "--port", "0",
           "--warmup_combos", "t", "--batch_window_ms", "5",
           "--max_batch", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["warmed"] == ["t"] and first["batch_window_ms"] == 5.0
        url = first["serving"]
        assert url.startswith("http://127.0.0.1:") and not url.endswith(":0")
        status, body = get(url)
        assert status == 200 and body["graphs"] == 1
        meta, arrays = request("ta", 0)
        status, got = send(url, meta, arrays, binary=False)
        assert status == 200
        want = port_engine.extract(modalities="ta", text=meta["text"],
                                   word_boundaries=WBS, wav=arrays["wav"],
                                   fname=meta["fname"])
        np.testing.assert_allclose(got["content_emb"], want["content_emb"],
                                   **TOL)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("flag,item", [("--bf16", "item 3"),
                                       ("--data_parallel", "item 4")])
def test_cli_serve_refuses_what_waits(flag, item, monkeypatch):
    """Neither option waits for its ROADMAP item any more: `--bf16` (item
    3) reaches `serve` with the bf16 dtype, and `--data_parallel` (item 4)
    runs (tests/test_torch_infer_mesh.py) but, as the JAX CLI's, exits
    without a batch window (`--batch_window_ms` 0, the default), with the
    JAX CLI's message."""
    import torch

    from jegal_torch.cli import main as TCLI
    from jegal_tpu.cli import main as jax_main

    argv = ["serve", "--checkpoint_path", "x.npz", flag]
    if flag == "--bf16":
        seen = []
        monkeypatch.setitem(TCLI.COMMANDS, "serve",
                            lambda args: seen.append(TCLI._dtype(args)))
        TCLI.main(argv + ["--device", "cpu"])
        assert seen == [torch.bfloat16]
        return
    with pytest.raises(SystemExit) as port_exit:
        TCLI.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jax_main(argv)
    assert str(port_exit.value) == str(jax_exit.value)
    assert "requires --batch_window_ms > 0" in str(port_exit.value)

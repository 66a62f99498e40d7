"""HTTP serving endpoint for JegalEngine (the JAX package's serving.py).

A stdlib HTTP server in front of the bucketed engine, whose graphs are
captured ahead of traffic (`warmup`): one card, so the forwards serialize
through one lock, and every CUDA call of the request path runs inside it
(a capture in flight must see no CUDA call from another thread).

Wire protocol (JSON; arrays as base64-encoded .npy), byte-compatible with
the JAX package's server, so that its clients work unchanged:

  GET  /healthz           -> {"ok": true, "graphs": N}   # N cached graphs
  POST /extract           body: {
      "modalities": "vta" | ... | "a",
      "text": str | null,
      "word_boundaries": [[word, start_frame, end_frame], ...] | null,
      "wav": b64(.npy float32 (S,)) | null,
      "visual_feats": b64(.npy float32 (T, 1024)) | null,
      "frames": b64(.npy uint8 (T, 270, 480, 3)) | null,   # alternative to
      "fname": str | null                                  # visual_feats
  }
  -> {"gesture_emb": b64(.npy) | null, "content_emb": b64(.npy) | null,
      "info": {...}}  |  {"error": "..."} (HTTP 400/413/422/500)

422 mirrors the engine's None result (sample invalid under reference
rules) so clients can distinguish bad samples from server faults.

Large payloads (raw frames) should use the BINARY protocol instead:
POST /extract with `Content-Type: application/octet-stream` and an
encode_binary()-framed body (JSON header + uncompressed npz — no base64
inflation, no monolithic json.loads); add `Accept:
application/octet-stream` for a binary response.

Raw (T, 270, 480, 3) frames are repacked to the stem's planar layout on
the request thread, outside the lock, by the C++ repack
(host/csrc/repack.cc, no libav). Its library is built when a server for
an engine with GestSync weights is created: a build that fails raises
there, never per request.

Data-parallel serving (`mesh=`, a ('data', 'model') DeviceMesh, one
process a rank): rank 0 binds the address, runs the handlers and the
batcher, and before each batched `extract_many(mesh=)` broadcasts the
batch's (modalities, samples) over the mesh's control group; every other
rank warms the same graphs and then `follow`s, making the same collective
call for each broadcast batch until rank 0 broadcasts None at shutdown.
An idle rank 0 broadcasts an empty heartbeat every HEARTBEAT_S, so that
no follower waits past the control group's timeout; a collective that
fails ends every rank's run.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from jegal_torch.api import ClientError
from jegal_torch.parallel import mesh as M

HEARTBEAT_S = 60.0      # an idle rank 0's beat to the followers


def encode_array(arr) -> str | None:
    if arr is None:
        return None
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return base64.b64encode(buf.getvalue()).decode()


def decode_array(b64: str | None):
    if b64 is None:
        return None
    return np.load(io.BytesIO(base64.b64decode(b64)), allow_pickle=False)


# ---------------------------------------------------------------------------
# Binary wire protocol (Content-Type: application/octet-stream)
#
# Arrays travel as an UNCOMPRESSED npz (a straight memcpy on both ends)
# with a small JSON header for the scalar fields:
#
#   b"JGL1" | uint32_be header_len | header JSON | npz(arrays)
#
# header: {"modalities", "text", "word_boundaries", "fname"}; npz arrays
# among {"visual_feats", "frames", "wav"}. Responses use the same framing
# (header {"info": ...}; arrays among {"gesture_emb", "content_emb"}) when
# the client sends `Accept: application/octet-stream`.
# ---------------------------------------------------------------------------

BINARY_MAGIC = b"JGL1"
BINARY_CONTENT_TYPE = "application/octet-stream"


def encode_binary(meta: dict, arrays: dict) -> bytes:
    """Frame a request/response: JSON-able meta + numpy arrays."""
    hdr = json.dumps(meta).encode()
    buf = io.BytesIO()
    present = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    if present:
        np.savez(buf, **present)  # ZIP_STORED: no compression pass
    return BINARY_MAGIC + len(hdr).to_bytes(4, "big") + hdr + buf.getvalue()


def decode_binary(body: bytes) -> tuple[dict, dict]:
    """-> (meta dict, arrays dict). Raises ValueError on malformed framing
    (the handler maps it to HTTP 400)."""
    if body[:4] != BINARY_MAGIC:
        raise ValueError(f"bad magic {body[:4]!r} (expected "
                         f"{BINARY_MAGIC.decode()} framing)")
    if len(body) < 8:
        raise ValueError("truncated header length")
    n = int.from_bytes(body[4:8], "big")
    if 8 + n > len(body):
        raise ValueError(f"header length {n} exceeds body")
    meta = json.loads(body[8 : 8 + n])
    if not isinstance(meta, dict):
        raise ValueError("header must be a JSON object")
    rest = body[8 + n :]
    arrays: dict = {}
    if rest:
        with np.load(io.BytesIO(rest), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    return meta, arrays


def on_engine_device(engine):
    """Context that makes the engine's card this thread's current device
    (the current device is per thread in PyTorch, and a handler or
    batcher thread starts on card 0); a no-op for a CPU engine."""
    device = getattr(engine, "device", None)
    if getattr(device, "type", None) != "cuda":
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(device)


class _Batcher:
    """Cross-request batching: concurrent /extract requests within a small
    window run as ONE engine.extract_many call (same-bucket samples share
    a graph replay). Per-sample semantics are identical to engine.extract
    (batch padding is exactly neutral, tested)."""

    # generous: a sample whose bucket was not warmed captures its graph
    # inside the request (seconds on the card); warmed graphs answer in
    # tens of ms
    SUBMIT_TIMEOUT_S = 600.0

    def __init__(self, engine, window_ms: float, max_batch: int,
                 lock: threading.Lock, mesh=None, on_death=None):
        self.engine = engine
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.lock = lock        # shared with the unbatched path
        self.mesh = mesh        # data-parallel extract_many, rank 0's side
        self.on_death = on_death
        self.q: queue.Queue = queue.Queue()
        self.dead: BaseException | None = None
        self._inflight: list = []   # items dequeued but not yet answered
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker after the batches already queued (under a mesh
        it then broadcasts None, which ends the followers' loops) and wait
        for it."""
        self.q.put(None)
        self._thread.join()

    def submit(self, modalities: str, sample: dict):
        """Blocking; -> result dict | None (rejected) | raises the
        batch's engine error. Raises RuntimeError if the worker thread
        died or the request timed out (a 500, never a silent hang)."""
        if self.dead is not None:
            raise RuntimeError(f"batcher worker died: {self.dead!r}")
        ev = threading.Event()
        slot: dict = {}
        self.q.put((modalities, sample, ev, slot))
        # re-check AFTER the put: if the worker died between the check
        # above and the enqueue, its one-shot drain may already have run
        # and nothing will ever consume this item — fail it here instead
        # of stalling the client for the full timeout
        if self.dead is not None and not ev.is_set():
            slot.setdefault("error",
                            RuntimeError(f"batcher worker died: "
                                         f"{self.dead!r}"))
            ev.set()
        if not ev.wait(self.SUBMIT_TIMEOUT_S):
            raise RuntimeError(
                f"batcher timeout after {self.SUBMIT_TIMEOUT_S:.0f}s "
                f"(worker {'dead: ' + repr(self.dead) if self.dead else 'busy'})")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _run(self):
        # the whole loop body is guarded: anything that escapes the
        # per-batch handling below (including non-Exception BaseExceptions)
        # marks the batcher dead and errors out every waiting request
        # instead of leaving clients blocked forever
        try:
            with on_engine_device(self.engine):
                self._run_loop()
        except BaseException as e:  # noqa: BLE001 — deliberate backstop
            self.dead = e
            if self.on_death is not None:
                self.on_death()
            err = RuntimeError(f"batcher worker died: {e!r}")
            # in-flight items were already dequeued — error them first,
            # then drain whatever is still queued
            for _, _, ev, slot in self._inflight:
                if not ev.is_set():
                    slot["error"] = err
                    ev.set()
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[3]["error"] = err
                    item[2].set()

    def _next(self):
        """The next queued item; under a mesh, an idle wait broadcasts a
        heartbeat every HEARTBEAT_S."""
        while True:
            try:
                return self.q.get(timeout=None if self.mesh is None
                                  else HEARTBEAT_S)
            except queue.Empty:
                M.broadcast_object((), self.mesh)

    def _run_loop(self):
        while True:
            items = [self._next()]
            if items[0] is None:
                M.broadcast_object(None, self.mesh)
                return
            self._inflight = items
            deadline = time.monotonic() + self.window
            while len(items) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
                if items[-1] is None:     # close: after this batch
                    self.q.put(items.pop())
                    break
            by_mod: dict = {}
            for it in items:
                by_mod.setdefault(it[0], []).append(it)
            for mod, group in by_mod.items():
                samples = [g[1] for g in group]
                try:
                    # one card: shared with the unbatched path. extract_many
                    # fetches every result to the host before it returns,
                    # so no replay can overwrite an output after the lock
                    with self.lock:
                        M.broadcast_object((mod, samples, self.max_batch),
                                           self.mesh)
                        results = _extract_batch(self.engine, mod, samples,
                                                 self.max_batch, self.mesh)
                except M.CollectiveError:
                    raise
                except Exception:
                    # per-request isolation: one malformed batchmate must
                    # not fail the others — retry each sample alone and
                    # attribute errors individually
                    for _, sample, ev, slot in group:
                        try:
                            with self.lock:
                                slot["result"] = self.engine.extract(
                                    modalities=mod, **sample)
                        except Exception as e:
                            slot["error"] = e
                        ev.set()
                    continue
                for (_, sample, ev, slot), res in zip(group, results):
                    if res is None:
                        self._classify(mod, sample, slot)
                    slot["result"] = res
                    ev.set()
            # all groups answered: drop the references so a burst's large
            # sample arrays don't stay pinned while the worker idles in
            # q.get() (placed after the group loop — clearing earlier would
            # hide still-unanswered groups from the death backstop)
            self._inflight = []

    def _classify(self, mod: str, sample: dict, slot: dict) -> None:
        """extract_many maps malformed batchmates to None (the batch
        contract); re-run the host-side validation alone to classify:
        engine ClientError -> 400, invalid under reference semantics -> 422
        (None result). Host work only. Frames-carrying samples validate the
        frames shape, then the content modalities — 'v' is satisfied by
        the frames themselves."""
        try:
            check_mod, vf = mod, sample.get("visual_feats")
            if sample.get("frames") is not None:
                self.engine._frames_kind(np.asarray(sample["frames"]))
                check_mod, vf = mod.replace("v", ""), None
            if check_mod:
                self.engine._prepare_sample(
                    check_mod, vf, sample.get("text"),
                    sample.get("word_boundaries"), sample.get("wav"))
        except ClientError as e:
            slot["error"] = e


def _extract_batch(engine, mod: str, samples: list, max_batch: int, mesh):
    """The batcher's one engine call, on every rank alike: every call pads
    to max_batch, the ONE batch size `warmup` warmed (the power-of-two
    ladder would capture a new (key, shape, batch) graph inside a
    request)."""
    return engine.extract_many(samples, modalities=mod, batch_size=max_batch,
                               ladder=False, mesh=mesh)


def follow(engine, mesh) -> None:
    """A data-parallel server's rank > 0: make rank 0's batched call for
    each batch it broadcasts (its heartbeats aside), until it broadcasts
    None. A call that raises alike on every rank (rank 0 retries its
    samples one by one, on its own card) is left for the next batch; a
    failed collective ends the run."""
    with on_engine_device(engine):
        while (msg := M.broadcast_object(None, mesh)) is not None:
            if not msg:
                continue
            try:
                _extract_batch(engine, *msg, mesh)
            except M.CollectiveError:
                raise
            except Exception as e:  # noqa: BLE001 — rank 0 answers for it
                print(f"follower: a batch raised {e!r}; rank 0 retries its "
                      f"samples alone", file=sys.stderr, flush=True)


def _repack_raw(frames: np.ndarray) -> np.ndarray:
    """Raw (T, 270, 480, 3) uint8 frames -> planar (T, 90, 27, 160),
    masked at the fallback chin row as engine.extract masks raw frames
    without chin rows (bit-identical, tested), by the C++ repack."""
    from jegal_torch.host import media
    from jegal_torch.ops.video import FALLBACK_ROWS

    return media.s2d_repack(
        frames, np.full((frames.shape[0],), FALLBACK_ROWS, np.int32))


def _make_handler(engine, lock: threading.Lock, batcher: _Batcher | None,
                  max_body_bytes: int):
    class Handler(BaseHTTPRequestHandler):
        server_version = "jegal_torch"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_binary(self, out: dict):
            body = encode_binary({"info": out["info"]},
                                 {"gesture_emb": out["gesture_emb"],
                                  "content_emb": out["content_emb"]})
            self.send_response(200)
            self.send_header("Content-Type", BINARY_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            ok = batcher is None or batcher.dead is None
            payload = {
                "ok": ok,
                "graphs": len(engine.cached_graphs),
            }
            if batcher is not None:
                payload["queue_depth"] = batcher.q.qsize()
            if not ok:
                # surface deadness at the HTTP level: load balancers and
                # k8s probes key on the status code, not the body
                payload["error"] = f"batcher worker died: {batcher.dead!r}"
                return self._reply(503, payload)
            self._reply(200, payload)

        def do_POST(self):
            if self.path != "/extract":
                return self._reply(404, {"error": "unknown path"})
            binary = ((self.headers.get("Content-Type") or "")
                      .split(";")[0].strip() == BINARY_CONTENT_TYPE)
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    return self._reply(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"{max_body_bytes}-byte limit"})
                body = self.rfile.read(n)
                if binary:
                    req, bin_arrays = decode_binary(body)
                else:
                    req = json.loads(body)
            except (ValueError, json.JSONDecodeError, KeyError) as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            if not isinstance(req, dict):
                return self._reply(400, {"error": "body must be a JSON "
                                                  "object"})
            try:
                if binary:
                    visual_feats = bin_arrays.get("visual_feats")
                    frames = bin_arrays.get("frames")
                    wav = bin_arrays.get("wav")
                else:
                    visual_feats = decode_array(req.get("visual_feats"))
                    frames = decode_array(req.get("frames"))
                    wav = decode_array(req.get("wav"))
            except (ValueError, OSError, TypeError) as e:
                return self._reply(400, {"error": f"bad array: {e}"})
            modalities = req.get("modalities", "vta")
            try:
                if visual_feats is None and frames is not None:
                    # raw frames are repacked and masked on THIS request
                    # thread (host work, outside the lock); the card then
                    # runs the fused tower + JEGAL graph inside
                    # engine.extract / the batcher's extract_many, the
                    # features never leaving the device
                    frames = np.asarray(frames, np.uint8)
                    # validate BEFORE the native repack: malformed client
                    # shapes must surface as 400 (ClientError), not as a
                    # repack error mapped to a 500 server fault
                    if frames.ndim != 4 or (
                            frames.shape[1:] not in ((270, 480, 3),
                                                     (90, 27, 160))):
                        raise ClientError(
                            "frames must be (T, 270, 480, 3) uint8 "
                            "decoder-resized RGB or (T, 90, 27, 160) "
                            f"host-repacked planar, got {frames.shape}")
                    if frames.shape[1:] == (270, 480, 3):
                        frames = _repack_raw(frames)
                sample = dict(
                    visual_feats=visual_feats,
                    text=req.get("text"),
                    word_boundaries=req.get("word_boundaries"),
                    wav=None if wav is None
                    else np.asarray(wav, np.float32),
                    fname=req.get("fname"),
                )
                if visual_feats is None and frames is not None:
                    sample["frames"] = frames
                if batcher is not None:
                    out = batcher.submit(modalities, sample)
                else:
                    # one card: serialize the forwards; extract fetches
                    # its result to the host before it returns
                    with lock, on_engine_device(engine):
                        out = engine.extract(modalities=modalities, **sample)
            except ClientError as e:  # engine-validated client data problem
                return self._reply(400, {"error": str(e)})
            except Exception as e:
                # server fault — including RuntimeError subclasses such as
                # a CUDA error or torch.cuda.OutOfMemoryError, engine
                # misconfiguration, AND internal ValueErrors (shape bugs
                # are not the client's fault — only the engine's explicit
                # ClientError maps to 400)
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            if out is None:
                return self._reply(422, {
                    "error": "sample rejected (invalid words/tokenization "
                             "under reference rules)"})
            if BINARY_CONTENT_TYPE in (self.headers.get("Accept") or ""):
                return self._reply_binary(out)
            self._reply(200, {
                "gesture_emb": encode_array(out["gesture_emb"]),
                "content_emb": encode_array(out["content_emb"]),
                "info": out["info"],
            })

    return Handler


DEFAULT_MAX_BODY = 512 * 1024 * 1024  # raw-frames payloads are large
                                      # (125 frames uint8 ~ 65 MB as b64)


class _Server(ThreadingHTTPServer):
    """The HTTP server; `server_close` also stops its batcher (under a
    mesh, that ends the followers' loops)."""

    batcher: _Batcher | None = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def _check_mesh_window(mesh, batch_window_ms: float) -> None:
    if mesh is not None and batch_window_ms <= 0:
        # without a window every request runs engine.extract on one clip:
        # the mesh would only steer warmup into graphs no request replays
        raise ValueError("data-parallel serving (mesh=...) requires "
                         "batch_window_ms > 0 — requests run data-parallel "
                         "only through the cross-request batcher")


def create_server(engine, host: str = "127.0.0.1", port: int = 8000,
                  batch_window_ms: float = 0.0,
                  max_batch: int = 8, mesh=None,
                  max_body_bytes: int = DEFAULT_MAX_BODY
                  ) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; `.serve_forever()` runs it,
    `.shutdown()` and `.server_close()` stop it. Port 0 binds an ephemeral
    port (tests). batch_window_ms > 0 batches concurrent requests into one
    engine call (_Batcher). For an engine with GestSync weights the C++
    repack of raw frames is built and loaded here, so that a failed build
    raises now and not inside a request.

    mesh: data-parallel serving, on the mesh's rank 0 (the other ranks run
    `follow`): the batcher's calls are collective (needs batch_window_ms >
    0, else ValueError), and a batcher that dies of a failed collective
    shuts the server down.

    The endpoint has NO authentication and binds loopback by default;
    exposing it beyond localhost requires a fronting proxy / auth layer
    (pass host='0.0.0.0' explicitly). Bodies over max_body_bytes are
    rejected with 413 before being read."""
    _check_mesh_window(mesh, batch_window_ms)
    if getattr(engine, "gestsync_params", None) is not None:
        from jegal_torch.host import media

        media.get_repack_lib()
    lock = threading.Lock()
    batcher = (_Batcher(engine, batch_window_ms, max_batch, lock, mesh=mesh)
               if batch_window_ms > 0 else None)
    server = _Server((host, port),
                     _make_handler(engine, lock, batcher, max_body_bytes))
    server.batcher = batcher
    if mesh is not None:
        batcher.on_death = lambda: threading.Thread(target=server.shutdown,
                                                    daemon=True).start()
    return server


def warmup(engine, warmup_combos=(), batch_window_ms: float = 0.0,
           max_batch: int = 16, warmup_frames: str | None = None,
           mesh=None) -> None:
    """Capture the graphs the traffic will hit, before the server takes
    any (what `serve` runs, as the JAX package's serve): the batcher pads
    every call to max_batch (extract_many with ladder=False), the
    unbatched path runs batch-1 extracts, each at the engine's default
    buckets. Frames traffic runs the FUSED frames -> embeddings graph, a
    different graph from the two-stage forward; warmup_frames warms it for
    the kind the deployment expects ('planar' when clients or a fronting
    decoder repack, 'raw' for RGB uint8; the server repacks raw frames,
    so raw traffic runs the planar graph). mesh: the data-parallel graphs
    (engine.warmup(mesh=)), on every rank alike."""
    warm_batch = max_batch if batch_window_ms > 0 else 1
    for combo in warmup_combos:
        engine.warmup(modalities=combo, batch=warm_batch, mesh=mesh)
        if warmup_frames and "v" in combo:
            engine.warmup(modalities=combo, batch=warm_batch,
                          frames_kind=warmup_frames, mesh=mesh)


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          warmup_combos=(), batch_window_ms: float = 0.0,
          max_batch: int = 16, mesh=None,
          max_body_bytes: int = DEFAULT_MAX_BODY,
          warmup_frames: str | None = None) -> None:
    """Warm, then serve until interrupted. mesh: every rank of the mesh
    calls `serve` alike; rank 0 serves, the others `follow`. A batcher
    that died of a failed collective ends the call with RuntimeError."""
    _check_mesh_window(mesh, batch_window_ms)
    warmup(engine, warmup_combos, batch_window_ms, max_batch, warmup_frames,
           mesh)
    if not M.is_main(mesh):
        follow(engine, mesh)
        return
    server = create_server(engine, host, port,
                           batch_window_ms=batch_window_ms,
                           max_batch=max_batch, mesh=mesh,
                           max_body_bytes=max_body_bytes)
    print(json.dumps({"serving": f"http://{host}:{server.server_address[1]}",
                      "warmed": list(warmup_combos),
                      "batch_window_ms": batch_window_ms}), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    if server.batcher is not None and server.batcher.dead is not None:
        raise RuntimeError(f"the batcher died: {server.batcher.dead!r}")

"""JegalEngine — embedding extraction on the port (the JAX package's
api.py, reference inference_embs.py:526-646).

All seven combos of v, t and a. Given decoder frames, the engine runs the
fused single-clip path of the JAX engine's `_extract_fused`
(api.py:563-613): frames -> face mask -> GestSync tower -> JEGAL gesture
branch, beside the text branch (XLM-R -> text encoder -> word pooling) and
the audio branch, with no host round trip between the stages; embeddings
come back once and are L2-normalized in float32 on the host.

The text modality needs XLM-R parameters and a tokenizer: a
`jegal_torch.text.WordTokenizer` over any backend with its duck-typed
interface (for the real vocabulary, `WordTokenizer.from_file` on
xlm-roberta-base's tokenizer.json, which needs the `tokenizers` package).

The engine runs on the card unless the caller passes device="cpu"; with no
card it raises rather than falling back.
"""

from __future__ import annotations

import numpy as np
import torch

from jegal_torch.convert import tree_to_torch
from jegal_torch.data.bucketing import (
    MEL_BUCKETS,
    S_BUCKETS,
    T_BUCKETS,
    W_BUCKETS,
    next_bucket,
    pad_axis,
)
from jegal_torch.models import gestsync as G
from jegal_torch.models import jegal as J
from jegal_torch.models import roberta as R
from jegal_torch.ops.audio import wav2filterbanks_np
from jegal_torch.ops.pooling import (
    build_audio_pooling,
    build_text_pooling,
    text_word_starts,
)
from jegal_torch.ops.video import FALLBACK_ROWS, mask_frames_device

RAW_FRAME = (270, 480, 3)
PLANAR_FRAME = (90, 27, 160)


class ClientError(ValueError):
    """Invalid client-supplied sample (a modality without its data, a
    malformed array)."""


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


class JegalEngine:
    """Holds parameter trees (jegal_torch.convert layout) on one device, and
    the tokenizer, and extracts L2-normalized embeddings."""

    def __init__(self, jegal_params, gestsync_params=None, device="cuda",
                 roberta_params=None, tokenizer=None,
                 roberta_cfg: R.RobertaConfig = R.XLMR_BASE):
        self.device = resolve_device(device)
        self.jegal_params = tree_to_torch(jegal_params, self.device)
        self.gestsync_params = (None if gestsync_params is None
                                else tree_to_torch(gestsync_params, self.device))
        self.roberta_params = (None if roberta_params is None
                               else tree_to_torch(roberta_params, self.device))
        if self.roberta_params is not None \
                and "fused_ops" not in self.roberta_params:
            # once at load: the stack kernel's operands are then ready and
            # no forward stacks or concatenates a weight
            self.roberta_params = R.stack_layers(self.roberta_params)
        self.tokenizer = tokenizer
        self.roberta_cfg = roberta_cfg

    # ------------------------------------------------------------------
    # Host-side preparation
    # ------------------------------------------------------------------

    def prepare_text(self, text: str):
        """-> (arrays dict, num_words), ids padded with the tokenizer's pad
        id to the S bucket; (None, 0) when the sample is invalid under the
        reference's rules (the tokenizer merged words)."""
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer (text modality)")
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
        mel = wav2filterbanks_np(wav)
        t_mel = mel.shape[1]
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
            "audio_mel": pad_axis(mel, 1, mel_bucket),
            "audio_pool": pad_axis(pool, 2, mel_bucket // 4),
            "audio_valid": np.asarray([t_mel], np.int64),
        }, n_words

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
        arrays: dict = {}
        t_true = w_true = None
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
            aa, n_words = self.prepare_audio(wv.astype(np.float32),
                                             word_boundaries)
            if aa is None:
                return None
            arrays.update(aa)
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
        return arrays, t_true, w_true

    # ------------------------------------------------------------------
    # Device forward
    # ------------------------------------------------------------------

    def _upload(self, arrays: dict) -> dict:
        out = {}
        for k, v in arrays.items():
            t = torch.as_tensor(v)
            if t.is_floating_point():
                t = t.to(torch.float32)
            out[k] = t.to(self.device)
        return out

    def _forward(self, use_v: bool, use_t: bool, use_a: bool, **arrays):
        return self._pack_emb(*J.forward_inference(
            self.jegal_params, self.roberta_params, use_v=use_v, use_t=use_t,
            use_a=use_a, roberta_cfg=self.roberta_cfg, **arrays))

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
    def _postprocess(gesture, content, t_true, w_true, text, word_boundaries,
                     fname):
        """Valid rows, L2-normalized in float32 on the host (the .pkl
        contract is exactly unit-norm float32 rows, reference
        inference_embs.py:629-646)."""
        def norm_rows(x, n):
            out = np.asarray(x[0, :n], np.float32)
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
    def _check_frames(frames):
        if frames.ndim != 4 or tuple(frames.shape[1:]) not in (RAW_FRAME,
                                                               PLANAR_FRAME):
            raise ClientError(
                "frames must be (T, 270, 480, 3) uint8 decoder-resized RGB "
                "or (T, 90, 27, 160) host-repacked planar, got "
                f"{tuple(frames.shape)}")
        if frames.dtype != (torch.uint8 if isinstance(frames, torch.Tensor)
                            else np.uint8):
            raise ClientError(f"frames must be uint8, got {frames.dtype}")
        if tuple(frames.shape[1:]) == PLANAR_FRAME:
            raise NotImplementedError(
                "planar (T, 90, 27, 160) input is not ported yet; pass raw "
                "(T, 270, 480, 3) frames")

    def extract(self, modalities: str = "vta", visual_feats=None,
                text: str | None = None, word_boundaries: list | None = None,
                wav=None, fname: str | None = None, frames=None,
                chin_rows=None) -> dict | None:
        """-> {"gesture_emb": (T, 512) | None, "content_emb": (W, 512) |
        None, "info": {...}}, L2-normalized float32 numpy rows; None when
        the sample is invalid under the reference's rules.

        For 'v', pass EITHER visual_feats (T, 1024) OR decoder frames
        (T, 270, 480, 3) uint8 with optional per-frame chin_rows (T,):
        frames run the fused single-clip path."""
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
            packed = self._forward(use_v, use_t, use_a,
                                   **self._upload(arrays)).cpu().numpy()
            t_split = arrays["visual_feats"].shape[1] if use_v else None
            gesture, content = self._unpack_emb(packed, t_split, use_v,
                                                use_t or use_a)
            return self._postprocess(gesture, content, t_true, w_true, text,
                                     word_boundaries, fname)

    def _extract_fused(self, modalities, frames, chin_rows, text,
                       word_boundaries, wav, fname):
        """Frames -> tower -> JEGAL on the device, one host fetch at the
        end. Bucket-padded tail frames repeat the last frame (and its chin
        row); visual_mask keeps them out of every valid row's attention,
        and rows past T are sliced off."""
        if self.gestsync_params is None:
            raise RuntimeError("engine has no GestSync parameters")
        self._check_frames(frames)
        use_t, use_a = "t" in modalities, "a" in modalities
        prep = self._prepare_sample(modalities.replace("v", ""), None, text,
                                    word_boundaries, wav)
        if prep is None:
            return None
        arrays, _, w_true = prep
        t = frames.shape[0]
        t_bucket = next_bucket(t, T_BUCKETS)
        fr = torch.as_tensor(frames).to(self.device)
        cr = (np.asarray(chin_rows, np.int64) if chin_rows is not None
              else np.full((t,), FALLBACK_ROWS, np.int64))
        if cr.shape != (t,):
            raise ClientError(f"chin_rows must have one row per frame "
                              f"({t},), got {cr.shape}")
        if t_bucket != t:
            fr = torch.cat([fr, fr[-1:].expand(t_bucket - t, -1, -1, -1)])
            cr = np.concatenate([cr, np.full(t_bucket - t, cr[-1])])
        vmask = np.zeros((1, t_bucket), np.float32)
        vmask[0, :t] = 1.0
        masked = mask_frames_device(fr, torch.as_tensor(cr).to(self.device))
        feats = G.extract_features(self.gestsync_params, masked, chunk=160)
        packed = self._forward(True, use_t, use_a, visual_feats=feats[None],
                               **self._upload(dict(arrays, visual_mask=vmask)))
        gesture, content = self._unpack_emb(packed.cpu().numpy(), t_bucket,
                                            True, use_t or use_a)
        return self._postprocess(gesture, content, t, w_true, text,
                                 word_boundaries, fname)

"""One-command real-weight verification (`python -m jegal_torch verify`;
the JAX package's verify.py).

The day the reference checkpoints (gestsync.pth / jegal.pth /
xlm-roberta-base — reference README.md:52-59) are available, this runs the
whole parity story push-button instead of stitching subcommands together:

  1. convert every provided checkpoint (torch .pth DataParallel / HF /
     safetensors / native .npz all accepted by
     jegal_torch.convert.checkpoints),
  2. extract embeddings for the demo samples (reference samples/sample{1,2},
     README.md:104-120) under every modality combo the provided weights
     allow (all seven actually work here — reference inference_embs.py
     crashes on several, SURVEY.md §2.9 defect 4),
  3. if a golden directory is given (reference-generated .pkl files, same
     naming as our outputs: <sample>_<combo>.pkl), compare schema + per-row
     cosine against the tolerance,
  4. run the retrieval eval on the extracted set as an end-to-end smoke of
     the eval path.

Emits one JSON verdict. Exit status: 0 iff every executed step passed.

Golden generation (one-time, on a CUDA box with the reference repo):
run reference inference_embs.py per sample/combo and save its .pkl as
<sample>_<combo>.pkl — the schema is identical by construction.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

ALL_COMBOS = ("vta", "vt", "va", "ta", "v", "t", "a")
DEFAULT_TOLERANCE = 1e-3  # cosine > 1 - tol per embedding row (SURVEY §7)


def _cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    num = np.sum(a * b, axis=-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-12)


def compare_embeddings(ours: dict, golden: dict, tolerance: float) -> dict:
    """Schema + numerics diff of two .pkl embedding dicts."""
    result = {"ok": True, "checks": []}

    def fail(msg):
        result["ok"] = False
        result["checks"].append({"ok": False, "msg": msg})

    for key in ("gesture_emb", "content_emb"):
        g, o = golden.get(key), ours.get(key)
        if (g is None) != (o is None):
            fail(f"{key}: present mismatch (golden {g is not None}, "
                 f"ours {o is not None})")
            continue
        if g is None:
            result["checks"].append({"ok": True, "msg": f"{key}: both absent"})
            continue
        g, o = np.asarray(g), np.asarray(o)
        if g.shape != o.shape:
            fail(f"{key}: shape {o.shape} != golden {g.shape}")
            continue
        cos = _cosine_rows(o, g)
        worst = float(cos.min())
        ok = bool(worst > 1.0 - tolerance)
        result["ok"] &= ok
        result["checks"].append(
            {"ok": ok, "msg": f"{key}: min row cosine {worst:.6f} "
                              f"(tolerance > {1.0 - tolerance:.6f})"})
    return result


def _sample_inputs(samples_dir: str, name: str):
    """Load one demo sample's modality inputs (frames handled separately)."""
    from jegal_torch.host.media import load_audio_any
    from jegal_torch.text.normalize import load_text

    text, word_boundaries = load_text(os.path.join(samples_dir, name + ".txt"))
    wav = load_audio_any(os.path.join(samples_dir, name + ".wav"))
    return text, word_boundaries, wav


def run_verification(engine, samples_dir: str, res_dir: str,
                     golden_dir: str | None = None,
                     tolerance: float = DEFAULT_TOLERANCE,
                     samples=("sample1", "sample2"),
                     combos=None) -> dict:
    """-> JSON-able verdict dict; see module docstring for the steps."""
    os.makedirs(res_dir, exist_ok=True)

    have_v = engine.gestsync_params is not None
    have_t = engine.roberta_params is not None and engine.tokenizer is not None
    combos = combos or [c for c in ALL_COMBOS
                        if (("v" not in c or have_v)
                            and ("t" not in c or have_t))]

    verdict = {"combos": list(combos), "samples": {}, "ok": True}
    extracted = []
    for name in samples:
        sample_report = {}
        try:
            text, wbs, wav = _sample_inputs(samples_dir, name)
        except Exception as e:
            verdict["samples"][name] = {"error": f"inputs: {e}"}
            verdict["ok"] = False
            continue
        frames = chin = None
        if have_v:
            # NOT cli._video_features-style exit: that would end verify with
            # a SUCCESS status and no verdict on the gesture-visibility
            # gate — record the rejection instead
            from jegal_torch.cli.main import _decode_for_features

            decoded = _decode_for_features(
                os.path.join(samples_dir, name + ".avi"))
            if decoded is None:
                verdict["samples"][name] = {
                    "error": "gesture-visibility gate rejected the video"}
                verdict["ok"] = False
                continue
            frames, chin = decoded
        for combo in combos:
            # 'v' combos drive the FUSED frames->embeddings engine path
            # (tower + JEGAL forward in one dispatch) — the same graph the
            # CLI and serving use, so real-weight day-one verification
            # exercises the production path
            out = engine.extract(
                modalities=combo,
                frames=frames if "v" in combo else None,
                chin_rows=chin if "v" in combo else None,
                text=text if "t" in combo else None,
                word_boundaries=wbs,
                wav=wav if "a" in combo else None,
                fname=f"{name}_{combo}")
            if out is None:
                sample_report[combo] = {"ok": False,
                                        "error": "sample rejected"}
                verdict["ok"] = False
                continue
            pkl = os.path.join(res_dir, f"{name}_{combo}.pkl")
            with open(pkl, "wb") as f:
                pickle.dump(out, f)
            report = {"ok": True, "saved": pkl}
            if out["gesture_emb"] is not None:
                report["gesture_shape"] = list(out["gesture_emb"].shape)
            if out["content_emb"] is not None:
                report["content_shape"] = list(out["content_emb"].shape)
            if golden_dir is not None:
                gpath = os.path.join(golden_dir, f"{name}_{combo}.pkl")
                if os.path.exists(gpath):
                    with open(gpath, "rb") as f:
                        golden = pickle.load(f)
                    diff = compare_embeddings(out, golden, tolerance)
                    report["golden"] = diff
                    report["ok"] = diff["ok"]
                else:
                    report["golden"] = {"ok": False,
                                        "msg": f"missing golden {gpath}"}
                    report["ok"] = False
            verdict["ok"] &= report["ok"]
            sample_report[combo] = report
            if (out["gesture_emb"] is not None
                    and out["content_emb"] is not None):
                extracted.append((pkl, out))
        verdict["samples"][name] = sample_report

    # end-to-end eval smoke: cross-modal retrieval over every output that
    # has BOTH embeddings (the vta/vt/va combos; absent when no gestsync
    # weights were provided)
    if len(extracted) >= 2:
        eval_dir = os.path.join(res_dir, "_eval_smoke")
        os.makedirs(eval_dir, exist_ok=True)
        for pkl, out in extracted:
            with open(os.path.join(eval_dir, os.path.basename(pkl)),
                      "wb") as f:
                pickle.dump(out, f)
        from jegal_torch.eval import retrieval

        verdict["retrieval_smoke"] = retrieval.evaluate(eval_dir)
    return verdict

"""Word-boundary transcription backend (pluggable ASR; the JAX package's
host/transcribe.py).

The reference shells into WhisperX large-v3 on CPU (utils/
extract_transcripts_whisperx.py:17-81; inference_embs.py:379-430) to produce
'Text:/Lang:' headers plus 'WORD, START, END, SCORE' rows — both a
single-file path (inference) and a folder batch (corpus) with
skip-if-exists resume. WhisperX is an external pretrained model: it is
wrapped when installed, and otherwise a clear error tells the user to
provide --text_path. The backend is injectable for tests.
"""

from __future__ import annotations

import glob
import json
import os
import sys


class WhisperXBackend:
    """Lazy WhisperX wrapper: the model loads once and is shared across a
    folder batch (the reference's module-level `model`,
    extract_transcripts_whisperx.py:17-18,79)."""

    def __init__(self, model_type: str = "large-v3", device: str = "cpu",
                 compute_type: str = "float32", language: str | None = None):
        try:
            import whisperx
        except ImportError as e:
            raise RuntimeError(
                "no ASR backend installed (whisperx); provide --text_path "
                "with word boundaries instead, or install an ASR backend"
            ) from e
        self._wx = whisperx
        self._model = whisperx.load_model(model_type, device=device,
                                          compute_type=compute_type)
        self._device = device
        self._language = language
        self._aligners: dict = {}

    def __call__(self, audio_path: str, batch_size: int = 8) -> dict:
        """-> {"text", "language", "words": [(word, start, end, score)|
        (word, None, None, None)]}."""
        audio = self._wx.load_audio(audio_path)
        result = self._model.transcribe(audio, batch_size=batch_size,
                                        language=self._language)
        lang = result["language"]
        if lang not in self._aligners:
            self._aligners[lang] = self._wx.load_align_model(
                language_code=lang, device=self._device)
        align_model, metadata = self._aligners[lang]
        aligned = self._wx.align(result["segments"], align_model, metadata,
                                 audio, self._device,
                                 return_char_alignments=False)
        words = []
        for seg in aligned["segments"]:
            for w in seg["words"]:
                if "start" in w:
                    words.append((w["word"], w["start"], w["end"], w["score"]))
                else:
                    words.append((w["word"], None, None, None))
        return {"text": "".join(s["text"] for s in result["segments"]),
                "language": lang, "words": words}


def write_transcript(result: dict, out_path: str) -> None:
    """Reference file format (extract_transcripts_whisperx.py:46-64)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("Text: " + result["text"])
        f.write("\nLang: " + result["language"])
        f.write("\n\nWORD, START, END, SCORE\n")
        for word, start, end, score in result["words"]:
            if start is None:
                f.write(word + "\n")
            else:
                f.write(f"{word}, {start}, {end}, {score}\n")


def transcribe_to_file(audio_path: str, res_dir: str, batch_size: int = 8,
                       backend=None) -> str:
    """-> path of the written transcript file (reference format)."""
    backend = backend or WhisperXBackend()
    out_path = os.path.join(res_dir, "word_boundaries.txt")
    write_transcript(backend(audio_path, batch_size=batch_size), out_path)
    return out_path


def transcribe_folder(path: str, result_dir: str, batch_size: int = 8,
                      backend=None, exts=(".wav", ".mp3", ".m4a", ".flac")
                      ) -> dict:
    """The folder batch (reference extract_transcripts_whisperx.py
    get_predictions): every audio file under `path` -> `<result_dir>/
    <relpath-under-path, .txt>` (the whole tree mirrored — the reference
    keys only on the immediate parent's basename, :28, and collides on
    deeper trees), skip-if-exists resume (:32-33), and a JSON error line a
    failed file on stderr instead of the reference's silent loop.
    -> {"done", "skipped", "failed"} counts."""
    backend = backend or WhisperXBackend()
    files = sorted(
        f for f in glob.glob(os.path.join(path, "**", "*"), recursive=True)
        if f.lower().endswith(exts))
    stats = {"done": 0, "skipped": 0, "failed": 0}
    for audio_file in files:
        rel = os.path.relpath(audio_file, path)
        out_path = os.path.join(result_dir,
                                os.path.splitext(rel)[0] + ".txt")
        if os.path.exists(out_path):
            stats["skipped"] += 1
            continue
        try:
            write_transcript(backend(audio_file, batch_size=batch_size),
                             out_path)
            stats["done"] += 1
        except Exception as e:
            stats["failed"] += 1
            print(json.dumps({"file": audio_file, "error": str(e)}),
                  file=sys.stderr)
    return stats

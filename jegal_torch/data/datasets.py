"""CSV-driven batch embedding extraction for the AVS eval sets (the JAX
package's data/datasets.py).

Mirrors the reference's DataGenerator_Test + extract_jegal_embs flow
(dataset.py:198-355; evaluation/extract_jegal_embs.py:56-125): each CSV row
names a clip (filename), its phrase, and stringified word boundaries;
visual GestSync features come from `<feature_dir>/<filename>.npy`, audio
from `<video_dir>/<filename>.wav`. Output: one .pkl per sample named
`<dir>__<clip>.pkl`, whose `info` is the CSV row.

Sample preparation (disk IO) runs on a prefetch thread while the engine
computes. File-level idempotent resume (skip existing outputs) is kept from
the reference (extract_gestsync_feats.py:281-284), with a structured error
ledger instead of a silent except.

The CSV is read with the stdlib `csv` module, and each column is typed as
pandas' `read_csv` types it (`read_csv`), so that a row's `info` holds the
values, and value types, the JAX package stores from a pandas row:
numpy int64, float64 or bool for a numeric or boolean column, str for
text, and NaN for an empty cell.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import pickle
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from jegal_torch.api import ClientError

# pandas' default NA strings (read_csv's na_values)
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|inf|infinity)", re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def _column(cells: list) -> list:
    """One CSV column's cells -> its values as pandas' read_csv types them:
    all integers -> np.int64 (np.float64 when a cell is missing); all
    numbers -> np.float64; all booleans -> np.bool_ (Python bool beside
    NaN when a cell is missing); otherwise str, a missing cell NaN. A
    column with no value at all is np.float64 NaN."""
    present = [c for c in cells if c not in NA_VALUES]
    missing = len(present) < len(cells)
    if not present or all(_FLOAT.fullmatch(c) for c in present):
        if present and not missing and all(_INT.fullmatch(c)
                                           for c in present):
            return [np.int64(int(c)) for c in cells]
        return [np.float64("nan") if c in NA_VALUES else np.float64(float(c))
                for c in cells]
    if all(c in _BOOL for c in present):
        if missing:
            return [float("nan") if c in NA_VALUES else _BOOL[c]
                    for c in cells]
        return [np.bool_(_BOOL[c]) for c in cells]
    return [float("nan") if c in NA_VALUES else c for c in cells]


def read_csv(path: str) -> list[dict]:
    """A CSV file with a header -> one dict a row, column order kept, each
    value typed as in a pandas row of `pd.read_csv(path)` (see `_column`;
    the row's columns must include a text one, such as filename, as the
    AVS tables do: pandas would upcast an all-numeric row)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    columns = [_column([r[j] if j < len(r) else "" for r in rows])
               for j in range(len(header))]
    return [{name: columns[j][i] for j, name in enumerate(header)}
            for i in range(len(rows))]


def _out_name(filename: str) -> str:
    parts = filename.split("/")
    return parts[0] + "__" + parts[1] + ".pkl"


def load_sample(row, video_dir: str, feature_dir: str, modalities: str):
    """-> kwargs for JegalEngine.extract, or raises on missing inputs."""
    filename = row["filename"]
    kw: dict = {"modalities": modalities, "fname": None}
    if "v" in modalities:
        fpath = os.path.join(feature_dir, filename + ".npy")
        feats = np.load(fpath)
        if feats.ndim != 2 or feats.shape[1] != 1024:
            raise ValueError(f"bad GestSync feature shape {feats.shape}: {fpath}")
        kw["visual_feats"] = feats.astype(np.float32)
    if "t" in modalities or "a" in modalities:
        kw["word_boundaries"] = ast.literal_eval(row["word_boundaries"]) \
            if isinstance(row["word_boundaries"], str) else row["word_boundaries"]
    if "t" in modalities:
        kw["text"] = row["phrase"]
    if "a" in modalities:
        from jegal_torch.ops.audio import load_wav

        kw["wav"] = load_wav(os.path.join(video_dir, filename + ".wav"))
    return kw


def extract_embeddings_csv(engine, csv_path: str, video_dir: str,
                           feature_dir: str, res_dir: str,
                           modalities: str = "vta", rank: int = 0,
                           nshard: int = 1, prefetch: int = 2,
                           batch_size: int = 1, mesh=None) -> dict:
    """Run the engine over a CSV shard; returns an accounting dict.

    batch_size > 1 groups bucket-compatible samples into device batches
    through extract_many, whose rows equal per-sample extraction's.

    mesh: a ('data', 'model') DeviceMesh; a collective call. Every rank
    reads the same rows (no shard: rank and nshard must stay 0 and 1),
    takes the outputs that rank 0 found already written as skipped, and
    runs extract_many(mesh=) on the same batches; rank 0 alone writes the
    .pkl files. Every rank returns the same counts.
    """
    from jegal_torch.parallel import mesh as M

    if mesh is not None and nshard > 1:
        raise ValueError("a mesh runs every rank on the whole CSV: shard it "
                         "by rank / nshard without a mesh")
    rows = read_csv(csv_path)
    if nshard > 1:
        rows = rows[rank::nshard]
    writes = M.is_main(mesh)
    exists = os.path.exists
    if mesh is not None:     # rank 0's view of the outputs, for every rank
        exists = M.broadcast_object({
            p for p in (os.path.join(res_dir, _out_name(r["filename"]))
                        for r in rows) if os.path.exists(p)}
            if writes else None, mesh).__contains__
    if writes:
        os.makedirs(res_dir, exist_ok=True)

    stats = {"done": 0, "skipped": 0, "failed": 0, "invalid": 0}
    errors = []

    def prepare(row):
        out_path = os.path.join(res_dir, _out_name(row["filename"]))
        if exists(out_path):
            return ("skip", out_path, None, None)
        try:
            return ("ok", out_path, load_sample(row, video_dir, feature_dir,
                                                modalities), row)
        except Exception as e:  # ledger, not silence
            return ("err", out_path, str(e), row)

    def save(feats, row, out_path):
        feats["info"] = dict(row)  # full CSV row (phrase, boundaries,
        # target_word_boundary, neg_files, ...) — needed by the evals
        if writes:
            with open(out_path, "wb") as f:
                pickle.dump(feats, f)
        stats["done"] += 1

    pending = []  # (payload, row, out_path) accumulated for a device batch

    def flush():
        if not pending:
            return
        results = engine.extract_many([p for p, _, _ in pending],
                                      modalities=modalities,
                                      batch_size=batch_size, mesh=mesh)
        for feats, (_, row, out_path) in zip(results, pending):
            if feats is None:
                stats["invalid"] += 1
            else:
                save(feats, row, out_path)
        pending.clear()

    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = [pool.submit(prepare, r) for r in rows[:prefetch]]
        idx = prefetch
        for i in range(len(rows)):
            status, out_path, payload, row = futures[i].result()
            if idx < len(rows):
                futures.append(pool.submit(prepare, rows[idx]))
                idx += 1
            if status == "skip":
                stats["skipped"] += 1
                continue
            if status == "err":
                stats["failed"] += 1
                errors.append({"file": str(row["filename"]), "error": payload})
                continue
            if batch_size <= 1 and mesh is None:
                try:
                    feats = engine.extract(**payload)
                except ClientError as e:
                    # malformed row data (engine-validated): ledger it and
                    # keep the corpus run going, matching extract_many's
                    # None-for-invalid batch contract
                    stats["failed"] += 1
                    errors.append({"file": str(row["filename"]),
                                   "error": str(e)})
                    continue
                if feats is None:
                    stats["invalid"] += 1
                else:
                    save(feats, row, out_path)
            else:
                payload.pop("modalities", None)
                pending.append((payload, row, out_path))
                # accumulate several batches before flushing: extract_many
                # groups by shape signature, so a wider window packs ragged
                # rows into full same-signature chunks. The window stages
                # whole payloads, so it is capped at 256 rows (or one
                # batch, if larger), which also bounds the rows a crash
                # leaves for the idempotent restart to redo.
                if len(pending) >= max(batch_size, min(batch_size * 8, 256)):
                    flush()
        flush()

    if writes:
        for e in errors:
            print(json.dumps(e), file=sys.stderr)
    return stats

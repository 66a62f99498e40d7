"""The port's command-line drivers: `python -m jegal_torch <subcommand>`,
every subcommand of the JAX package's cli/main.py with its flags and names.

  infer           <- inference_embs.py       (single sample, 7 modality combos)
  extract-feats   <- preprocess/extract_gestsync_feats.py  (CSV -> .npy bank)
  extract-embs    <- evaluation/extract_jegal_embs.py      (CSV -> .pkl dir)
  eval-retrieval  <- evaluation/evaluate_retrieval.py
  eval-spotting   <- evaluation/evaluate_spotting.py
  eval-asd        <- evaluation/evaluate_asd.py
  heatmap         <- utils/plot_heatmap.py
  preprocess      <- preprocess/inference_preprocess.py + dataset/
                     preprocess_videos.py (single video or CSV batch)
  download        <- dataset/download_videos.py            (yt-dlp, gated)
  extract-kps     <- preprocess/extract_kps.py             (MediaPipe, gated)
  verify          one-command verification against goldens (verify.py)
  warmup          capture the engine's graphs ahead of traffic
  serve           HTTP endpoint over the engine's captured graphs (serving.py)
  convert         torch .pth / HF -> .npz (both packages read the files)
  transcribe      <- utils/extract_transcripts_whisperx.py (pluggable ASR)
  train           contrastive JEGAL training (training/loop.py)

The host subcommands (preprocess, download, extract-kps, transcribe) run
no model and read their CSVs with the stdlib, typed as pandas types them
(data/datasets.read_csv). One flag the JAX CLI lacks: `--device` (default
`cuda`) on every subcommand that computes on a device; `--device cpu` runs
the port's plain CPU path (the JAX CLI takes that choice from
JAX_PLATFORMS). Without a card a `cuda` run raises: nothing falls back to
the CPU. `--bf16` (infer, extract-feats, extract-embs, verify, warmup,
serve) builds the bf16 engine (`JegalEngine(dtype=torch.bfloat16)`), as the
JAX CLI's `--bf16` does; the outputs stay float32 rows. `train` launched
as several ranks (`torchrun --nproc_per_node N -m jegal_torch train
--model_parallel M ...`, WORLD_SIZE > 1) joins the process group
(NCCL on the card, gloo with `--device cpu`) and trains on the (N / M, M)
mesh (training/loop.py).

Data-parallel inference, one rank a card as `torchrun` starts them
(WORLD_SIZE > 1): `extract-feats --data_parallel`, `serve
--data_parallel` (with `--batch_window_ms` > 0), `extract-embs
--batch_size` > 1 and `eval-* --on_device` join the process group the
same way and run their engine calls collectively on the (N, 1) mesh
(`_data_mesh`, the JAX CLI's all-devices mesh): every rank takes the same
inputs, computes its rows of each batch, and rank 0 alone writes the
files and prints. On one process the mesh is None, as the JAX CLI's on
one device. Explicit `--rank` / `--nshard` conflict with a data mesh and
exit; without `--data_parallel`, a launch of several ranks shards
extract-feats' files by rank (RANK and WORLD_SIZE) instead.

The JAX CLI's persistent XLA compilation cache (`setup_compilation_cache`)
has no counterpart here: the port compiles its CUDA kernels once into
build/jegal_torch_kernels/ and its decoder and repack into
build/jegal_torch_host/, each named by a digest of its source, and later
processes load them.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import threading

COMBOS = ["vta", "vt", "va", "ta", "v", "t", "a"]
BF16_HELP = "bfloat16 compute: the engine's bf16 kernels"
# a collective that waits longer for a peer fails, and the run with it
MESH_TIMEOUT = datetime.timedelta(seconds=600)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default: the card; "
                        "'cpu' for the plain CPU path)")


def _add_shard(p):
    p.add_argument("--rank", type=int, default=None,
                   help="file-shard index (default: torch.distributed's "
                        "rank when it is initialized, else the launcher's "
                        "RANK, else 0)")
    p.add_argument("--nshard", type=int, default=None,
                   help="file-shard count (default: torch.distributed's "
                        "world size when it is initialized, else the "
                        "launcher's WORLD_SIZE, else 1)")


def _add_infer(sub):
    p = sub.add_parser("infer", help="extract JEGAL embeddings for one sample")
    p.add_argument("--checkpoint_path_gestsync", type=str, default=None)
    p.add_argument("--checkpoint_path_jegal", type=str, required=True)
    p.add_argument("--roberta_path", type=str, default=None,
                   help="HF xlm-roberta-base checkpoint (dir/.bin/.safetensors) or .npz")
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="tokenizers-format tokenizer.json (xlm-roberta-base)")
    p.add_argument("--modalities", type=str, default="vta", choices=COMBOS)
    p.add_argument("--video_path", type=str, default=None)
    p.add_argument("--text_path", type=str, default=None)
    p.add_argument("--audio_path", type=str, default=None)
    p.add_argument("--res_dir", type=str, default="results")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    p.add_argument("--fusion_strategy", default="concat",
                   choices=["concat", "avg"])
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (Chrome trace JSON) "
                        "of the extraction into this directory")
    _add_device(p)


def _add_common_eval(sub, name, help_):
    p = sub.add_parser(name, help=help_)
    p.add_argument("--path", type=str, required=True,
                   help="directory of extracted .pkl embeddings")
    return p


def build_parser():
    ap = argparse.ArgumentParser(
        prog="jegal_torch", description="JEGAL on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    _add_infer(sub)

    p = sub.add_parser("extract-feats",
                       help="GestSync visual features for a CSV of videos")
    p.add_argument("--file_path", required=True, help="CSV with filename column")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--res_dir", required=True)
    p.add_argument("--checkpoint_path", required=True)
    _add_shard(p)
    p.add_argument("--batch_size", type=int, default=1,
                   help=">1 stacks same-length clips into one batched "
                        "GestSync tower call")
    p.add_argument("--decode_workers", type=int, default=4,
                   help="parallel C++ decode threads feeding the device "
                        "loop (the ctypes call releases the GIL, so "
                        "threads scale)")
    p.add_argument("--data_parallel", action="store_true",
                   help="launched as several ranks (torchrun), run each "
                        "tower batch over all of them ('data' mesh axis, "
                        "one rank a card) — pair with --batch_size >= "
                        "the ranks")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    _add_device(p)

    p = sub.add_parser("extract-embs",
                       help="JEGAL embeddings for a CSV (batch)")
    p.add_argument("--file_path", required=True)
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--roberta_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--res_dir", required=True)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--feature_dir", required=True)
    p.add_argument("--modalities", default="vta", choices=COMBOS)
    _add_shard(p)
    p.add_argument("--batch_size", type=int, default=1,
                   help=">1 groups samples into device batches (over "
                        "every rank's card when launched as several "
                        "ranks)")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    _add_device(p)

    p = _add_common_eval(sub, "eval-retrieval", "AVS-Ret cross-modal retrieval")
    p.add_argument("--on_device", action="store_true",
                   help="similarity and rank math on the device")
    _add_device(p)

    p = _add_common_eval(sub, "eval-spotting", "AVS-Spot word spotting")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--frame_threshold", type=int, default=9)
    p.add_argument("--on_device", action="store_true",
                   help="attention and argmax math on the device")
    _add_device(p)

    p = _add_common_eval(sub, "eval-asd", "AVS-Asd active speaker detection")
    p.add_argument("--file", type=str, required=True, help="AVS-Asd CSV")
    p.add_argument("--on_device", action="store_true",
                   help="candidate scoring on the device")
    _add_device(p)

    p = sub.add_parser("heatmap", help="word-frame attention heatmap")
    p.add_argument("--path", required=True, help=".pkl embedding file")
    p.add_argument("--fname", default="heatmap")

    p = sub.add_parser("preprocess",
                       help="speaker detect/track/crop raw video(s)")
    p.add_argument("--video_file", default=None,
                   help="single video (reference inference_preprocess.py)")
    p.add_argument("--file_path", default=None,
                   help="CSV of videos (reference dataset/preprocess_videos.py)")
    p.add_argument("--video_root", default=None,
                   help="directory of downloaded videos (CSV mode)")
    p.add_argument("--preprocessed_root", required=True)
    p.add_argument("--merge_dir", default=None,
                   help="also write merged <fname>_%%05d.mp4 (crop video + "
                        "audio muxed, reference preprocess_videos.py "
                        "filter_and_merge)")
    p.add_argument("--final_dir", default=None,
                   help="with --filter_csv: copy the CSV-selected crop "
                        ".avi/.wav files from --preprocessed_root into this "
                        "final tree (reference preprocess_videos.py "
                        "filter_and_merge rsync stage)")
    p.add_argument("--filter_csv", default=None,
                   help="CSV with a 'filename' column of relative crop "
                        "paths surviving filtering")
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--sample_rate", type=int, default=16000)
    _add_shard(p)

    p = sub.add_parser("download",
                       help="download dataset clips from a CSV (yt-dlp)")
    p.add_argument("--file", required=True, help="AVS csv")
    p.add_argument("--video_root", required=True)
    p.add_argument("--workers", type=int, default=8)

    p = sub.add_parser("extract-kps",
                       help="MediaPipe Holistic keypoints for a CSV of videos")
    p.add_argument("--file_path", required=True)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--res_dir", required=True)
    _add_shard(p)

    p = sub.add_parser("verify",
                       help="one-command real-weight verification: extract "
                            "the demo samples under every combo, diff "
                            "against reference goldens, smoke the evals")
    p.add_argument("--checkpoint_path_jegal", required=True)
    p.add_argument("--checkpoint_path_gestsync", default=None)
    p.add_argument("--roberta_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--samples_dir", required=True,
                   help="directory with sample{1,2}.{avi,wav,txt} "
                        "(the reference repo's samples/)")
    p.add_argument("--golden_dir", default=None,
                   help="reference-generated .pkl goldens "
                        "(<sample>_<combo>.pkl); omit to only check "
                        "schema/shapes")
    p.add_argument("--res_dir", default="verify_out")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="per-row cosine must exceed 1 - tolerance")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    _add_device(p)

    p = sub.add_parser("warmup",
                       help="capture the engine's graphs ahead of traffic")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--roberta_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--checkpoint_path_gestsync", default=None)
    p.add_argument("--all_combos", action="store_true",
                   help="warm every modality combo (default: only --modalities)")
    p.add_argument("--modalities", default="vta", choices=COMBOS)
    p.add_argument("--t_buckets", type=int, nargs="+", default=[128])
    p.add_argument("--s_buckets", type=int, nargs="+", default=[64])
    p.add_argument("--w_buckets", type=int, nargs="+", default=[16])
    p.add_argument("--mel_buckets", type=int, nargs="+", default=[512])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    _add_device(p)

    p = sub.add_parser("serve",
                       help="HTTP serving endpoint over the engine "
                            "(JSON + base64-npy tensors, or binary)")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--roberta_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--checkpoint_path_gestsync", default=None)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; the endpoint has no auth — expose "
                        "beyond loopback only behind a proxy/auth layer")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds a free port (printed on the first line)")
    p.add_argument("--warmup_combos", default="",
                   help="comma-separated combos whose graphs are captured "
                        "before accepting traffic, e.g. vta,ta,a")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help=">0 batches concurrent requests into one engine "
                        "call (adds up to this much latency)")
    p.add_argument("--max_batch", type=int, default=16,
                   help="batcher call size: every batched call is padded "
                        "to it, the one batch size warmed")
    p.add_argument("--warmup_frames", default=None,
                   choices=["planar", "raw"],
                   help="also capture the fused frames->embeddings graph "
                        "for this input kind (the server repacks raw-frames "
                        "requests on the host, so they run the planar graph)")
    p.add_argument("--max_body_mb", type=int, default=512,
                   help="reject request bodies larger than this (HTTP 413)")
    p.add_argument("--data_parallel", action="store_true",
                   help="launched as several ranks (torchrun), run each "
                        "batched call over all of them (needs "
                        "--batch_window_ms > 0); rank 0 serves")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    _add_device(p)

    p = sub.add_parser("convert", help="convert checkpoints to .npz")
    p.add_argument("--model", required=True,
                   choices=["gestsync", "jegal", "roberta"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)

    p = sub.add_parser("transcribe",
                       help="word-boundary transcription (pluggable ASR)")
    p.add_argument("--audio_path", default=None,
                   help="single audio file (reference inference_embs.py)")
    p.add_argument("--path", default=None,
                   help="folder of audio files — batch mode with resume "
                        "(reference utils/extract_transcripts_whisperx.py)")
    p.add_argument("--res_dir", default="results")
    p.add_argument("--batch_size", type=int, default=8)

    p = sub.add_parser("train", help="contrastive JEGAL training")
    p.add_argument("--file_path", required=True,
                   help="CSV with filename,text_path,audio_path columns")
    p.add_argument("--feature_dir", required=True,
                   help="GestSync feature bank (.npy per clip)")
    p.add_argument("--checkpoint_path", default=None,
                   help="initial JEGAL weights (.pth/.npz); random init if absent")
    p.add_argument("--roberta_path", required=True)
    p.add_argument("--tokenizer_path", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps")
    p.add_argument("--cosine_decay", action="store_true",
                   help="cosine-decay the LR to 0 over --steps")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation micro-steps per update")
    p.add_argument("--remat", action="store_true",
                   help="recompute branch forwards in the backward pass")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--log_path", default=None)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks a model group splits heads and FFN width "
                        "over, when launched as several ranks (ignored "
                        "on one)")
    p.add_argument("--seed", type=int, default=0)
    _add_device(p)

    return ap


def _dtype(args):
    """The engine dtype of a subcommand: bf16 with --bf16, else float32."""
    import torch

    return torch.bfloat16 if getattr(args, "bf16", False) else torch.float32


def _load_engine(args, need_gestsync=False):
    from jegal_torch.api import JegalEngine
    from jegal_torch.convert import checkpoints as C

    jegal_params = C.load_jegal(
        getattr(args, "checkpoint_path_jegal", None) or args.checkpoint_path)
    roberta_params = None
    roberta_cfg = None
    if getattr(args, "roberta_path", None):
        roberta_params, roberta_cfg = C.load_roberta(args.roberta_path)
    gestsync_params = None
    gs_path = getattr(args, "checkpoint_path_gestsync", None)
    if gs_path:
        gestsync_params = C.load_gestsync(gs_path)
    elif need_gestsync:
        raise SystemExit("--checkpoint_path_gestsync is required for modality 'v'")
    tokenizer = None
    if getattr(args, "tokenizer_path", None):
        from jegal_torch.text.tokenizer import WordTokenizer

        tokenizer = WordTokenizer.from_file(args.tokenizer_path)
    kw = {"fusion_strategy": getattr(args, "fusion_strategy", "concat"),
          "dtype": _dtype(args)}
    if roberta_cfg is not None:
        kw["roberta_cfg"] = roberta_cfg
    return JegalEngine(
        jegal_params=jegal_params,
        roberta_params=roberta_params,
        gestsync_params=gestsync_params,
        tokenizer=tokenizer,
        device=args.device,
        **kw,
    )


def cmd_infer(args):
    import contextlib

    from jegal_torch.text.normalize import load_text

    profile_ctx = contextlib.nullcontext()
    if args.profile_dir:
        from jegal_torch.utils.profiling import trace

        profile_ctx = trace(args.profile_dir)

    # modality-specific input validation (reference inference_embs.py:649-667)
    if "v" in args.modalities and args.video_path is None:
        raise SystemExit("--video_path must be specified for modality 'v'")
    if "a" in args.modalities and args.audio_path is None:
        raise SystemExit("--audio_path must be specified for modality 'a'")
    if "t" in args.modalities and args.text_path is None and args.audio_path is None:
        raise SystemExit("for modality 't', specify --text_path or --audio_path "
                         "(text can be transcribed from audio)")

    engine = _load_engine(args, need_gestsync="v" in args.modalities)

    text = word_boundaries = wav = frames = chin_rows = None
    fname = None

    if "v" in args.modalities:
        # decode (+ keypoints) and the planar repack on the host; the mask,
        # the GestSync tower and the JEGAL forward then run as one graph
        # in engine.extract(frames=...), the (T, 1024) features never
        # leaving the device (reference inference_embs.py:526-646 makes
        # two model calls)
        decoded = _decode_for_features(args.video_path)
        if decoded is None:
            print("The gestures in the input video are not visible! "
                  "Please give a video with visible gestures as input.")
            sys.exit(0)
        frames, chin_rows = decoded
        print(f"Input video frames (decoder-repacked s2d): {frames.shape}")
        fname = os.path.basename(args.video_path).split(".")[0]

    # the reference loads the transcript whenever --text_path is given —
    # audio-only combos still take their word boundaries from it
    # (inference_embs.py:573-604 nulls `text` only after loading)
    if args.text_path is not None:
        text, wbs = load_text(args.text_path)
        word_boundaries = wbs
        if "t" in args.modalities:
            fname = fname or os.path.basename(args.text_path).split(".")[0]

    if "a" in args.modalities:
        from jegal_torch.host.media import load_audio_any

        wav = load_audio_any(args.audio_path)
        fname = fname or os.path.basename(args.audio_path).split(".")[0]

    # transcribe whenever word boundaries are still needed and audio is
    # available — including 't'-only runs with just --audio_path (the
    # reference's documented contract, inference_embs.py:663-667); 'v'-only
    # runs never need boundaries
    needs_boundaries = "t" in args.modalities or "a" in args.modalities
    if needs_boundaries and word_boundaries is None and args.audio_path is not None:
        print("Getting word boundaries via ASR backend...")
        tf = _transcribe(args.audio_path, args.res_dir)
        text, word_boundaries = load_text(tf)
        fname = fname or os.path.basename(args.audio_path).split(".")[0]

    if "t" not in args.modalities:
        text = None

    with profile_ctx:
        out = engine.extract_to_pkl(
            args.res_dir,
            modalities=args.modalities,
            frames=frames,
            chin_rows=chin_rows,
            text=text,
            word_boundaries=word_boundaries,
            wav=wav,
            fname=fname,
        )
    if out is None:
        raise SystemExit("sample rejected (invalid words/tokenization)")
    print(f"Saved the embeddings: {out}")


def _try_keypoints(frames):
    """Holistic keypoints if a backend is installed; None -> fallback mask."""
    try:
        from jegal_torch.host.keypoints import extract_keypoints

        return extract_keypoints(frames)
    except (ImportError, RuntimeError) as e:
        print(f"[warn] no keypoint backend ({e}); using fallback top-strip mask")
        return None


def _decode_for_features(video_path, planar: bool = True):
    """Host-side half of the feature path: decode -> (keypoints) -> chin
    lines -> C++ s2d repack+mask. Runs on a decode thread in the batch
    driver (no device work).

    planar=True (default): -> (planar_u8 (T, 90, 27, 160), None), repacked
    AND face-masked in C++ (host.media.s2d_repack), the stem's layout.
    planar=False: -> (frames_u8 (T, 270, 480, 3), chin_rows | None) for the
    engine's on-device mask (the same features). Returns None when the
    gesture-visibility gate rejects the video (reference
    inference_embs.py:195-233)."""
    import numpy as np

    from jegal_torch.host import masking, media

    keypoints = None
    chin_rows = None
    try:
        import mediapipe  # noqa: F401 -- probe before decoding full-res

        frames_full, _ = media.decode_video(video_path, target_fps=0.0)
        keypoints = _try_keypoints(frames_full)
        if not masking.check_visible_gestures(keypoints):
            return None
        if keypoints is not None:
            from jegal_torch.ops.video import chin_lines

            chin_rows = chin_lines(keypoints, frames_full.shape[1:3])
    except ImportError:
        pass

    frames, _ = media.decode_video(video_path, target_w=480, target_h=270,
                                   target_fps=0.0)
    if not planar:
        return frames, chin_rows
    from jegal_torch.ops.video import FALLBACK_ROWS

    cuts = (np.asarray(chin_rows, np.int32) if chin_rows is not None
            else np.full((frames.shape[0],), FALLBACK_ROWS, np.int32))
    return media.s2d_repack(frames, cuts), None


def _transcribe(audio_path, res_dir):
    from jegal_torch.host.transcribe import transcribe_to_file

    return transcribe_to_file(audio_path, res_dir)


def _resolve_shard(args):
    """--rank/--nshard default to torch.distributed's rank and world size
    when a process group is initialized, else to the launcher's RANK and
    WORLD_SIZE, so that each process of a distributed launch takes its own
    file shard; standalone runs resolve to 0/1 (parallel/mesh.
    resolve_shard). Explicit flags always win (the reference's manual
    --rank/--nshard launch style, extract_kps.py:23-26)."""
    import torch.distributed as dist

    from jegal_torch.parallel.mesh import resolve_shard

    rank, nshard = args.rank, args.nshard
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        nshard = int(os.environ["WORLD_SIZE"]) if nshard is None else nshard
    return resolve_shard(rank, nshard)


@contextlib.contextmanager
def _data_mesh(args, wanted: bool = True):
    """The data-parallel mesh of a subcommand (the JAX CLI's _data_mesh):
    launched as several ranks (WORLD_SIZE > 1) and `wanted`, this process
    joins the process group as `train` does (NCCL on the card, gloo with
    --device cpu; MESH_TIMEOUT) and gets the (ranks, 1) mesh, leaving the
    group after; else None, one rank, as the JAX CLI on one device. Under
    a mesh every rank must take the same inputs, so an explicit --rank /
    --nshard exits."""
    if not wanted or int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        yield None
        return
    if getattr(args, "rank", None) is not None \
            or getattr(args, "nshard", None) is not None:
        raise SystemExit(f"{args.cmd}: --rank / --nshard conflict with the "
                         f"data mesh, whose ranks take the same files in "
                         f"one collective call; drop them (a launch without "
                         f"the mesh shards files by rank)")
    import torch.distributed as dist

    from jegal_torch.parallel import mesh as M

    joins = not dist.is_initialized()
    if joins:
        M.initialize_distributed(device=args.device, timeout=MESH_TIMEOUT)
    try:
        yield M.make_mesh(dist.get_world_size(), 1)
    finally:
        if joins:
            dist.destroy_process_group()


_decode_thread = threading.local()    # a decode thread's upload stream


def _upload(frames, device):
    """Start a decoded clip's copy to the card from this (decode) thread:
    pinned memory, a side stream of the thread's own, and an event the
    compute thread waits on before it reads the tensor. -> (uint8 tensor on
    the card, the copy's event)."""
    import torch

    stream = getattr(_decode_thread, "stream", None)
    if stream is None:
        stream = _decode_thread.stream = torch.cuda.Stream(device)
    host = torch.from_numpy(frames).pin_memory()
    with torch.cuda.stream(stream):
        dev = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return dev, done


def cmd_extract_feats(args):
    """GestSync feature bank builder with host/device pipelining: a pool of
    decode threads feeds a bounded queue while the card runs the batched
    tower (same-bucket clips share one call —
    engine.gestsync_features_from_raw_many). The reference's counterpart
    is the strictly serial extract_gestsync_feats.py:273-351 loop.

    --data_parallel under several ranks: rank 0 lists the pending files
    and broadcasts the list, every rank decodes all of it in order (the
    feeder delivers in submission order, so every rank forms the same
    batches) into host arrays, and the tower calls are collective
    (mesh=); rank 0 alone saves and prints."""
    with _data_mesh(args, args.data_parallel) as mesh:
        _extract_feats(args, mesh)


def _extract_feats(args, mesh):
    import queue

    import numpy as np
    import torch

    from jegal_torch.api import JegalEngine
    from jegal_torch.convert import checkpoints as C
    from jegal_torch.data.datasets import read_csv
    from jegal_torch.parallel import mesh as M
    from jegal_torch.serving import on_engine_device

    main = M.is_main(mesh)
    rank, nshard = (0, 1) if mesh is not None else _resolve_shard(args)
    files = [r["filename"] for r in read_csv(args.file_path)]
    files = files[rank::nshard] if nshard > 1 else files
    engine = JegalEngine(
        jegal_params=None,
        gestsync_params=C.load_gestsync(args.checkpoint_path),
        device=args.device,
        dtype=_dtype(args),
    )
    # under a mesh decoded clips stay host arrays: each rank uploads only
    # its rows of a batch
    on_card = engine.device.type == "cuda" and mesh is None
    stats = {"done": 0, "skipped": 0, "failed": 0}

    pending = []
    if main:
        os.makedirs(args.res_dir, exist_ok=True)
        for f in files:
            out = os.path.join(args.res_dir, f + ".npy")
            if os.path.exists(out):  # idempotent file-level resume
                stats["skipped"] += 1
            else:
                pending.append((f, out))
    pending, stats = M.broadcast_object((pending, stats), mesh)

    q: queue.Queue = queue.Queue(maxsize=max(2, args.batch_size))
    workers = max(1, args.decode_workers)

    def _decode_and_put(video):
        """Decode (+ repack and mask) on this worker thread, then start the
        clip's upload to the card HERE, so that uploads overlap the decode
        of the next clips and the tower of the previous batch. -> (frames,
        the upload's event or None, chin_rows) or None."""
        decoded = _decode_for_features(video)
        if decoded is None:
            return None
        frames, chin = decoded
        if not on_card:
            return frames, None, chin
        return (*_upload(frames, engine.device), chin)

    def feeder():
        """Decode on a worker pool, deliver in submission order through the
        bounded queue (q.put blocks, so the clips in flight are capped at
        the queue's size plus the pool's)."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs: collections.deque = collections.deque()
            it = iter(pending)

            def submit_next():
                try:
                    f, out = next(it)
                except StopIteration:
                    return
                video = os.path.join(args.video_dir, f + ".avi")
                futs.append((f, out, ex.submit(_decode_and_put, video)))

            for _ in range(workers + 1):
                submit_next()
            while futs:
                f, out, fut = futs.popleft()
                try:
                    q.put((f, out, fut.result(), None))
                except Exception as e:
                    q.put((f, out, None, e))
                submit_next()
        q.put(None)

    threading.Thread(target=feeder, daemon=True).start()

    batch: list = []

    def save_one(f, out, feat):
        if main:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            np.save(out, feat)
        stats["done"] += 1

    def ledger(f, msg):
        stats["failed"] += 1
        if main:
            print(json.dumps({"file": f, "error": msg}), file=sys.stderr)

    # one engine call in flight on a worker thread: the tower of batch k
    # overlaps the decode pool AND the np.save of batch k-1
    from concurrent.futures import ThreadPoolExecutor

    compute_pool = ThreadPoolExecutor(max_workers=1)
    inflight: list = []  # [(batch_items, future)] -- at most 1 entry

    def compute(items):
        """Runs ONLY on the single-worker pool thread: the engine's caches
        are not lock-protected, so every engine call (batched AND the
        per-clip fallback that keeps one bad clip from sinking its
        batchmates) stays on this one thread, on the engine's card. Each
        clip's upload is waited for on this thread's stream first. Errors
        come back as (feats, error_records) so the main thread only saves
        and prints."""
        with on_engine_device(engine):
            return _compute(items)

    def _compute(items):
        clips = []
        for _, _, (fr, done, chin) in items:
            if done is not None:
                stream = torch.cuda.current_stream(engine.device)
                stream.wait_event(done)
                fr.record_stream(stream)    # allocated on the side stream
            clips.append((fr, chin))
        errors = []
        try:
            feats = engine.gestsync_features_from_raw_many(
                clips, batch_size=args.batch_size, mesh=mesh)
        except M.CollectiveError:
            raise
        except Exception:
            feats = []
            for (f, _, _), (fr, chin) in zip(items, clips):
                try:
                    feats.append(engine.gestsync_features(fr, chin))
                except Exception as e:
                    feats.append(None)
                    errors.append((f, str(e)))
        return feats, errors

    def drain():
        """Save the results of the previous in-flight batch, with
        per-file error capture — a failed np.save must not trigger
        recompute or double-count clips that already saved."""
        if not inflight:
            return
        items, fut = inflight.pop(0)
        feats, errors = fut.result()
        for f, msg in errors:
            ledger(f, msg)
        for (f, out, _), feat in zip(items, feats):
            if feat is None:
                continue
            try:
                save_one(f, out, feat)
            except Exception as e:
                ledger(f, str(e))

    def flush():
        if not batch:
            return
        items = batch[:]
        batch.clear()
        fut = compute_pool.submit(compute, items)
        drain()  # save the PREVIOUS batch while this one computes
        inflight.append((items, fut))

    while True:
        item = q.get()
        if item is None:
            break
        f, out, decoded, err = item
        if err is not None:  # structured error ledger, not silent skip
            ledger(f, str(err))
            continue
        if decoded is None:  # gesture-visibility gate rejected the video
            ledger(f, "gestures not visible")
            continue
        batch.append((f, out, decoded))
        if len(batch) >= args.batch_size:
            flush()
    flush()
    drain()
    compute_pool.shutdown(wait=True)
    if main:
        print(json.dumps(stats))


def cmd_extract_embs(args):
    """With --batch_size > 1 under several ranks, extract_many runs on the
    data mesh (every rank the whole CSV; rank 0 writes and prints); else
    each rank takes its file shard, as the JAX CLI's extract-embs."""
    from jegal_torch.data.datasets import extract_embeddings_csv
    from jegal_torch.parallel import mesh as M

    with _data_mesh(args, args.batch_size > 1) as mesh:
        rank, nshard = (0, 1) if mesh is not None else _resolve_shard(args)
        engine = _load_engine(args)
        stats = extract_embeddings_csv(
            engine,
            csv_path=args.file_path,
            video_dir=args.video_dir,
            feature_dir=args.feature_dir,
            res_dir=os.path.join(args.res_dir, args.modalities),
            modalities=args.modalities,
            rank=rank,
            nshard=nshard,
            batch_size=args.batch_size,
            mesh=mesh,
        )
        if M.is_main(mesh):
            print(json.dumps(stats))


def _device_eval(args, run, host):
    """An eval subcommand: `run(mesh)` on the device with --on_device (on
    the data mesh under several ranks, rank 0 printing), else `host()`."""
    from jegal_torch.parallel import mesh as M

    if not args.on_device:
        print(json.dumps(host(), indent=2))
        return
    with _data_mesh(args) as mesh:
        res = run(mesh)
        if M.is_main(mesh):
            print(json.dumps(res, indent=2))


def cmd_eval_retrieval(args):
    from jegal_torch.eval import retrieval

    _device_eval(args, lambda mesh: retrieval.evaluate_device(
        args.path, device=args.device, mesh=mesh),
        lambda: retrieval.evaluate(args.path))


def cmd_eval_spotting(args):
    from jegal_torch.eval import spotting

    _device_eval(args, lambda mesh: spotting.evaluate_device(
        args.path, args.threshold, args.frame_threshold, device=args.device,
        mesh=mesh), lambda: spotting.evaluate(args.path, args.threshold,
                                              args.frame_threshold))


class Rows:
    """A CSV's rows as the ASD eval reads a table: `iterrows()` of (index,
    row)."""

    def __init__(self, rows: list):
        self.rows = rows

    def iterrows(self):
        return enumerate(self.rows)


def cmd_eval_asd(args):
    from jegal_torch.data.datasets import read_csv
    from jegal_torch.eval import asd

    table = Rows(read_csv(args.file))
    _device_eval(args, lambda mesh: asd.evaluate_device(
        args.path, table, device=args.device, mesh=mesh),
        lambda: asd.evaluate(args.path, table))


def cmd_heatmap(args):
    from jegal_torch.eval import heatmap

    out = heatmap.plot_from_pkl(args.path, fname=args.fname)
    print(json.dumps({"saved": out}))


def cmd_preprocess(args):
    from jegal_torch.host.preprocess import filter_copy, process_video

    if args.final_dir or args.filter_csv:
        # standalone filter/copy stage (no decoding)
        if not (args.final_dir and args.filter_csv):
            raise SystemExit("--final_dir and --filter_csv go together")
        stats = filter_copy(args.filter_csv, args.preprocessed_root,
                            args.final_dir)
        print(json.dumps(stats))
        return
    if bool(args.video_file) == bool(args.file_path):
        raise SystemExit("specify exactly one of --video_file / --file_path")
    if args.video_file:
        result = process_video(args.video_file, args.preprocessed_root,
                               fps=args.fps, sample_rate=args.sample_rate,
                               merge_dir=args.merge_dir)
        print(json.dumps(result))
        return
    # CSV batch mode (reference dataset/preprocess_videos.py); the row's
    # values typed as pandas types them, so a float column formats as 1.0
    from jegal_torch.data.datasets import read_csv

    rank, nshard = _resolve_shard(args)
    rows = read_csv(args.file_path)
    if nshard > 1:
        rows = rows[rank::nshard]
    stats = {"done": 0, "failed": 0}
    for row in rows:
        vid = f"{row['video_id']}_{row['start_time']}_{row['end_time']}.mp4"
        path = os.path.join(args.video_root or "", vid)
        try:
            process_video(path, args.preprocessed_root, fps=args.fps,
                          sample_rate=args.sample_rate,
                          merge_dir=args.merge_dir)
            stats["done"] += 1
        except Exception as e:
            stats["failed"] += 1
            print(json.dumps({"file": vid, "error": str(e)}), file=sys.stderr)
    print(json.dumps(stats))


def cmd_download(args):
    from jegal_torch.data.download import download_dataset

    print(json.dumps(download_dataset(args.file, args.video_root,
                                      args.workers)))


def cmd_extract_kps(args):
    from jegal_torch.data.datasets import read_csv
    from jegal_torch.host import keypoints, media

    rank, nshard = _resolve_shard(args)
    files = [r["filename"] for r in read_csv(args.file_path)]
    if nshard > 1:
        files = files[rank::nshard]
    os.makedirs(args.res_dir, exist_ok=True)
    stats = {"done": 0, "skipped": 0, "failed": 0}
    for f in files:
        out = os.path.join(args.res_dir, f + ".pkl")
        if os.path.exists(out):  # idempotent resume (extract_kps.py:150-151)
            stats["skipped"] += 1
            continue
        try:
            frames, _ = media.decode_video(
                os.path.join(args.video_dir, f + ".avi"))
            kps = keypoints.extract_keypoints(frames)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            keypoints.save_keypoints(kps, frames.shape[1:], out)
            stats["done"] += 1
        except Exception as e:
            stats["failed"] += 1
            print(json.dumps({"file": f, "error": str(e)}), file=sys.stderr)
    print(json.dumps(stats))


def cmd_verify(args):
    from jegal_torch.verify import run_verification

    engine = _load_engine(args)
    verdict = run_verification(
        engine,
        samples_dir=args.samples_dir,
        res_dir=args.res_dir,
        golden_dir=args.golden_dir,
        tolerance=args.tolerance,
    )
    print(json.dumps(verdict, indent=2))
    if not verdict["ok"]:
        raise SystemExit(1)


def cmd_warmup(args):
    """Capture (combo, bucket) graphs on the engine (on the CPU: run them
    once). Emits the table of seconds as JSON."""
    engine = _load_engine(args)
    combos = tuple(COMBOS) if args.all_combos else (args.modalities,)
    records = engine.warmup_all(
        combos=combos, t_buckets=tuple(args.t_buckets),
        s_buckets=tuple(args.s_buckets), w_buckets=tuple(args.w_buckets),
        mel_buckets=tuple(args.mel_buckets), batch=args.batch_size)
    print(json.dumps({"graphs": records,
                      "total_seconds": round(sum(r["seconds"]
                                                 for r in records), 3)}))


def cmd_serve(args):
    from jegal_torch.serving import serve

    if args.data_parallel and args.batch_window_ms <= 0:
        raise SystemExit(
            "--data_parallel requires --batch_window_ms > 0: requests run "
            "data-parallel only through the cross-request batcher")
    with _data_mesh(args, args.data_parallel) as mesh:
        engine = _load_engine(args)
        combos = [c for c in args.warmup_combos.split(",") if c]
        serve(engine, host=args.host, port=args.port, warmup_combos=combos,
              batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
              mesh=mesh, max_body_bytes=args.max_body_mb * 1024 * 1024,
              warmup_frames=args.warmup_frames)


def cmd_convert(args):
    from jegal_torch.convert import checkpoints as C

    if args.model == "roberta":
        params, cfg = C.load_roberta(args.src)
        C.save_roberta_npz(params, args.dst, cfg.num_heads)
    else:
        loader = {"gestsync": C.load_gestsync, "jegal": C.load_jegal}[args.model]
        C.save_npz(loader(args.src), args.dst)
    print(json.dumps({"saved": args.dst}))


def cmd_transcribe(args):
    if bool(args.audio_path) == bool(args.path):
        raise SystemExit("specify exactly one of --audio_path / --path")
    if args.path:
        from jegal_torch.host.transcribe import transcribe_folder

        print(json.dumps(transcribe_folder(args.path, args.res_dir,
                                           batch_size=args.batch_size)))
        return
    out = _transcribe(args.audio_path, args.res_dir)
    print(json.dumps({"saved": out}))


def cmd_train(args):
    import torch
    import torch.distributed as dist

    from jegal_torch.convert import checkpoints as C
    from jegal_torch.convert import init_jegal_params
    from jegal_torch.parallel import mesh as M
    from jegal_torch.text.tokenizer import WordTokenizer
    from jegal_torch.training.loop import train

    launched = int(os.environ.get("WORLD_SIZE", 1))
    if launched > 1:
        try:
            M.check_mesh_shape(launched, args.model_parallel)
        except ValueError as e:
            raise SystemExit(f"train: {e}") from None
    joins = launched > 1 and not dist.is_initialized()
    if joins:
        M.initialize_distributed(device=args.device)

    if args.checkpoint_path:
        jegal_params = C.load_jegal(args.checkpoint_path)
    else:
        jegal_params = init_jegal_params(
            torch.Generator().manual_seed(args.seed))
    roberta_params, roberta_cfg = C.load_roberta(args.roberta_path)
    result = train(
        csv_path=args.file_path,
        feature_dir=args.feature_dir,
        jegal_params=jegal_params,
        roberta_params=roberta_params,
        roberta_cfg=roberta_cfg,
        tokenizer=WordTokenizer.from_file(args.tokenizer_path),
        steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        cosine_decay=args.cosine_decay,
        accum_steps=args.accum_steps,
        remat=args.remat,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_path=args.log_path,
        seed=args.seed,
        model_parallel=args.model_parallel,
        device=args.device,
    )
    print(json.dumps(result))
    if joins:
        dist.destroy_process_group()


COMMANDS = {
    "infer": cmd_infer,
    "extract-feats": cmd_extract_feats,
    "extract-embs": cmd_extract_embs,
    "eval-retrieval": cmd_eval_retrieval,
    "eval-spotting": cmd_eval_spotting,
    "eval-asd": cmd_eval_asd,
    "heatmap": cmd_heatmap,
    "preprocess": cmd_preprocess,
    "download": cmd_download,
    "extract-kps": cmd_extract_kps,
    "verify": cmd_verify,
    "warmup": cmd_warmup,
    "serve": cmd_serve,
    "convert": cmd_convert,
    "transcribe": cmd_transcribe,
    "train": cmd_train,
}


def main(argv=None):
    args = build_parser().parse_args(argv)
    COMMANDS[args.cmd](args)

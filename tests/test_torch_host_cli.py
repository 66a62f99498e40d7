"""The port's host-only subcommands (`python -m jegal_torch preprocess`,
`download`, `extract-kps`, `transcribe`) and the modules under them
(host/preprocess.py, data/download.py, host/transcribe.transcribe_folder)
against the JAX package's on the CPU, on the same inputs with fake
backends: no detector, keypoint, ASR model or yt-dlp is in the image, so
the tests use a detector that boxes a synthetic video's bright square,
keypoints drawn from each crop's size, a fake ASR backend and a fake
`yt-dlp` script on PATH, each the same for both packages.

Both packages' libav runtimes are copies of one source, so the files they
write decode to the same bytes: tracks and detections equal, every .avi
decoded equal frame for frame, every .wav and keypoint .pkl equal, the
stats each CLI prints equal, and the error ledger's lines too (whose file
names show the CSV's float columns formatted as pandas types them). The
tests that decode or encode skip where `pkg-config libavformat` fails."""

import importlib
import json
import os
import pickle
import shutil
import stat
import subprocess

import numpy as np
import pytest

from jegal_torch.cli import main as TCLI
from jegal_torch.data import download as TDL
from jegal_torch.host import preprocess as TPP
from jegal_torch.host import transcribe as TTR
from jegal_tpu.data import download as JDL
from jegal_tpu.host import preprocess as JPP
from jegal_tpu.host import transcribe as JTR

# the module (jegal_tpu.cli exports its `main` function under that name)
JCLI = importlib.import_module("jegal_tpu.cli.main")


def _have_libav() -> bool:
    if shutil.which("pkg-config") is None or shutil.which("g++") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", "libavformat"]
                          ).returncode == 0


needs_libav = pytest.mark.skipif(not _have_libav(),
                                 reason="no libav headers (pkg-config "
                                        "libavformat fails)")


def fake_detector(frame):
    """The bright square's box, as a person detection."""
    ys, xs = np.where(frame[:, :, 0] > 150)
    if len(xs) == 0:
        return []
    return [(xs.min(), ys.min(), xs.max(), ys.max(), 0.99)]


def fake_pose(crops):
    """(T, 33, 3) pixel-space pose keypoints from each crop's size: arms
    inside the crop's width, hips at 80 % of its height, all visible."""
    t, h, w = crops.shape[:3]
    kps = np.zeros((t, 33, 3))
    kps[:, :, 0] = np.linspace(0.2 * w, 0.8 * w, 33)
    kps[:, :, 1] = 0.5 * h
    kps[:, 23:25, 1] = 0.8 * h
    kps[:, :, 2] = 0.9
    return kps


def synth_frames(t: int = 50, h: int = 240, w: int = 320, drift: int = 1):
    frames = np.full((t, h, w, 3), 64, np.uint8)
    for i in range(t):
        x = 80 + drift * i
        frames[i, 60:200, x:x + 100] = (200, 150, 100)
    return frames


@pytest.fixture(scope="module")
def media():
    if not _have_libav():
        pytest.skip("no libav headers (pkg-config libavformat fails)")
    from jegal_torch.host import media as TMD

    return TMD


@pytest.fixture(scope="module")
def videos(media, tmp_path_factory):
    """Two 2 s speaker videos with a 440 Hz tone muxed in (mpeg4 + AAC),
    named as the AVS CSV names downloads, and one without audio."""
    d = tmp_path_factory.mktemp("speakers")
    tone = (np.sin(2 * np.pi * 440 * np.arange(32000) / 16000)
            * 8000).astype(np.int16)
    paths = {}
    for name, drift in (("spk_1.0_3.5", 1), ("spk2_0.5_2.5", 2)):
        paths[name] = str(d / f"{name}.mp4")
        media.encode_av(paths[name], synth_frames(drift=drift), tone)
    paths["silent"] = str(d / "silent.avi")
    media.encode_video(paths["silent"], synth_frames())
    return paths


def _tree(root, decode: bool = True):
    """{relative path: content} of a directory: .avi / .mp4 decoded to
    frames (with decode), .pkl unpickled, everything else as bytes."""
    from jegal_torch.host import media as TMD

    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if decode and f.endswith((".avi", ".mp4")):
                out[rel] = TMD.decode_video(p)[0]
            elif f.endswith(".pkl"):
                with open(p, "rb") as fh:
                    out[rel] = pickle.load(fh)
            else:
                out[rel] = open(p, "rb").read()
    return out


def assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        _same(got[k], want[k], k)


def _same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ---------------------------------------------------------------------------
# host/preprocess.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boxes", [
    ([0, 0, 10, 10], [0, 0, 10, 10]), ([0, 0, 10, 10], [20, 20, 30, 30]),
    ([0, 0, 10, 10], [5, 5, 15, 15]), ([0, 5, 10, 9], [2, 0, 12, 20])])
def test_iou_matches_jax(boxes):
    """defect 7 fixed in both: the intersection's bottom takes both boxes."""
    assert TPP.iou(*boxes) == JPP.iou(*boxes)
    assert TPP.iou([0, 0, 10, 10], [5, 5, 15, 15]) == pytest.approx(25 / 175)


def test_tracker_and_smoothing_match_jax():
    """Gaps within and past num_failed_det, a short tail, two people, and
    the median-filtered series of each track."""
    rng = np.random.default_rng(4)
    dets = []
    for f in range(90):
        frame = []
        if f < 40 or 50 <= f < 70 or f >= 86:
            b = rng.integers(0, 6, 4)
            frame.append({"frame": f, "bbox": [10 + b[0], 10 + b[1],
                                               110 + b[2], 120 + b[3]],
                          "conf": 0.9})
        if f % 3:
            frame.append({"frame": f, "bbox": [200, 20, 290, 140],
                          "conf": 0.8})
        dets.append(frame)
    got = TPP.track_speakers([list(d) for d in dets])
    want = JPP.track_speakers([list(d) for d in dets])
    _same(got, want, "tracks")
    assert len(got) == 2
    for tg, tw in zip(got, want):
        _same(TPP.smooth_track(tg), JPP.smooth_track(tw), "smooth")


def test_upper_body_crop_and_detect_match_jax():
    frames = synth_frames(t=12)
    _same(TPP.detect_persons(frames, fake_detector),
          JPP.detect_persons(frames, fake_detector), "detections")
    crops = [f for f in frames]
    kps = fake_pose(frames)
    _same(TPP.upper_body_crop(crops, kps), JPP.upper_body_crop(crops, kps),
          "crop")
    assert TPP.upper_body_crop(crops, None) is crops
    with pytest.raises(RuntimeError, match="detector"):
        TPP._default_detector()


@pytest.mark.parametrize("keypoints", [False, True],
                         ids=["no_keypoints", "fake_keypoints"])
@pytest.mark.parametrize("which", ["spk_1.0_3.5", "silent"])
def test_process_video_matches_jax(videos, tmp_path, which, keypoints):
    """The whole L1 stage on a synthetic video: detections, tracks, each
    track's .avi frames and .wav (and the merged .mp4) equal to the JAX
    package's; a video without audio writes crops only."""
    kw = dict(detector=fake_detector,
              keypoint_fn=fake_pose if keypoints else None)
    got = TPP.process_video(videos[which], str(tmp_path / "port"),
                            merge_dir=str(tmp_path / "port_merged"), **kw)
    want = JPP.process_video(videos[which], str(tmp_path / "jax"),
                             merge_dir=str(tmp_path / "jax_merged"), **kw)
    assert got["tracks"] == want["tracks"] == 1
    assert got["dest"].replace("port", "jax") == want["dest"]
    for sub in ("port", "port_merged"):
        if os.path.isdir(tmp_path / sub):
            assert_same_tree(_tree(tmp_path / sub),
                             _tree(tmp_path / sub.replace("port", "jax")))
    files = sorted(os.listdir(got["dest"]))
    assert files == (["00000.avi", "00000.wav", "person.pkl", "tracks.pkl"]
                     if which != "silent"
                     else ["00000.avi", "person.pkl", "tracks.pkl"])


def test_filter_copy_matches_jax(tmp_path, capsys):
    """The filter stage through both CLIs: the CSV-selected .avi/.wav
    copied, missing files counted."""
    initial = tmp_path / "initial"
    (initial / "vid1" / "preprocessed").mkdir(parents=True)
    (initial / "vid1" / "preprocessed" / "00000.avi").write_bytes(b"A")
    (initial / "vid1" / "preprocessed" / "00000.wav").write_bytes(b"W")
    (initial / "vid3" / "preprocessed").mkdir(parents=True)
    (initial / "vid3" / "preprocessed" / "00002.avi").write_bytes(b"C")
    csv_path = tmp_path / "filtered.csv"
    csv_path.write_text("filename\nvid1/preprocessed/00000\n"
                        "vid2/preprocessed/00001\nvid3/preprocessed/00002\n")
    out = {}
    for name, cli in (("port", TCLI.main), ("jax", JCLI.main)):
        cli(["preprocess", "--preprocessed_root", str(initial),
             "--final_dir", str(tmp_path / name), "--filter_csv",
             str(csv_path)])
        out[name] = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out["port"]) == json.loads(out["jax"]) == {
        "copied": 3, "missing": 3}
    assert_same_tree(_tree(tmp_path / "port", decode=False),
                     _tree(tmp_path / "jax", decode=False))
    with pytest.raises(SystemExit, match="go together"):
        TCLI.main(["preprocess", "--preprocessed_root", str(initial),
                   "--final_dir", str(tmp_path / "x")])
    with pytest.raises(SystemExit, match="exactly one"):
        TCLI.main(["preprocess", "--preprocessed_root", str(initial)])


def _both_clis(argv_of, capsys, monkeypatch=None):
    """Run the port's CLI then the JAX CLI -> {name: (last stdout JSON,
    stderr JSON lines)}."""
    out = {}
    for name, cli in (("port", TCLI.main), ("jax", JCLI.main)):
        cli(argv_of(name))
        cap = capsys.readouterr()
        out[name] = (json.loads(cap.out.strip().splitlines()[-1]),
                     [json.loads(line) for line in cap.err.splitlines()
                      if line.startswith("{")])
    return out


@needs_libav
@pytest.mark.parametrize("shard", [None, (1, 2)], ids=["all", "rank1of2"])
def test_preprocess_csv_matches_jax(videos, tmp_path, capsys, monkeypatch,
                                    shard):
    """`preprocess --file_path` over a CSV: `<video_id>_<start>_<end>.mp4`
    with the float columns formatted as pandas reads them (1.0, 3.5), the
    videos processed with the detector patched into both packages, a
    missing video in the error ledger, and --rank/--nshard shards."""
    for mod in (TPP, JPP):
        monkeypatch.setattr(mod, "_default_detector", lambda: fake_detector)
    csv_path = tmp_path / "avs.csv"
    csv_path.write_text("video_id,start_time,end_time\nspk,1.0,3.5\n"
                        "spk2,0.5,2.5\nmissing,2,4.0\n")
    root = os.path.dirname(videos["spk_1.0_3.5"])
    extra = [] if shard is None else ["--rank", str(shard[0]),
                                      "--nshard", str(shard[1])]
    out = _both_clis(lambda name: [
        "preprocess", "--file_path", str(csv_path), "--video_root", root,
        "--preprocessed_root", str(tmp_path / name), *extra], capsys)
    assert out["port"] == out["jax"]
    stats, errors = out["port"]
    if shard is None:
        assert stats == {"done": 2, "failed": 1}
        assert [e["file"] for e in errors] == ["missing_2.0_4.0.mp4"]
    else:
        assert stats == {"done": 1, "failed": 0}
    assert_same_tree(_tree(tmp_path / "port"), _tree(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# data/download.py with a fake yt-dlp
# ---------------------------------------------------------------------------

FAKE_YTDLP = """#!/bin/sh
# fake yt-dlp: writes the prepared clip to the -o path; video id "bad"
# fails, "junk" writes an undecodable file
out=""; url="$1"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
case "$url" in
  *=bad) echo "HTTP Error 403" >&2; exit 1 ;;
  *=junk) printf 'not a video' > "$out" ;;
  *) cp "{clip}" "$out" ;;
esac
"""


@needs_libav
def test_download_matches_jax(videos, tmp_path, capsys, monkeypatch):
    """`download` over a CSV with a fake yt-dlp on PATH: done, error and
    invalid counted the same, the ledger equal, the clips named with the
    float columns, then a second run skips the valid clips."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "yt-dlp"
    script.write_text(FAKE_YTDLP.format(clip=videos["spk_1.0_3.5"]))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    csv_path = tmp_path / "avs.csv"
    csv_path.write_text("video_id,start_time,end_time\nabc,1,3\n"
                        "bad,0.5,2.5\njunk,2,4.5\ndef,0,2\n")

    def argv(name):
        return ["download", "--file", str(csv_path), "--video_root",
                str(tmp_path / name), "--workers", "2"]

    out = _both_clis(argv, capsys)
    for name in out:
        stats, errors = out[name]
        errors.sort(key=lambda e: e["file"])
        for e in errors:
            e["file"] = os.path.relpath(e["file"], tmp_path / name)
            e.pop("error", None)   # the subprocess message names the path
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"done": 2, "skipped": 0, "error": 1,
                              "invalid": 1}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
            "abc_1.0_3.0.mp4", "def_0.0_2.0.mp4", "junk_2.0_4.5.mp4"]
    again = _both_clis(argv, capsys)
    assert again["port"][0] == again["jax"][0] == {
        "done": 0, "skipped": 2, "error": 1, "invalid": 1}


def test_download_without_ytdlp_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    csv_path = tmp_path / "avs.csv"
    csv_path.write_text("video_id,start_time,end_time\nabc,1,3\n")
    for mod in (TDL, JDL):
        with pytest.raises(RuntimeError, match="yt-dlp is not installed"):
            mod.download_dataset(str(csv_path), str(tmp_path / "v"))
    assert TDL.is_valid_video(str(tmp_path / "nothing.mp4")) is False


# ---------------------------------------------------------------------------
# extract-kps and transcribe with fake backends
# ---------------------------------------------------------------------------

def fake_keypoints(frames, **kw):
    """A keypoint dict a frame, from its mean colour."""
    out = []
    for i, f in enumerate(frames):
        m = float(f.mean()) / 255.0
        lm = [{"x": m, "y": 0.5, "z": 0.0, "visibility": 0.9}] * 33
        out.append({"pose": lm, "left_hand": None if i % 2 else lm[:21],
                    "right_hand": lm[:21], "face": lm[:3]})
    return out


@needs_libav
def test_extract_kps_matches_jax(media, tmp_path, capsys, monkeypatch):
    """`extract-kps` with the keypoint backend patched into both packages:
    the same .pkl files and stats; an undecodable clip in the ledger; a
    second run skips."""
    from jegal_torch.host import keypoints as TK
    from jegal_tpu.host import keypoints as JK

    monkeypatch.setattr(TK, "extract_keypoints", fake_keypoints)
    monkeypatch.setattr(JK, "extract_keypoints", fake_keypoints)
    vdir = tmp_path / "videos"
    for i, name in enumerate(("s0/c0", "s0/c1", "s1/c2")):
        (vdir / name).parent.mkdir(parents=True, exist_ok=True)
        media.encode_video(str(vdir / f"{name}.avi"),
                           synth_frames(t=10 + i, h=96, w=128))
    (vdir / "s1" / "broken.avi").write_bytes(b"junk")
    csv_path = tmp_path / "files.csv"
    csv_path.write_text("filename,phrase\ns0/c0,a\ns0/c1,b\ns1/c2,c\n"
                        "s1/broken,d\n")

    def argv(name):
        return ["extract-kps", "--file_path", str(csv_path), "--video_dir",
                str(vdir), "--res_dir", str(tmp_path / name)]

    out = _both_clis(argv, capsys)
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"done": 3, "skipped": 0, "failed": 1}
    assert [e["file"] for e in out["port"][1]] == ["s1/broken"]
    assert_same_tree(_tree(tmp_path / "port"), _tree(tmp_path / "jax"))
    again = _both_clis(argv, capsys)
    assert again["port"][0] == again["jax"][0] == {
        "done": 0, "skipped": 3, "failed": 1}


def fake_asr(audio_path, batch_size=8):
    if "broken" in audio_path:
        raise IOError("corrupt audio")
    n = len(os.path.basename(audio_path))
    return {"text": " hello brave world", "language": "en",
            "words": [("hello", 0.05, 0.31, 0.9), ("brave", None, None, None),
                      ("world", 0.1 * n, 0.1 * n + 0.4, 0.8)]}


class FakeWhisperX:
    def __init__(self, *a, **kw):
        pass

    def __call__(self, audio_path, batch_size=8):
        return fake_asr(audio_path, batch_size)


def test_transcribe_folder_matches_jax(tmp_path, capsys, monkeypatch):
    """`transcribe --path` with the ASR backend patched into both packages:
    transcripts keyed by their path relative to the input root, the same
    stats and ledger, resume on the second run; `--audio_path` writes one
    transcript; exactly one of the two is required."""
    monkeypatch.setattr(TTR, "WhisperXBackend", FakeWhisperX)
    monkeypatch.setattr(JTR, "WhisperXBackend", FakeWhisperX)
    audio = tmp_path / "audio"
    for rel in ("a/x/f.wav", "b/x/f.wav", "b/long_name.flac",
                "c/broken.wav", "c/notes.txt"):
        (audio / rel).parent.mkdir(parents=True, exist_ok=True)
        (audio / rel).write_bytes(b"\0")

    def argv(name):
        return ["transcribe", "--path", str(audio), "--res_dir",
                str(tmp_path / name)]

    out = _both_clis(argv, capsys)
    for name in out:
        for e in out[name][1]:
            e["file"] = os.path.relpath(e["file"], audio)
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"done": 3, "skipped": 0, "failed": 1}
    assert out["port"][1] == [{"file": "c/broken.wav",
                               "error": "corrupt audio"}]
    assert_same_tree(_tree(tmp_path / "port"), _tree(tmp_path / "jax"))
    assert sorted(_tree(tmp_path / "port")) == [
        "a/x/f.txt", "b/long_name.txt", "b/x/f.txt"]
    again = _both_clis(argv, capsys)
    assert again["port"][0] == again["jax"][0] == {
        "done": 0, "skipped": 3, "failed": 1}

    single = _both_clis(lambda name: [
        "transcribe", "--audio_path", str(audio / "a" / "x" / "f.wav"),
        "--res_dir", str(tmp_path / f"single_{name}")], capsys)
    assert single["port"][0]["saved"].endswith("word_boundaries.txt")
    assert open(single["port"][0]["saved"]).read() == \
        open(single["jax"][0]["saved"]).read()
    for bad in ([], ["--path", str(audio), "--audio_path", "x.wav"]):
        with pytest.raises(SystemExit, match="exactly one"):
            TCLI.main(["transcribe", *bad])


def test_transcribe_folder_direct_matches_jax(tmp_path, capsys):
    """transcribe_folder with an injected backend (no patching): the same
    files and stats in both packages."""
    audio = tmp_path / "audio" / "clips"
    audio.mkdir(parents=True)
    for name in ("a.wav", "b.mp3", "broken.wav"):
        (audio / name).write_bytes(b"\0")
    got = TTR.transcribe_folder(str(tmp_path / "audio"),
                                str(tmp_path / "port"), backend=fake_asr)
    want = JTR.transcribe_folder(str(tmp_path / "audio"),
                                 str(tmp_path / "jax"), backend=fake_asr)
    assert got == want == {"done": 2, "skipped": 0, "failed": 1}
    assert_same_tree(_tree(tmp_path / "port"), _tree(tmp_path / "jax"))
    err = capsys.readouterr().err
    assert err.count("corrupt audio") == 2

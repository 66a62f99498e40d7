"""The port's host half (jegal_torch/host/, ops/video.chin_lines) against
the JAX package's on the CPU.

The port's libav decoder is its own copy of the JAX package's decoder.cc,
built with g++ into build/jegal_torch_host/; both libraries decode the same
files here and must give the same bytes: video at the native size and
resized by swscale to the GestSync input's 480x270, at the native rate and
resampled to a constant one, audio at its rate and resampled, and the C++
space-to-depth repack, which must also equal the port's numpy
ops/video.s2d_repack. The masking functions and chin_lines are held to the
JAX package's on seeded inputs and on the keypoint fixture
(tests/fixtures/keypoints_sample.pkl, one MediaPipe Holistic run) exactly.

The decoder tests skip where `pkg-config libavformat` fails (no libav
headers). The repack is a library of its own (host/csrc/repack.cc) that
needs no libav; it is also held to the numpy repack where libav is absent.
`test_native_runtime_sanitizers` (marked slow) runs both C++ sources under
ASan and UBSan (host/csrc/media_sanity.cc)."""

import os
import pickle
import shutil
import subprocess

import numpy as np
import pytest

from jegal_torch.host import masking as TM
from jegal_torch.ops import video as TV
from jegal_tpu.host import masking as JM
from jegal_tpu.ops import video as JV

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "keypoints_sample.pkl")


def _have_libav() -> bool:
    if shutil.which("pkg-config") is None or shutil.which("g++") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", "libavformat"]
                          ).returncode == 0


@pytest.fixture(scope="module")
def media():
    if not _have_libav():
        pytest.skip("no libav headers (pkg-config libavformat fails)")
    from jegal_torch.host import media as TMD

    return TMD


@pytest.fixture(scope="module")
def jax_media():
    if not _have_libav():
        pytest.skip("no libav headers (pkg-config libavformat fails)")
    from jegal_tpu.host import media as JMD

    return JMD


@pytest.fixture(scope="module")
def clips(media, tmp_path_factory):
    """A 2 s 240x320 video with a drifting square (mpeg4 .avi) and a 1.2 s
    270x480 one with 16 kHz audio muxed in (mpeg4 + AAC .avi), both written
    by the port's encoder, and a 440 Hz tone as a .wav."""
    d = tmp_path_factory.mktemp("torch_media")
    t, h, w = 50, 240, 320
    frames = np.full((t, h, w, 3), 64, np.uint8)
    for i in range(t):
        frames[i, 60:200, 80 + i:180 + i] = (200, 150, 100)
    video = str(d / "synth.avi")
    media.encode_video(video, frames, fps=25.0)
    rng = np.random.default_rng(3)
    av_frames = np.repeat(np.linspace(0, 255, 480, dtype=np.uint8)[
        None, None, :, None], 270, axis=1).repeat(30, axis=0).repeat(3, -1)
    av_frames = av_frames + rng.integers(0, 8, av_frames.shape, np.uint8)
    samples = (rng.standard_normal(19200) * 3000).astype(np.int16)
    av = str(d / "av.avi")
    media.encode_av(av, av_frames, samples, fps=25.0)
    tone = (np.sin(2 * np.pi * 440 * np.arange(32000) / 16000)
            * 8000).astype(np.int16)
    wav = str(d / "tone.wav")
    media.write_wav(wav, tone)
    return dict(video=video, frames=frames, av=av, av_frames=av_frames,
                samples=samples, wav=wav, tone=tone)


def test_decoder_builds_into_build_dir(media):
    lib = media.build_library()
    assert lib.parent.name == "jegal_torch_host"
    assert lib.parent.parent.name == "build"
    assert lib.name.startswith("decoder-") and lib.exists()
    assert media.build_library() == lib          # cached, not rebuilt
    assert media.library_path() == lib


def test_encode_decode_round_trip(media, clips):
    got, fps = media.decode_video(clips["video"])
    assert fps == pytest.approx(25.0, abs=0.5)
    assert got.shape == clips["frames"].shape
    # lossy codec: the mean error is small, the structure kept
    err = np.abs(got.astype(np.int32) - clips["frames"].astype(np.int32))
    assert err.mean() < 8.0
    got, _ = media.decode_video(clips["av"])
    assert got.shape == clips["av_frames"].shape
    assert np.abs(got.astype(np.int32)
                  - clips["av_frames"].astype(np.int32)).mean() < 8.0
    audio = media.decode_audio(clips["av"], 16000)
    assert abs(len(audio) - len(clips["samples"])) < 2048   # AAC framing
    tone = media.decode_audio(clips["wav"], 16000)
    np.testing.assert_allclose(tone, clips["tone"].astype(np.float32),
                               atol=1.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(target_w=480, target_h=270),
    dict(target_fps=12.5), dict(target_w=480, target_h=270, target_fps=10.0),
], ids=["native", "resize", "fps", "resize_fps"])
@pytest.mark.parametrize("which", ["video", "av"])
def test_decode_video_matches_jax(media, jax_media, clips, kw, which):
    got, got_fps = media.decode_video(clips[which], **kw)
    want, want_fps = jax_media.decode_video(clips[which], **kw)
    assert got_fps == want_fps
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_decode_odd_width_does_not_overrun(media, tmp_path):
    """A width whose RGB24 row is no multiple of swscale's SIMD step
    (107x92): the scale writes into a padded scratch image, so the decode
    of its last row cannot overrun the heap (which aborted or crashed the
    process with a packed destination); in a subprocess, so that a crash
    fails the test rather than the run."""
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (10, 92, 107, 3), dtype=np.uint8)
    path = str(tmp_path / "odd.avi")
    media.encode_video(path, frames)
    code = ("from jegal_torch.host import media\n"
            f"v, fps = media.decode_video({path!r})\n"
            "print(v.shape, fps)\n")
    r = subprocess.run(["python", "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split(")")[0] == "(10, 92, 107, 3"


@pytest.mark.parametrize("rate", [16000, 8000])
@pytest.mark.parametrize("which", ["av", "wav"])
def test_decode_audio_matches_jax(media, jax_media, clips, rate, which):
    got = media.decode_audio(clips[which], rate)
    want = jax_media.decode_audio(clips[which], rate)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_audio_any_matches_jax(media, jax_media, clips):
    for path in (clips["wav"], clips["av"]):
        np.testing.assert_array_equal(media.load_audio_any(path),
                                      jax_media.load_audio_any(path))


@pytest.mark.parametrize("cuts", ["none", "chin", "edges"])
def test_s2d_repack_matches_jax_and_numpy(media, jax_media, cuts):
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (6, 270, 480, 3), dtype=np.uint8)
    cut = {"none": None,
           "chin": rng.integers(90, 200, 6).astype(np.int32),
           "edges": np.array([-5, 0, 1, 269, 270, 400], np.int32)}[cuts]
    got = media.s2d_repack(frames, cut)
    assert got.shape == (6, 90, 27, 160) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_media.s2d_repack(frames, cut))
    np.testing.assert_array_equal(got, TV.s2d_repack(frames, cut))


@pytest.mark.parametrize("cuts", ["none", "chin", "edges"])
def test_repack_builds_without_libav(cuts):
    """The repack is its own library (host/csrc/repack.cc), compiled with no
    -l flag and linked against no libav library, so that it builds where
    libav is absent; it stays bit-exact with the numpy repack."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    from jegal_torch.host import media as TMD

    lib = TMD.build_repack_library()
    assert lib == TMD.repack_library_path()
    assert lib.name.startswith("repack-") and lib.exists()
    assert lib.parent == TMD.BUILD_DIR
    if shutil.which("ldd") is not None:
        linked = subprocess.run(["ldd", str(lib)], capture_output=True,
                                text=True).stdout
        assert "libav" not in linked and "libsw" not in linked, linked
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (5, 270, 480, 3), dtype=np.uint8)
    cut = {"none": None,
           "chin": rng.integers(90, 200, 5).astype(np.int32),
           "edges": np.array([-5, 0, 269, 270, 400], np.int32)}[cuts]
    np.testing.assert_array_equal(TMD.s2d_repack(frames, cut),
                                  TV.s2d_repack(frames, cut))


@pytest.mark.slow
def test_native_runtime_sanitizers(tmp_path):
    """The port's C++ host runtime (decoder.cc and repack.cc) under
    ASan+UBSan: every C-ABI entry point incl. failure paths, zero
    leaks/UB (host/csrc/media_sanity.cc)."""
    if not _have_libav():
        pytest.skip("no libav headers (pkg-config libavformat fails)")
    from jegal_torch.host import media as TMD

    csrc = TMD.SRC.parent
    binary = str(tmp_path / "media_sanity")
    build = subprocess.run(
        ["g++", "-std=c++17", "-g", "-O1",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         str(csrc / "decoder.cc"), str(csrc / "repack.cc"),
         str(csrc / "media_sanity.cc"), "-o", binary, *TMD.LIBS],
        capture_output=True, text=True)
    if build.returncode != 0 and "asan" in build.stderr.lower():
        pytest.skip("toolchain lacks libasan")
    assert build.returncode == 0, build.stderr
    run = subprocess.run([binary, str(tmp_path)], capture_output=True,
                         text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "media_sanity OK" in run.stdout


def test_s2d_repack_refuses_bad_shapes(media):
    with pytest.raises(ValueError):
        media.s2d_repack(np.zeros((2, 10, 9, 3), np.uint8))
    with pytest.raises(ValueError):
        media.s2d_repack(np.zeros((2, 9, 9, 3), np.uint8),
                         np.zeros(3, np.int32))


def test_media_import_builds_nothing():
    """Importing the bindings neither builds nor loads the library."""
    code = ("import jegal_torch.host.media as m\n"
            "assert m._lib is None and m._repack_lib is None\n")
    r = subprocess.run(["python", "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# masking and chin lines (numpy, no libav)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keypoints():
    with open(FIXTURE, "rb") as f:
        d = pickle.load(f)
    return d["kps"], d["resolution"]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [(480, 270), (160, 120), (640, 480)])
def test_resize_bilinear_matches_jax(dtype, size):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (240, 320, 3)).astype(dtype)
    got = TM.resize_bilinear(img, *size)
    want = JM.resize_bilinear(img, *size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_face_bbox_bottom_matches_jax(keypoints):
    kps, res = keypoints
    faces = [k["face"] for k in kps if k.get("face") is not None]
    assert faces
    for face in faces:
        assert TM.face_bbox_bottom(face, res) == JM.face_bbox_bottom(face, res)


@pytest.mark.parametrize("with_keypoints", [False, True])
def test_mask_frames_matches_jax(keypoints, with_keypoints):
    kps, res = keypoints
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (4,) + tuple(res), dtype=np.uint8)
    kp = kps[:4] if with_keypoints else None
    got = TM.mask_frames(frames, kp)
    want = JM.mask_frames(frames, kp)
    assert got.shape == want.shape == (4 + 24, 270, 480, 3)
    np.testing.assert_array_equal(got, want)


def test_check_visible_gestures_matches_jax(keypoints):
    kps, _ = keypoints
    cases = [None, kps, kps * 2,
             [dict(k, left_hand=None, right_hand=None) for k in kps * 2],
             [dict(k, pose=None) for k in kps * 2]]
    got = [TM.check_visible_gestures(c) for c in cases]
    assert got == [JM.check_visible_gestures(c) for c in cases]
    assert got[3] is False and got[4] is False


@pytest.mark.parametrize("out_height", [270, 135])
def test_chin_lines_matches_jax(keypoints, out_height):
    kps, res = keypoints
    kps = kps + [dict(kps[0], face=None)]
    got = TV.chin_lines(kps, res, out_height)
    want = JV.chin_lines(kps, res, out_height)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1] == TV.FALLBACK_ROWS


def test_keypoints_pkl_round_trip(keypoints, tmp_path):
    from jegal_torch.host import keypoints as TK
    from jegal_tpu.host import keypoints as JK

    kps, res = keypoints
    path = str(tmp_path / "kps.pkl")
    TK.save_keypoints(kps, res, path)
    assert JK.load_keypoints(path) == TK.load_keypoints(path) == (
        kps, tuple(res))
    with pytest.raises(RuntimeError, match="mediapipe"):
        TK.extract_keypoints(np.zeros((1, 9, 9, 3), np.uint8))


def test_transcript_writer_matches_jax(tmp_path):
    from jegal_torch.host import transcribe as TT
    from jegal_torch.text.normalize import load_text
    from jegal_tpu.host import transcribe as JT

    result = {"text": " hello big world", "language": "en",
              "words": [("hello", 0.1, 0.4, 0.9), ("big", None, None, None),
                        ("world", 0.5, 0.9, 0.8)]}
    TT.write_transcript(result, str(tmp_path / "t" / "a.txt"))
    JT.write_transcript(result, str(tmp_path / "j" / "a.txt"))
    got = (tmp_path / "t" / "a.txt").read_text()
    assert got == (tmp_path / "j" / "a.txt").read_text()
    timed = dict(result, words=[w for w in result["words"] if w[1]])
    out = TT.transcribe_to_file("x.wav", str(tmp_path / "r"),
                                backend=lambda path, batch_size: timed)
    assert load_text(out) == ("hello world", [["hello", 2, 10],
                                              ["world", 12, 22]])
    with pytest.raises(RuntimeError, match="no ASR backend"):
        TT.transcribe_to_file("x.wav", str(tmp_path / "r2"))

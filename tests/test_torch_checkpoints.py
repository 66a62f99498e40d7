"""The port's checkpoint IO (jegal_torch/convert/torch_import.py,
convert/checkpoints.py, the models' params_from_torch / params_from_hf)
against the JAX package's on the CPU, on reference-format state dicts
written by tests/torch_ref_state_dicts.py from trees drawn by a seeded
numpy Generator.

Converters and loaders read the same files in both packages and must give
the same key sets and every leaf equal exactly (the same float32 values,
transposed). The last tests run the slice whole: reference-format .pth
files and an HF directory -> each package's loaders -> each package's
JegalEngine on the CPU -> `vta` from frames and `ta`, the port's
embeddings within rtol = atol = 2e-5 of the JAX engine's (the tolerance of
tests/test_torch_api.py on the same weights)."""

import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_tpu.convert import checkpoints as JCK
from jegal_tpu.convert import torch_import as JTI
from jegal_tpu.models import gestsync as JG
from jegal_tpu.models import jegal as JJ
from jegal_tpu.models import roberta as JR
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import api as TAPI
from jegal_torch.convert import checkpoints as TCK
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_audio_params,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
)
from jegal_torch.convert import torch_import as TTI
from jegal_torch.models import gestsync as TG
from jegal_torch.models import jegal as TJ
from jegal_torch.models import roberta as TR
from jegal_torch.text.tokenizer import WordTokenizer
from test_torch_api import TINY_XLMR, roberta, sample, weights  # noqa: F401
from tok_util import make_tiny_tokenizer
from torch_ref_state_dicts import (
    gestsync_state_dict,
    jegal_state_dict,
    redraw,
    roberta_hf_state_dict,
)
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
SMALL_XLMR = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, max_position_embeddings=40)


def _flat(tree, prefix=""):
    """path -> numpy leaf, for JAX and torch trees alike."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}#/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_equal(got, want):
    """The same key sets, and every leaf equal exactly in value, shape
    and dtype."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def trees():
    """Full-width GestSync (with the audio branch) and JEGAL trees and a
    small XLM-R, every leaf drawn by a seeded numpy Generator."""
    rng = np.random.default_rng(5)
    gs = dict(init_gestsync_params(torch.Generator().manual_seed(0)),
              **init_gestsync_audio_params(torch.Generator().manual_seed(1)))
    jg = init_jegal_params(torch.Generator().manual_seed(2))
    rb = init_roberta_params(torch.Generator().manual_seed(3),
                             TR.RobertaConfig(**SMALL_XLMR))
    return dict(gestsync=redraw(gs, rng), jegal=redraw(jg, rng),
                roberta=redraw(rb, rng))


# ---------------------------------------------------------------------------
# torch_import helpers
# ---------------------------------------------------------------------------

def _helper_sd(rng):
    """One small state dict holding every layout the helpers read."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"lin.weight": t(6, 4), "lin.bias": t(6), "nobias.weight": t(3, 5),
          "ln.a_2": t(4), "ln.b_2": t(4), "tln.weight": t(4),
          "tln.bias": t(4), "bn.weight": t(4), "bn.bias": t(4),
          "bn.running_mean": t(4), "bn.running_var": t(4) ** 2,
          "c2.weight": t(5, 3, 3, 2), "c2.bias": t(5),
          "c3.weight": t(5, 3, 2, 3, 4),
          "nat.in_proj_weight": t(12, 4), "nat.in_proj_bias": t(12),
          "nat.out_proj.weight": t(4, 4), "nat.out_proj.bias": t(4)}
    for j in range(4):
        sd[f"ann.linears.{j}.weight"] = t(4, 4)
        sd[f"ann.linears.{j}.bias"] = t(4)
    return sd


HELPERS = [
    ("linear_from_torch", ("lin",)),
    ("linear_from_torch", ("nobias",)),
    ("layer_norm_from_torch", ("ln",)),
    ("layer_norm_from_torch", ("tln",)),
    ("batch_norm_from_torch", ("bn",)),
    ("conv2d_from_torch", ("c2",)),
    ("conv3d_from_torch", ("c3",)),
    ("mha_from_annotated_torch", ("ann",)),
    ("mha_from_torch_native", ("nat",)),
]


@pytest.mark.parametrize("name,args", HELPERS,
                         ids=[f"{n}-{a[0]}" for n, a in HELPERS])
def test_helper_matches_jax(name, args):
    sd = _helper_sd(np.random.default_rng(0))
    got = getattr(TTI, name)(sd, *args)
    assert_trees_equal(got, getattr(JTI, name)(sd, *args))
    # every leaf is a new contiguous tensor: nothing aliases the state dict
    for leaf in _flat(got).values():
        assert leaf.flags["C_CONTIGUOUS"]
    first = next(iter(_flat(got)))
    before = _flat(got)[first].copy()
    for v in sd.values():
        v.add_(1.0)
    np.testing.assert_array_equal(_flat(got)[first], before)


def test_helpers_take_numpy_arrays():
    sd = {k: v.numpy() for k, v in
          _helper_sd(np.random.default_rng(1)).items()}
    assert_trees_equal(TTI.mha_from_torch_native(sd, "nat"),
                       JTI.mha_from_torch_native(sd, "nat"))


def test_strip_module_prefix_matches_jax():
    sd = {"module.a.b": 1, "b.module.c": 2, "module.module.d": 3}
    assert TTI.strip_module_prefix(sd) == JTI.strip_module_prefix(sd)


# ---------------------------------------------------------------------------
# Model converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("audio", [True, False])
def test_gestsync_params_from_torch_matches_jax(trees, audio):
    tree = dict(trees["gestsync"])
    if not audio:
        del tree["net_aud"], tree["ff_aud"]
    sd = gestsync_state_dict(tree)
    got = TG.params_from_torch(sd)
    assert ("net_aud" in got) == audio
    assert_trees_equal(got, JG.params_from_torch(sd))
    assert_trees_equal(got, tree)                  # the leaves written


def test_jegal_params_from_torch_matches_jax(trees):
    sd = jegal_state_dict(trees["jegal"])
    got = TJ.params_from_torch(sd)
    assert_trees_equal(got, JJ.params_from_torch(sd))
    assert_trees_equal(got, trees["jegal"])


@pytest.mark.parametrize("prefix,pooler", [("roberta.", True), ("", True),
                                           ("", False)])
def test_roberta_params_from_hf_matches_jax(trees, prefix, pooler):
    sd = roberta_hf_state_dict(trees["roberta"], prefix, pooler)
    got = TR.params_from_hf(sd, TR.RobertaConfig(**SMALL_XLMR))
    assert_trees_equal(got, JR.params_from_hf(
        sd, JR.RobertaConfig(**SMALL_XLMR)))
    assert_trees_equal(got, trees["roberta"])


# ---------------------------------------------------------------------------
# Loaders and the .npz format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gestsync", "jegal"])
def test_pth_loaders_match_jax(trees, tmp_path, model):
    to_sd = gestsync_state_dict if model == "gestsync" else jegal_state_dict
    path = str(tmp_path / f"{model}.pth")
    torch.save({"state_dict": to_sd(trees[model]), "epoch": 3}, path)
    got = getattr(TCK, f"load_{model}")(path)
    assert_trees_equal(got, getattr(JCK, f"load_{model}")(path))
    assert_trees_equal(got, trees[model])
    # a bare state dict (no {"state_dict": ...} wrapper) loads too
    torch.save(to_sd(trees[model], prefix=""), path)
    assert_trees_equal(getattr(TCK, f"load_{model}")(path), trees[model])


@pytest.mark.parametrize("model", ["gestsync", "jegal", "roberta"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_both_packages(trees, tmp_path, model, writer):
    """A .npz written by either package loads in the other, exactly."""
    path = str(tmp_path / f"{model}.npz")
    tree = trees[model]
    if writer == "port":
        TCK.save_npz(jax.tree.map(torch.from_numpy, tree), path)
    else:
        JCK.save_npz(tree, path)
    got, want = TCK.load_npz(path), JCK.load_npz(path)
    assert_trees_equal(got, want)
    assert_trees_equal(got, tree)
    if model != "roberta":
        assert_trees_equal(getattr(TCK, f"load_{model}")(path), tree)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_roberta_npz_heads_load_in_both(trees, tmp_path, writer):
    path = str(tmp_path / "xlmr.npz")
    tree = trees["roberta"]
    if writer == "port":
        TCK.save_roberta_npz(dict(jax.tree.map(torch.from_numpy, tree),
                                  fused_ops={"unused": torch.zeros(2)}),
                             path, num_heads=4)
    else:
        JCK.save_roberta_npz(tree, path, num_heads=4)
    got, cfg = TCK.load_roberta(path)
    want, jcfg = JCK.load_roberta(path)
    assert_trees_equal(got, want)
    assert_trees_equal(got, tree)
    assert vars(cfg) == vars(jcfg)
    assert cfg == TR.RobertaConfig(**SMALL_XLMR)


def test_roberta_config_from_params_matches_jax(trees):
    cfg = TCK.roberta_config_from_params(trees["roberta"])
    assert vars(cfg) == vars(JCK.roberta_config_from_params(trees["roberta"]))
    assert cfg.num_heads == 12


@pytest.mark.parametrize("fmt", ["model.safetensors", "pytorch_model.bin"])
@pytest.mark.parametrize("by", ["dir", "file"])
def test_hf_checkpoints_load_in_both(trees, tmp_path, fmt, by):
    sd = roberta_hf_state_dict(trees["roberta"])
    path = tmp_path / fmt
    if fmt.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file(sd, str(path))
    else:
        torch.save(sd, path)
    where = str(tmp_path if by == "dir" else path)
    got, cfg = TCK.load_roberta(where, TR.RobertaConfig(**SMALL_XLMR))
    want, _ = JCK.load_roberta(where, JR.RobertaConfig(**SMALL_XLMR))
    assert_trees_equal(got, want)
    assert_trees_equal(got, trees["roberta"])
    assert cfg == TR.RobertaConfig(**SMALL_XLMR)


def test_hf_dir_prefers_safetensors(trees, tmp_path):
    from safetensors.torch import save_file

    save_file(roberta_hf_state_dict(trees["roberta"]),
              str(tmp_path / "model.safetensors"))
    torch.save({"garbage": torch.zeros(1)}, tmp_path / "pytorch_model.bin")
    got, _ = TCK.load_roberta(str(tmp_path), TR.RobertaConfig(**SMALL_XLMR))
    assert_trees_equal(got, trees["roberta"])


def test_missing_safetensors_raises_only_for_safetensors(trees, tmp_path,
                                                         monkeypatch):
    from safetensors.torch import save_file

    sd = roberta_hf_state_dict(trees["roberta"])
    save_file(sd, str(tmp_path / "model.safetensors"))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    cfg = TR.RobertaConfig(**SMALL_XLMR)
    with pytest.raises(ImportError, match="safetensors package"):
        TCK.load_roberta(str(tmp_path), cfg)
    got, _ = TCK.load_roberta(str(tmp_path / "pytorch_model.bin"), cfg)
    assert_trees_equal(got, trees["roberta"])


def test_unreadable_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        TCK.load_roberta(str(tmp_path))
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        TCK.load_jegal(str(bad))
    with pytest.raises(KeyError):
        TCK.load_gestsync(_saved(tmp_path, {"state_dict": {}}))


def _saved(tmp_path, obj) -> str:
    path = str(tmp_path / "empty.pth")
    torch.save(obj, path)
    return path


# ---------------------------------------------------------------------------
# The audio branch through the JAX tree converter
# ---------------------------------------------------------------------------

def test_gestsync_params_from_jax_keeps_the_audio_branch(trees):
    """A JAX GestSync tree with net_aud / ff_aud converts with them, and
    forward_aud agrees with the JAX package's on (1, 80, 100, 1) within
    rtol = atol = 2e-5 (reached: max abs err 3.9e-7 at outputs up to 0.63;
    the JAX suite holds this path at 1e-3 against the reference,
    tests/test_gestsync.py:71)."""
    jtree = JG.params_from_torch(gestsync_state_dict(trees["gestsync"]))
    port = gestsync_params_from_jax(jtree)
    assert {"net_aud", "ff_aud"} <= set(port)
    assert_trees_equal(port, trees["gestsync"])
    x = np.random.default_rng(3).standard_normal((1, 80, 100, 1)) \
        .astype(np.float32)
    want = np.asarray(JG.forward_aud(jtree, x))
    got = TG.forward_aud(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[:2] == (1, 1024)
    np.testing.assert_allclose(got, want, **TOL)


def test_aud_feature_map_keeps_every_column(trees):
    """At T 500 the branch's map has 13 time columns, as the reference's
    squeeze(-1) keeps them; forward_aud keeps the first, as the JAX
    package's forward_aud does."""
    jtree = JG.params_from_torch(gestsync_state_dict(trees["gestsync"]))
    port = gestsync_params_from_jax(jtree)
    x = np.random.default_rng(4).standard_normal((1, 80, 500, 1)) \
        .astype(np.float32)
    fmap = TG.aud_feature_map(port, torch.from_numpy(x))
    assert fmap.shape == (1, 1024, 1, 13)
    got = TG.forward_aud(port, torch.from_numpy(x))
    assert torch.equal(got, fmap[:, :, :, 0])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JG.forward_aud(jtree, x)), **TOL)


# ---------------------------------------------------------------------------
# The slice: reference files -> both packages' loaders -> both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_files(weights, roberta, tmp_path_factory):  # noqa: F811
    """test_torch_api's full-width trees and tiny XLM-R as reference .pth
    files and an HF directory (model.safetensors)."""
    from safetensors.torch import save_file

    jp, gp = weights
    rp, _ = roberta
    d = tmp_path_factory.mktemp("ref")
    torch.save({"state_dict": gestsync_state_dict(gp)}, d / "gestsync.pth")
    torch.save({"state_dict": jegal_state_dict(jp)}, d / "jegal.pth")
    (d / "xlmr").mkdir()
    save_file(roberta_hf_state_dict(rp), str(d / "xlmr" / "model.safetensors"))
    return {k: str(d / k) for k in ("gestsync.pth", "jegal.pth", "xlmr")}


@pytest.fixture(scope="module")
def loaded_engines(ref_files, weights, roberta):  # noqa: F811
    jp, gp = weights
    rp, cfg = roberta
    port = (TCK.load_jegal(ref_files["jegal.pth"]),
            TCK.load_gestsync(ref_files["gestsync.pth"]),
            TCK.load_roberta(ref_files["xlmr"], cfg)[0])
    for got, want in zip(port, (jp, gp, rp)):
        assert_trees_equal(got, want)
    jcfg = JR.RobertaConfig(**TINY_XLMR)
    jax_trees = (JCK.load_jegal(ref_files["jegal.pth"]),
                 JCK.load_gestsync(ref_files["gestsync.pth"]),
                 JCK.load_roberta(ref_files["xlmr"], jcfg)[0])
    j_eng = JAPI.JegalEngine(
        jegal_params=jax_trees[0], gestsync_params=jax_trees[1],
        roberta_params=jax_trees[2], roberta_cfg=jcfg,
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))
    t_eng = TAPI.JegalEngine(port[0], port[1], device="cpu",
                             roberta_params=port[2], roberta_cfg=cfg,
                             tokenizer=WordTokenizer(make_tiny_tokenizer()))
    return j_eng, t_eng


@pytest.mark.parametrize("combo", ["vta", "ta"])
def test_loaded_engines_agree(loaded_engines, sample, combo):  # noqa: F811
    j_eng, t_eng = loaded_engines
    s = sample if "v" in combo else {
        k: v for k, v in sample.items() if k not in ("frames", "chin_rows")}
    want = j_eng.extract(modalities=combo, **s)
    got = t_eng.extract(modalities=combo, **s)
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None
            continue
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], **TOL)
    assert got["info"] == want["info"]

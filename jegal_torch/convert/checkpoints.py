"""Checkpoint IO without JAX (the JAX package's convert/checkpoints.py).

Reads the reference's torch `.pth` checkpoints (saved as {"state_dict":
...} under nn.DataParallel prefixes, reference inference_embs.py:92-119,
README.md:52-59) and HF XLM-R checkpoints, and the flat `.npz` pytree
format that both packages write: a leaf's key is its path, dict keys
joined by "/" and list indices written "<i>#" (`a/b/0#/c`), so a file
written by either package loads in the other.

Every loader returns float32 CPU tensors in the port's layouts (integer
leaves keep their type); the engine or the caller places them on a device.
A file that cannot be read raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jegal_torch.convert import tree_to_torch


# ---------------------------------------------------------------------------
# Flat-npz pytree format
# ---------------------------------------------------------------------------

def flatten(tree, prefix=""):
    """A tree -> {"a/b/0#/c": numpy array}, the .npz key scheme."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}#/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.endswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][:-1]))
            return [rebuild(v) for _, v in items]
        return {k: rebuild(v) for k, v in node.items()}

    return tree_to_torch(rebuild(root))


def save_npz(tree, path: str):
    np.savez(path, **flatten(tree))


def load_npz(path: str):
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# Model loaders (the format from the file name)
# ---------------------------------------------------------------------------

def _torch_state_dict(path: str):
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def load_gestsync(path: str):
    """GestSync parameters from a reference .pth or a .npz."""
    from jegal_torch.models.gestsync import params_from_torch

    if path.endswith(".npz"):
        return load_npz(path)
    return params_from_torch(_torch_state_dict(path))


def load_jegal(path: str):
    """JEGAL parameters from a reference .pth or a .npz."""
    from jegal_torch.models.jegal import params_from_torch

    if path.endswith(".npz"):
        return load_npz(path)
    return params_from_torch(_torch_state_dict(path))


def roberta_config_from_params(params, num_heads: int | None = None):
    """A RobertaConfig from the parameter shapes. The head count is not in
    the shapes: a .npz stores it, else 12 (xlm-roberta-base)."""
    from jegal_torch.models.roberta import RobertaConfig

    emb = params["embeddings"]
    return RobertaConfig(
        vocab_size=int(emb["word"].shape[0]),
        hidden_size=int(emb["word"].shape[1]),
        num_layers=len(params["layers"]),
        num_heads=int(num_heads) if num_heads else 12,
        intermediate_size=int(params["layers"][0]["inter"]["kernel"].shape[1]),
        max_position_embeddings=int(emb["position"].shape[0]),
    )


def save_roberta_npz(params, path: str, num_heads: int = 12):
    """XLM-R parameters and their head count (`__meta__/num_heads`) to a
    .npz. Only "embeddings" and "layers" are written: the stack kernel's
    `fused_ops` are made again at load."""
    save_npz({"embeddings": params["embeddings"], "layers": params["layers"],
              "__meta__": {"num_heads": np.int32(num_heads)}}, path)


def _hf_file(path: str) -> str:
    """An HF checkpoint directory's weights file: model.safetensors, else
    pytorch_model.bin."""
    for cand in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                            f"pytorch_model.bin")


def load_roberta(path: str, cfg=None):
    """XLM-R parameters from an HF checkpoint (a directory, a
    model.safetensors or a pytorch_model.bin) or a .npz -> (params,
    RobertaConfig). An HF checkpoint converts under `cfg` (xlm-roberta-base
    by default); a .npz's config comes from its shapes and stored head
    count."""
    from jegal_torch.models.roberta import XLMR_BASE, params_from_hf

    if path.endswith(".npz"):
        tree = load_npz(path)
        meta = tree.pop("__meta__", {})
        return tree, roberta_config_from_params(
            tree, int(meta.get("num_heads", 12)))
    cfg = cfg or XLMR_BASE
    if os.path.isdir(path):
        path = _hf_file(path)
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"loading {path} needs the safetensors "
                              f"package") from e
        return params_from_hf(load_file(path), cfg), cfg
    return params_from_hf(_torch_state_dict(path), cfg), cfg

"""Weight bridge: JAX ``ViTDense`` param tree → the port's ``state_dict``.

Counterpart of ``vit_deep_radiomics_tpu/models/convert.py``. The port's
modules carry the reference PyTorch names, so this is the inverse of the
JAX package's ``sam_params_from_torch`` and, for DINOv2, of
``dinov2_params_from_torch`` with torch.hub naming:

* matmul kernels (in, out) → Linear weights (out, in),
* patch embedding (kh·kw·in, out) → conv weight (out, in, kh, kw),
* neck 1×1 conv (in, out) → (out, in, 1, 1); 3×3 conv HWIO → OIHW,
* DINOv2 ``ls1``/``ls2`` → ``ls1.gamma``/``ls2.gamma``, the MLP as
  ``fc1``/``fc2``, ``cls_token``, ``pos_embed`` and the final ``norm``.

The bridges yield fp32 tensors; a module built under a bf16 policy
(``inference``, ``int8``) holds bf16 parameters, and ``load_state_dict``
rounds them on the copy.

:func:`load_medsam_state_dict` reads a MedSAM/SAM ``.pth`` image encoder
for ``load_state_dict``; :func:`load_dinov2_state_dict` reads a DINOv2
``.pth`` under torch.hub's or ``transformers``' names into torch.hub's (the
names JAX ``convert.py::dinov2_params_from_torch`` takes). Both packages
load only the ``mlp.fc1``/``fc2`` MLP: torch.hub's ViT-g/14 checkpoint is
SwiGLU (``mlp.w12``/``w3``) and loads into neither.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .vit import ViTDenseConfig

__all__ = ["params_from_jax", "dinov2_params_from_jax",
           "finetune_params_from_jax", "load_medsam_state_dict",
           "load_dinov2_state_dict"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _patch_embed_from_jax(p: Mapping, cfg: ViTDenseConfig) -> dict:
    """The patch embedding: (kh·kw·in, out) → conv weight (out, in, kh,
    kw)."""
    pe = np.asarray(p["patch_embed"]["kernel"])
    ps = cfg.patch_size
    return {
        "patch_embed.proj.weight": _t(
            pe.reshape(ps, ps, -1, cfg.width).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
    }


def _backbone_from_jax(p: Mapping, cfg: ViTDenseConfig, mlp_names) -> dict:
    """Patch embedding, position embedding and blocks, both families."""
    sd = _patch_embed_from_jax(p, cfg)
    sd["pos_embed"] = _t(p["pos_embed"])
    fc1, fc2 = (f"mlp.{n}." for n in mlp_names)
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}."
        attn, mlp = blk["attn"], blk["mlp"]
        sd.update({
            pre + "norm1.weight": _t(blk["norm1"]["scale"]),
            pre + "norm1.bias": _t(blk["norm1"]["bias"]),
            pre + "norm2.weight": _t(blk["norm2"]["scale"]),
            pre + "norm2.bias": _t(blk["norm2"]["bias"]),
            pre + "attn.qkv.weight": _t(np.asarray(attn["qkv_kernel"]).T),
            pre + "attn.qkv.bias": _t(attn["qkv_bias"]),
            pre + "attn.proj.weight": _t(np.asarray(attn["proj_kernel"]).T),
            pre + "attn.proj.bias": _t(attn["proj_bias"]),
            pre + fc1 + "weight": _t(np.asarray(mlp["w1"]).T),
            pre + fc1 + "bias": _t(mlp["b1"]),
            pre + fc2 + "weight": _t(np.asarray(mlp["w2"]).T),
            pre + fc2 + "bias": _t(mlp["b2"]),
        })
        if cfg.use_rel_pos:
            sd[pre + "attn.rel_pos_h"] = _t(attn["rel_pos_h"])
            sd[pre + "attn.rel_pos_w"] = _t(attn["rel_pos_w"])
        if cfg.layerscale_init:
            sd[pre + "ls1.gamma"] = _t(blk["ls1"])
            sd[pre + "ls2.gamma"] = _t(blk["ls2"])
    return sd


def dinov2_params_from_jax(tree: Mapping, cfg: ViTDenseConfig) -> dict:
    """JAX ViTDense params of a DINOv2 config → the port's ``state_dict``
    under torch.hub's names (the inverse of JAX ``convert.py::
    dinov2_params_from_torch``). The tree of JAX's ``patch_embed_only``
    model holds the patch embedding alone, and so does the state dict."""
    p = tree["params"] if "params" in tree else tree
    if "cls_token" not in p:
        return _patch_embed_from_jax(p, cfg)
    sd = _backbone_from_jax(p, cfg, ("fc1", "fc2"))
    sd.update({
        "cls_token": _t(p["cls_token"]),
        "norm.weight": _t(p["norm"]["scale"]),
        "norm.bias": _t(p["norm"]["bias"]),
    })
    return sd


def params_from_jax(tree: Mapping, cfg: ViTDenseConfig) -> dict:
    """JAX ViTDense params (``{"params": …}`` or the inner dict, numpy or
    jax arrays) → the port's ``state_dict``, SAM or (``cfg.use_cls_token``)
    DINOv2."""
    p = tree["params"] if "params" in tree else tree
    if cfg.use_cls_token:
        return dinov2_params_from_jax(p, cfg)
    sd = _backbone_from_jax(p, cfg, ("lin1", "lin2"))
    neck = p["neck"]
    c1 = np.asarray(neck["conv1_kernel"])
    sd.update({
        "neck.0.weight": _t(c1.T.reshape(c1.shape[1], c1.shape[0], 1, 1)),
        "neck.1.weight": _t(neck["ln1"]["scale"]),
        "neck.1.bias": _t(neck["ln1"]["bias"]),
        "neck.2.weight": _t(np.asarray(neck["conv2_kernel"]).transpose(
            3, 2, 0, 1)),
        "neck.3.weight": _t(neck["ln2"]["scale"]),
        "neck.3.bias": _t(neck["ln2"]["bias"]),
    })
    return sd


def finetune_params_from_jax(tree: Mapping, cfg: ViTDenseConfig) -> dict:
    """JAX ``FineTuneModel`` params (``{"params": {"backbone", "head_norm",
    "head"}}`` or the inner dict) → the port's ``FineTuneModel``
    ``state_dict``; the Dense kernel (in, out) becomes a Linear weight."""
    p = tree["params"] if "params" in tree else tree
    sd = {f"backbone.{k}": v
          for k, v in params_from_jax(p["backbone"], cfg).items()}
    sd.update({
        "head_norm.weight": _t(p["head_norm"]["scale"]),
        "head_norm.bias": _t(p["head_norm"]["bias"]),
        "head.weight": _t(np.asarray(p["head"]["kernel"]).T),
        "head.bias": _t(p["head"]["bias"]),
    })
    return sd


def load_medsam_state_dict(path: str) -> dict:
    """A SAM/MedSAM ``.pth`` checkpoint → the image encoder's state dict
    with the ``image_encoder.`` prefix dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    prefix = "image_encoder."
    if any(k.startswith(prefix) for k in state):
        state = {k[len(prefix):]: v for k, v in state.items()
                 if k.startswith(prefix)}
    return state


# transformers' DINOv2 block names → torch.hub's (the query, key and value
# projections are concatenated into ``attn.qkv``)
_HF_BLOCK = {
    "norm1": "norm1", "norm2": "norm2", "mlp.fc1": "mlp.fc1",
    "mlp.fc2": "mlp.fc2", "attention.output.dense": "attn.proj",
}


def load_dinov2_state_dict(path: str) -> dict:
    """A DINOv2 ``.pth`` checkpoint → the port's state dict (torch.hub's
    names), from torch.hub's names or from ``transformers``' (``encoder.
    layer.N.attention.attention.query`` … concatenated into ``attn.qkv``,
    ``layer_scale1.lambda1`` → ``ls1.gamma``, ``layernorm`` → ``norm``), as
    JAX ``convert.py::dinov2_params_from_torch`` reads both. ``mask_token``
    (pretraining only) is dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if not any(k.startswith("encoder.layer.") for k in state):
        return {k: v for k, v in state.items() if k != "mask_token"}
    emb = "embeddings."
    sd = {
        "patch_embed.proj.weight":
            state[emb + "patch_embeddings.projection.weight"],
        "patch_embed.proj.bias":
            state[emb + "patch_embeddings.projection.bias"],
        "cls_token": state[emb + "cls_token"].reshape(1, 1, -1),
        "pos_embed": state[emb + "position_embeddings"],
        "norm.weight": state["layernorm.weight"],
        "norm.bias": state["layernorm.bias"],
    }
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in state:
        hf, pre = f"encoder.layer.{i}.", f"blocks.{i}."
        for src, dst in _HF_BLOCK.items():
            for kind in ("weight", "bias"):
                sd[f"{pre}{dst}.{kind}"] = state[f"{hf}{src}.{kind}"]
        for kind in ("weight", "bias"):
            sd[f"{pre}attn.qkv.{kind}"] = torch.cat([
                state[f"{hf}attention.attention.{n}.{kind}"]
                for n in ("query", "key", "value")])
        sd[pre + "ls1.gamma"] = state[hf + "layer_scale1.lambda1"]
        sd[pre + "ls2.gamma"] = state[hf + "layer_scale2.lambda1"]
        i += 1
    return sd

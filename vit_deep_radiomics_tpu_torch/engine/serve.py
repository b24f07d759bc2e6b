"""Serving artifacts: a model's config and its baked weights in one file,
and the loader that rebuilds the model on the card.

Counterpart of ``vit_deep_radiomics_tpu/engine/serve.py``. JAX serialises
a StableHLO program with the weights as constants (``jax.export``). The
port's kernels are ctypes launches on raw pointers, which ``torch.export``
cannot trace, so a port artifact holds what a rebuild needs instead: a
JSON header with every key JAX's header has (``kind``, ``model``,
``config``, ``batch``, ``image_size``, ``policy``, ``use_flash``,
``in_spec``, ``out_names``, ``input_mode`` …, with JAX's values), plus the
classifier's ``cfg["models"][arch]`` block and a ``format`` tag, and a
payload of state dicts written by ``torch.save`` and read back with
``weights_only=True``. :func:`load_exported` rebuilds ``ViTDense`` and the
classifier from the header alone, takes the baked tensors as they are
(bf16 under ``fast``, as JAX bakes them) and moves them to the device.

Layout (``<stem>.vdr``): the magic ``VDRT0001``, a ``<I`` header length,
the JSON header, the payload. The magic differs from JAX's ``VDRX0001``,
so each package refuses the other's file as "not a VDR export" (a JAX
artifact holds a compiled program and cannot be converted; weights cross
over through ``models/convert.py``).

Three kinds, as in JAX: dense (:func:`export_dense_model`: images → the
dense feature map), classifier (:func:`export_classifier`: tokens and
masks, or a conv volume and its voxel mask → logits and the embedding, a
static or ``"poly"`` batch) and pipeline (:func:`export_pipeline`: images,
or raw scanner volumes with ``input_mode="raw_hu"`` → descriptors → masked
tokens → logits in one call, unimodal or bimodal PET/CT).

The kernel env knobs the port reads (``VDR_FUSED_MLP``) are recorded at
export under ``kernel_env`` and govern the loaded model whatever the
serving process's environment holds. A loaded model runs every call under
``torch.inference_mode()``, on whichever thread calls it. Known
differences from JAX: there is no compiled executable to cache, so
:meth:`ExportedModel.warm` runs one zero-input call, whose launches build
the CUDA kernels the artifact needs (``utils/cuda_build.py``, keyed by
source hash under ``_build/``; ``VDR_EXEC_CACHE`` has no counterpart), and
a JAX artifact cannot be loaded.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import default_device
from ..core.precision import Policy, cast_params, get_policy
from ..models.classifiers import build_classifier
from ..models.vit import ViTDense, ViTDenseConfig
from ..ops import preprocess as pp
from ..ops.posenc import positional_encoding_3d

__all__ = [
    "export_dense_model", "export_classifier", "export_pipeline",
    "load_exported", "read_header", "ExportedModel", "tokens_one",
]

_MAGIC = b"VDRT0001"
FORMAT = "torch-state-dict/1"
# the kernel env knobs the port reads at call time; an artifact records
# those set at export and its loaded model follows the record
_FLASH_ENV_KNOBS = ("VDR_FUSED_MLP",)
PLATFORMS = ("cuda", "cpu")


def _platforms(platforms) -> list[str]:
    """The device types an artifact runs on: both unless narrowed."""
    if platforms is None:
        return list(PLATFORMS)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(
            f"platforms {bad} are not served by the PyTorch port, which "
            f"runs on {list(PLATFORMS)}; a TPU artifact is exported by the "
            f"JAX package")
    return list(dict.fromkeys(platforms))


def _kernel_env() -> dict:
    return {k: os.environ[k] for k in _FLASH_ENV_KNOBS if k in os.environ}


def _backbone(config: dict, policy: str, use_flash: bool,
              patch_embed_only: bool = False) -> ViTDense:
    """An unmaterialised ViTDense (meta tensors) from a header's config."""
    cfg = ViTDenseConfig(**{**config, "global_indexes": tuple(
        config["global_indexes"])})
    with torch.device("meta"):
        return ViTDense(cfg, policy=get_policy(policy), use_flash=use_flash,
                        patch_embed_only=patch_embed_only)


def _classifier(block: dict, arch: str, modality: str, num_classes: int,
                policy: str, modality_a: str = "pet",
                modality_b: str = "ct") -> nn.Module:
    """An unmaterialised classifier from a ``cfg["models"][arch]`` block."""
    with torch.device("meta"):
        return build_classifier({"models": {arch: block}}, arch, modality,
                                modality_a, modality_b,
                                num_classes=num_classes,
                                policy=get_policy(policy))


def _check_state(module: nn.Module, state: dict, what: str) -> None:
    """Refuse a state dict that does not fit the module the header will
    rebuild (names and shapes)."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in state.items()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        shapes = sorted(k for k in set(want) & set(have)
                        if want[k] != have[k])
        raise ValueError(
            f"the {what} weights do not fit its config: missing "
            f"{missing[:5]}, unexpected {extra[:5]}, other shapes "
            f"{shapes[:5]}")


def _bake_params(state: dict, pol: Policy) -> dict:
    """Host copies of the weights, cast to bf16 for a bf16 policy that is
    not quantized (JAX ``_bake_params``: every floating tensor, biases,
    norms, position embeddings and rel-pos tables included). ``parity``
    keeps fp32; ``int8`` keeps its bf16 parameters."""
    state = {k: v.detach().to("cpu") for k, v in state.items()}
    if pol.compute_dtype == torch.bfloat16 and not pol.quantized:
        return cast_params(state, torch.bfloat16)
    return state


def _write_artifact(out_path, header: dict, tensors: dict) -> str:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(tensors, buf)
    head = json.dumps({**header, "format": FORMAT}).encode()
    with open(out_path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<I", len(head)))
        fh.write(head)
        fh.write(buf.getbuffer())
    return str(out_path)


def _read(path, with_payload: bool):
    with open(path, "rb") as fh:
        magic = fh.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a VDR export (magic {magic!r})")
        (hlen,) = struct.unpack("<I", fh.read(4))
        meta = json.loads(fh.read(hlen).decode())
        payload = fh.read() if with_payload else b""
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown artifact format "
                         f"{meta.get('format')!r}, expected {FORMAT!r}")
    return meta, payload


def read_header(path) -> dict:
    """An artifact's JSON header, without reading its weights."""
    return _read(path, with_payload=False)[0]


def export_dense_model(
    state_dict: dict,
    backbone_cfg: ViTDenseConfig,
    out_path,
    *,
    batch: int = 4,
    policy: str = "fast",
    use_flash: bool = True,
    patch_embed_only: bool = False,
    platforms: tuple[str, ...] | None = None,
) -> str:
    """Write ``ViTDense(backbone_cfg)`` with ``state_dict`` (the port's
    reference names) as a dense artifact: one ``(batch, size, size, 3)``
    float32 image array in, the dense feature map out. ``batch`` is static
    (one artifact per serving batch size, as in JAX)."""
    pol = get_policy(policy)
    if pol.quantized and patch_embed_only:
        # a patch-embed-only model is one conv: none of the matmuls int8
        # quantizes exist, so the artifact would say int8 and run float
        raise ValueError(
            "int8 applies to the backbone's projection/MLP matmuls; a "
            "patch-embed-only export has none — use 'fast' or 'parity', "
            "or export the full dense model")
    platforms = _platforms(platforms)
    config = dataclasses.asdict(backbone_cfg)
    _check_state(_backbone(config, policy, use_flash, patch_embed_only),
                 state_dict, "backbone")
    knobs = _kernel_env()
    size, g = backbone_cfg.image_size, backbone_cfg.grid
    return _write_artifact(out_path, {
        **({"kernel_env": knobs} if knobs else {}),
        "kind": "dense",
        "model": backbone_cfg.name,
        "config": config,
        "batch": batch,
        "image_size": size,
        "policy": policy,
        "use_flash": use_flash,
        "patch_embed_only": patch_embed_only,
        "platforms": platforms,
        "out_shape": [batch, g, g, backbone_cfg.width if patch_embed_only
                      else backbone_cfg.feature_dim],
    }, {"backbone": _bake_params(state_dict, pol)})


def _classifier_io(arch: str, modality: str, bs, max_tokens: int,
                   conv_shape, feature_dim: int):
    """(in_spec, out_names) of a classifier's inputs and outputs."""
    if arch == "conv":
        s, h, w = conv_shape
        return ({"volume": [[bs, s, h, w, feature_dim], "float32"],
                 "valid_mask": [[bs, s, h, w], "bool"]},
                ["logits", "embedding"])
    tokens = [[bs, max_tokens, feature_dim], "float32"]
    mask = [[bs, max_tokens], "bool"]
    if modality in ("petct", "petchest"):
        return ({"ct_tokens": tokens, "pet_tokens": tokens,
                 "ct_mask": mask, "pet_mask": mask},
                ["logits", "petct_cls", "logits_ct", "logits_pet"])
    return {"tokens": tokens, "mask": mask}, ["logits", "cls_embedding"]


def export_classifier(
    state: dict,
    cfg: dict,
    arch: str,
    modality: str,
    out_path,
    *,
    batch: int | str = 8,
    max_tokens: int = 512,
    conv_shape: tuple[int, int, int] = (13, 12, 12),
    policy: str = "fast",
    num_classes: int = 2,
    modality_a: str = "pet",
    modality_b: str = "ct",
    platforms: tuple[str, ...] | None = None,
) -> str:
    """Write a trained downstream classifier as an artifact.

    Inputs are static-shape with validity masks (``batch="poly"`` leaves
    the batch axis free):

    * transformer (unimodal): ``(tokens (B,T,D) f32, mask (B,T) bool)`` →
      ``(logits, cls_embedding)``;
    * bimodal petct/petchest: ``(ct_tokens, pet_tokens, ct_mask,
      pet_mask)`` → ``(logits, petct_cls, logits_ct, logits_pet)``;
    * conv: ``(volume (B,S,H,W,D) f32, valid_mask (B,S,H,W) bool)`` →
      ``(logits, embedding)``.

    ``state`` is the classifier's ``state_dict`` or a fold checkpoint's
    ``{"params": …}``. The weights are stored as given, as JAX stores
    them (only the pipeline bakes bf16)."""
    if "params" in state:
        state = state["params"]
    if get_policy(policy).quantized:
        # the classifiers have no quantized matmuls: the artifact would
        # say int8 and run bf16
        raise ValueError(
            "int8 applies to the dense backbone only; export classifiers "
            "with 'fast' or 'parity'")
    platforms = _platforms(platforms)
    block = cfg["models"][arch]
    feature_dim = block["feature_dim"]
    poly = batch == "poly"
    in_spec, out_names = _classifier_io(
        arch, modality, None if poly else int(batch), max_tokens,
        conv_shape, feature_dim)
    _check_state(_classifier(block, arch, modality, num_classes, policy,
                             modality_a, modality_b), state, "classifier")
    return _write_artifact(out_path, {
        "kind": "classifier",
        "arch": arch,
        "modality": modality,
        "batch": "poly" if poly else int(batch),
        "feature_dim": feature_dim,
        "num_classes": num_classes,
        "max_tokens": (None if arch == "conv" else max_tokens),
        "conv_shape": (list(conv_shape) if arch == "conv" else None),
        "policy": policy,
        "in_spec": in_spec,
        "out_names": out_names,
        "platforms": platforms,
        "classifier_cfg": block,
        "modality_a": modality_a,
        "modality_b": modality_b,
    }, {"classifier": {k: v.detach().to("cpu") for k, v in state.items()}})


def _ct_preprocess(cfg: ViTDenseConfig) -> str:
    """How a raw CT slice becomes a backbone input: the SAM (MedSAM)
    encoder takes the HU window, DINOv2 the HU→RGB transfer / 255, as the
    extraction engine normalises them."""
    return "hu_to_rgb" if cfg.use_cls_token else "window"


def export_pipeline(
    backbone_state: dict,
    backbone_cfg: ViTDenseConfig,
    clf_state: dict,
    clf_cfg: dict,
    arch: str,
    modality: str,
    out_path,
    *,
    slices: int = 13,
    max_tokens: int = 512,
    batch: int = 1,
    policy: str = "fast",
    use_flash: bool = True,
    num_classes: int = 2,
    platforms: tuple[str, ...] | None = None,
    input_mode: str = "rgb",
    native_size: int | None = None,
    ct_window: tuple[float, float] = (800.0, 40.0),
    pet_slices: int = 2,
    pet_native_size: int | None = None,
) -> str:
    """One artifact: images → dense descriptors → masked tokens →
    classifier logits (JAX ``export_pipeline``).

    Inputs (``g`` the descriptor grid): ``(images (B, S, size, size, 3)
    f32, grid_mask (B, S, g, g) bool, spatial_res (B, 3) f32)`` →
    ``(logits, cls_embedding)`` (conv: ``(logits, embedding)``).
    ``grid_mask`` flags descriptor cells; ``spatial_res`` is mm per grid
    step. Tokens follow the trainer (:func:`tokens_one`). With
    ``modality="petct"``/``"petchest"`` the bimodal classifier takes two
    stacks: ``(ct_images, pet_images, ct_grid_mask, pet_grid_mask, ct_res,
    pet_res)`` → ``(logits, petct_cls, logits_ct, logits_pet)``, the PET
    stack ``pet_slices`` deep.

    ``input_mode="raw_hu"`` takes scanner output at ``native_size`` (int16
    HU for CT/chest, float32 activity for PET; the bimodal PET stack at
    ``pet_native_size``) and normalises and resizes it on the device: CT
    by the HU window for SAM (MedSAM) and HU→RGB / 255 for DINOv2 (the
    header's ``ct_preprocess``; JAX tests the backbone's name against
    "medsam" instead, so its export of ``SAM_VIT_B``, named "sam_vit_b",
    takes HU→RGB), PET by its maximum per volume.

    Backbone and classifier weights are baked as :func:`export_dense_model`
    bakes them."""
    bimodal = modality in ("petct", "petchest")
    if bimodal and arch != "transformer":
        raise ValueError(
            "bimodal pipeline export requires arch='transformer' (the "
            "reference's conv net is unimodal)")
    if input_mode not in ("rgb", "raw_hu"):
        raise ValueError(f"input_mode must be 'rgb' or 'raw_hu', "
                         f"got {input_mode!r}")
    if "params" in clf_state:
        clf_state = clf_state["params"]
    block = clf_cfg["models"][arch]
    feature_dim = block["feature_dim"]
    if backbone_cfg.feature_dim != feature_dim:
        raise ValueError(
            f"backbone emits {backbone_cfg.feature_dim}-d descriptors "
            f"but the classifier expects feature_dim={feature_dim}")
    pol = get_policy(policy)
    platforms = _platforms(platforms)
    config = dataclasses.asdict(backbone_cfg)
    _check_state(_backbone(config, policy, use_flash), backbone_state,
                 "backbone")
    _check_state(_classifier(block, arch, modality, num_classes, policy),
                 clf_state, "classifier")
    size, g, s, ps = (backbone_cfg.image_size, backbone_cfg.grid,
                      int(slices), int(pet_slices))
    raw = input_mode == "raw_hu"
    ns = int(native_size or 512)
    pns = int(pet_native_size or ns)
    raw_dtype = "float32" if modality == "pet" else "int16"

    def img(n_slices, native, dtype):
        return ([[batch, n_slices, native, native], dtype] if raw
                else [[batch, n_slices, size, size, 3], "float32"])

    res = [[batch, 3], "float32"]
    if bimodal:
        in_spec = {"ct_images": img(s, ns, "int16"),
                   "pet_images": img(ps, pns, "float32"),
                   "ct_grid_mask": [[batch, s, g, g], "bool"],
                   "pet_grid_mask": [[batch, ps, g, g], "bool"],
                   "ct_res": res, "pet_res": res}
        out_names = ["logits", "petct_cls", "logits_ct", "logits_pet"]
    else:
        in_spec = {"images": img(s, ns, raw_dtype),
                   "grid_mask": [[batch, s, g, g], "bool"],
                   "spatial_res": res}
        out_names = (["logits", "embedding"] if arch == "conv"
                     else ["logits", "cls_embedding"])
    knobs = _kernel_env()
    return _write_artifact(out_path, {
        **({"kernel_env": knobs} if knobs else {}),
        "kind": "pipeline",
        "model": backbone_cfg.name,
        "config": config,
        "arch": arch,
        "modality": modality,
        "batch": batch,
        "slices": s,
        **({"pet_slices": ps} if bimodal else {}),
        "image_size": size,
        "grid": g,
        "max_tokens": (None if arch == "conv" else max_tokens),
        "feature_dim": feature_dim,
        "num_classes": num_classes,
        "policy": policy,
        "use_flash": use_flash,
        "input_mode": input_mode,
        **({"native_size": ns, "ct_window": list(ct_window),
            **({"pet_native_size": pns} if bimodal else {})}
           if raw else {}),
        "in_spec": in_spec,
        "out_names": out_names,
        "platforms": platforms,
        "classifier_cfg": block,
        "ct_preprocess": _ct_preprocess(backbone_cfg),
    }, {"backbone": _bake_params(backbone_state, pol),
        "classifier": _bake_params(clf_state, pol)})


def tokens_one(feats: torch.Tensor, mask: torch.Tensor, res: torch.Tensor,
               max_tokens: int):
    """(S, g, g, D) descriptors, their (S, g, g) boolean mask and (3,) mm
    per grid step → ``max_tokens`` tokens (D) and their validity.

    The trainer's tokens (``data/datasets.py::voxel_tokens`` where the
    feature grid is the original grid) under a static budget: a stable
    argsort puts the masked voxels first in (h, w, slice) order, the
    coordinates are centred on the mean over all voxels, and each token is
    its descriptor plus the 3D encoding / 4, zeroed where invalid."""
    s, g, dim = feats.shape[0], feats.shape[1], feats.shape[-1]
    grid = torch.arange(g, dtype=torch.float32, device=feats.device)
    depth = torch.arange(s, dtype=torch.float32, device=feats.device)
    ii, jj, kk = torch.meshgrid(grid, grid, depth, indexing="ij")
    coords = [(c - c.mean()).reshape(-1)
              for c in (jj * res[0], ii * res[1], kk * res[2])]
    mflat = mask.permute(1, 2, 0).reshape(-1)                # (g·g·S,)
    fflat = feats.permute(1, 2, 0, 3).reshape(-1, dim)
    idx = torch.argsort((~mflat).to(torch.int32), stable=True)[:max_tokens]
    valid = mflat[idx]
    pe = positional_encoding_3d(*(c[idx] for c in coords), dim)
    return (fflat[idx] + pe / 4.0) * valid[:, None], valid


class _Classify(nn.Module):
    """A classifier artifact's call: its inputs in ``in_spec`` order."""

    def __init__(self, clf: nn.Module, modality: str):
        super().__init__()
        self.clf = clf
        self.bimodal = modality in ("petct", "petchest")

    def forward(self, *inputs):
        if self.bimodal:
            ct_tokens, pet_tokens, ct_mask, pet_mask = inputs
            return self.clf(ct_tokens=ct_tokens, pet_tokens=pet_tokens,
                            ct_mask=ct_mask, pet_mask=pet_mask)
        return self.clf(*inputs)


class Pipeline(nn.Module):
    """A pipeline artifact's call: (raw) images → the backbone on every
    slice of the batch in one call → tokens (or the masked conv volume) →
    the classifier."""

    def __init__(self, vit: ViTDense, clf: nn.Module, meta: dict):
        super().__init__()
        self.vit, self.clf = vit, clf
        self.arch, self.modality = meta["arch"], meta["modality"]
        self.bimodal = self.modality in ("petct", "petchest")
        self.raw = meta["input_mode"] == "raw_hu"
        self.size, self.grid = meta["image_size"], meta["grid"]
        self.slices = meta["slices"]
        self.pet_slices = meta.get("pet_slices")
        self.max_tokens = meta["max_tokens"]
        self.ct_window = tuple(meta.get("ct_window", (800.0, 40.0)))
        self.ct_preprocess = meta["ct_preprocess"]

    def preprocess_one(self, vol: torch.Tensor, mod: str) -> torch.Tensor:
        """(S, native, native) scanner volume → (S, size, size, 3)."""
        if mod in ("ct", "chest"):
            if self.ct_preprocess == "window":
                x = pp.apply_window_ct(vol.float(), *self.ct_window)
            else:
                x = pp.hu_to_rgb(vol).float() / 255.0
        else:
            x = pp.normalize_pet(vol.float())
        return pp.prepare_vit_input(x, self.size)

    def _feats(self, images, mod: str):
        """(B, S, …) images → (B, S, g, g, D) fp32 descriptors."""
        if self.raw:
            images = torch.stack([self.preprocess_one(v, mod)
                                  for v in images])
        b, n = images.shape[:2]
        f = self.vit(images.reshape(-1, self.size, self.size, 3))
        return f.float().reshape(b, n, self.grid, self.grid, -1)

    def _tokens(self, feats, masks, res):
        pairs = [tokens_one(f, m, r, self.max_tokens)
                 for f, m, r in zip(feats, masks, res)]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))

    def forward(self, *inputs):
        if self.bimodal:
            ct_images, pet_images, ct_mask, pet_mask, ct_res, pet_res = \
                inputs
            mod_b = "chest" if self.modality == "petchest" else "ct"
            ct_tok, ct_valid = self._tokens(self._feats(ct_images, mod_b),
                                            ct_mask, ct_res)
            pet_tok, pet_valid = self._tokens(
                self._feats(pet_images, "pet"), pet_mask, pet_res)
            return self.clf(ct_tokens=ct_tok, pet_tokens=pet_tok,
                            ct_mask=ct_valid, pet_mask=pet_valid)
        images, grid_mask, spatial_res = inputs
        feats = self._feats(images, self.modality)
        if self.arch == "conv":
            return self.clf(feats * grid_mask[..., None].to(feats.dtype),
                            grid_mask)
        return self.clf(*self._tokens(feats, grid_mask, spatial_res))


def _materialise(module: nn.Module, state: dict) -> nn.Module:
    """Put the baked tensors into a meta-built module, dtypes as stored."""
    module.load_state_dict(state, assign=True)
    return module


def _rebuild(meta: dict, state: dict) -> nn.Module:
    """The artifact's callable module, from the header and the weights."""
    kind = meta["kind"]
    vit = clf = None
    if kind in ("dense", "pipeline"):
        vit = _materialise(_backbone(
            meta["config"], meta["policy"], meta["use_flash"],
            meta.get("patch_embed_only", False)), state["backbone"])
        # route the K7 gate as recorded at export, not as the serving
        # process's environment says
        fused = meta.get("kernel_env", {}).get("VDR_FUSED_MLP", "0") == "1"
        for blk in getattr(vit, "blocks", ()):
            blk.fused_mlp = fused
    if kind in ("classifier", "pipeline"):
        clf = _materialise(_classifier(
            meta["classifier_cfg"], meta["arch"], meta["modality"],
            meta["num_classes"], meta["policy"],
            meta.get("modality_a", "pet"), meta.get("modality_b", "ct")),
            state["classifier"])
    if kind == "dense":
        return vit
    if kind == "classifier":
        return _Classify(clf, meta["modality"])
    if kind == "pipeline":
        return Pipeline(vit, clf, meta)
    raise ValueError(f"unknown artifact kind {kind!r}")


_DTYPES = {"float32": torch.float32, "bool": torch.bool,
           "int16": torch.int16}


@dataclasses.dataclass
class ExportedModel:
    """A loaded serving artifact on one device.

    Dense artifacts: ``model(images) → features``. Classifier and pipeline
    artifacts: positional inputs in ``meta['in_spec']`` order → a tuple in
    ``meta['out_names']`` order. Inputs are numpy arrays or tensors of the
    spec's dtype and shape (any batch for a ``"poly"`` artifact); outputs
    are tensors on the model's device. Every call runs under
    ``torch.inference_mode()``.

    :meth:`warm` runs one zero-input call, which builds the CUDA kernels
    the artifact launches (each on its first launch), so the first request
    pays for neither. ``cache_status``: ``cold`` before it, ``hit`` when
    nothing had to be built, ``miss-saved`` when it built a kernel library
    (saved for the next process), ``poly`` for a poly artifact (no fixed
    input to run).
    """

    meta: dict
    module: nn.Module
    device: torch.device
    cache_status: str = "cold"
    #: seconds of the last warm(): kernel builds, the first call
    warm_stats: dict = dataclasses.field(default_factory=dict)

    def _input_specs(self):
        """[(name, shape with None for a free batch, dtype)] in call
        order."""
        if self.meta.get("kind", "dense") == "dense":
            b, s = int(self.meta["batch"]), int(self.meta["image_size"])
            return [("images", (b, s, s, 3), torch.float32)]
        return [(name, tuple(shape), _DTYPES[dtype])
                for name, (shape, dtype) in self.meta["in_spec"].items()]

    def _inputs(self, inputs) -> list[torch.Tensor]:
        specs = self._input_specs()
        if len(inputs) != len(specs):
            raise TypeError(f"this artifact takes {len(specs)} inputs "
                            f"{[n for n, _, _ in specs]}, got {len(inputs)}")
        out = []
        for x, (name, shape, dtype) in zip(inputs, specs):
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            if t.dtype != dtype:
                raise TypeError(f"'{name}' must be {dtype}, got {t.dtype}")
            if t.ndim != len(shape) or any(
                    want is not None and have != want
                    for have, want in zip(t.shape, shape)):
                raise ValueError(f"'{name}' must have shape {list(shape)}, "
                                 f"got {list(t.shape)}")
            out.append(t.to(self.device, non_blocking=True))
        return out

    def __call__(self, *inputs):
        args = self._inputs(inputs)
        with torch.inference_mode():
            return self.module(*args)

    def warm(self) -> "ExportedModel":
        """Run one call on zeros and pull its outputs to the host; its
        launches build the kernels this process has not built yet."""
        if self.cache_status != "cold":
            return self
        if self.meta.get("batch") == "poly":
            self.cache_status = "poly"
            return self
        from ..utils import cuda_build

        zeros = [torch.zeros(shape, dtype=dtype)
                 for _, shape, dtype in self._input_specs()]
        seen = len(cuda_build.BUILDS)
        t0 = time.perf_counter()
        out = self(*zeros)
        for t in out if isinstance(out, (tuple, list)) else (out,):
            t.cpu()
        took = time.perf_counter() - t0
        builds = cuda_build.BUILDS[seen:]
        build_s = sum(s for _, s in builds)
        self.cache_status = "miss-saved" if builds else "hit"
        self.warm_stats = {"warm_build_s": round(build_s, 2),
                           "warm_first_exec_s": round(took - build_s, 2),
                           "built": [n for n, _ in builds]}
        return self


def load_exported(path, device: str | torch.device | None = None
                  ) -> ExportedModel:
    """Load an artifact onto ``device`` (CUDA unless the caller names the
    CPU; raises without a GPU): the header rebuilds the model, the
    payload fills it."""
    meta, payload = _read(path, with_payload=True)
    dev = default_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, "
                         f"not {dev.type}")
    state = torch.load(io.BytesIO(payload), map_location="cpu",
                       weights_only=True)
    module = _rebuild(meta, state).to(dev).eval()
    return ExportedModel(meta=meta, module=module, device=dev)

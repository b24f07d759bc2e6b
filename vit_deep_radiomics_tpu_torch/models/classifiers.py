"""Downstream nodule classifiers over the dense descriptors.

Counterpart of ``vit_deep_radiomics_tpu/models/classifiers.py``, under the
reference's ``state_dict`` names (``transformer_encoder.layers.N.self_attn.
in_proj_weight``, ``cross_attention_ct.multihead_attn.out_proj.weight``,
``conv1.weight``, ``se1.fc.0.weight`` …), so a reference ``.pth`` and a
JAX tree carried by ``models/convert.py::classifier_params_from_jax`` both
load with ``strict=True``:

* :class:`TransformerNoduleClassifier` — a learned CLS token prepended to
  the masked-voxel tokens, input LayerNorm, post-norm encoder (erf GELU,
  ε 1e-5), MLP head on the CLS; returns ``(logits, cls_embedding)``.
* :class:`TransformerNoduleBimodalClassifier` — per-modality CLS, LayerNorm
  and encoder, bidirectional CT↔PET cross-attention (both with
  ``num_heads_ct``, as the reference), per-modality heads and a joint
  projection head; returns ``(logits_petct, petct_cls, logits_ct,
  logits_pet)``. With one modality missing the other is encoded (JAX's fix
  of the reference's raw-CLS quirk).
* :class:`ConvNoduleClassifier` — 3D conv + squeeze-excite with a masked
  global average pool; inputs are JAX's channels-last (B, S, H, W, C)
  volumes with a (B, S, H, W) voxel mask, run channels-first inside.

Attention masks pad keys with an additive −1e30 on fp32 scores (the CLS is
always a valid key, so no row is empty) and takes the softmax of the port's
``ops/attention.py::attention_reference``: the classifier path has no
kernel of its own in either package. Matmuls follow the policy (fp32 under
``parity``; bf16 operands with an fp32 accumulator under ``fast``), as do
LayerNorm (fp32 statistics) and the casts of inputs and outputs.

Dropout is active only when ``forward`` is given a ``torch.Generator`` (on
the activations' device); ``dropout_rate`` is read at call time, so setting
it to 0 on a built model turns every dropout off. The encoders' default is
0.1 (unimodal) and 0.5 (bimodal), the heads' ``min(rate, 0.1)``.
Sequence-parallel ring attention (``seq_mesh``) is multi-device work and
raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import FAST, Policy
from ..ops.attention import attention_reference
from .vit import LayerNorm, _policy_dot

__all__ = [
    "MultiHeadAttention",
    "PostNormEncoderLayer",
    "TransformerNoduleClassifier",
    "TransformerNoduleBimodalClassifier",
    "ConvNoduleClassifier",
    "build_classifier",
    "init_classifier",
]

_NEG = -1e30
_SEQ_MESH = ("sequence-parallel ring attention (seq_mesh) is multi-device "
             "work, not ported yet")


def _no_seq_mesh(seq_mesh) -> None:
    if seq_mesh is not None:
        raise NotImplementedError(_SEQ_MESH)


def _mask_bias(token_mask: torch.Tensor | None):
    """(B, S) boolean mask → additive (B, 1, 1, S) fp32 attention bias."""
    if token_mask is None:
        return None
    bias = torch.zeros(token_mask.shape, dtype=torch.float32,
                       device=token_mask.device)
    return bias.masked_fill(~token_mask, _NEG)[:, None, None, :]


def _dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Flax's dropout: keep with probability 1 − rate, scale by 1/keep."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def _dense(x, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return _policy_dot(x, layer.weight, layer.bias, dtype).to(dtype)


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``-compatible attention (fused in-proj
    ``in_proj_weight`` (3·dim, dim), ``out_proj``), batch first, with a
    key-padding mask."""

    def __init__(self, dim: int, num_heads: int, policy: Policy,
                 seq_mesh=None):
        super().__init__()
        _no_seq_mesh(seq_mesh)
        self.dim, self.num_heads, self.policy = dim, num_heads, policy
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, key_padding_mask=None):
        d, nh = self.dim, self.num_heads
        dt = self.policy.compute_dtype
        w, b = self.in_proj_weight, self.in_proj_bias
        if query is key and key is value:
            q, k, v = _policy_dot(query, w, b, dt).to(dt).split(d, dim=-1)
        else:
            q = _policy_dot(query, w[:d], b[:d], dt).to(dt)
            k = _policy_dot(key, w[d:2 * d], b[d:2 * d], dt).to(dt)
            v = _policy_dot(value, w[2 * d:], b[2 * d:], dt).to(dt)

        def split(x):
            bsz, s, _ = x.shape
            return x.reshape(bsz, s, nh, d // nh).transpose(1, 2)

        o = attention_reference(split(q), split(k), split(v),
                                bias=_mask_bias(key_padding_mask))
        bsz, s = query.shape[:2]
        o = o.transpose(1, 2).reshape(bsz, s, d)
        return _dense(o, self.out_proj, dt)


class _MLPHead(nn.Module):
    """dense1 → GELU (erf) → dropout → dense2 → dropout."""

    def __init__(self, in_dim: int, hidden: int, out: int, policy: Policy):
        super().__init__()
        self.policy = policy
        self.dense1 = nn.Linear(in_dim, hidden)
        self.dense2 = nn.Linear(hidden, out)

    def forward(self, x, rate: float, generator=None):
        dt = self.policy.compute_dtype
        x = F.gelu(_dense(x, self.dense1, dt))
        x = _dropout(x, rate, generator)
        x = _dense(x, self.dense2, dt)
        return _dropout(x, rate, generator)


class PostNormEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch ``nn.TransformerEncoderLayer``
    semantics): ``x = norm1(x + attn(x)); x = norm2(x + mlp(x))``."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 policy: Policy, seq_mesh=None):
        super().__init__()
        self.policy = policy
        self.self_attn = MultiHeadAttention(dim, num_heads, policy, seq_mesh)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def forward(self, x, token_mask=None, rate: float = 0.0, generator=None):
        dt = self.policy.compute_dtype
        attn = self.self_attn(x, x, x, key_padding_mask=token_mask)
        x = self.norm1(x + _dropout(attn, rate, generator))
        y = F.gelu(_dense(x, self.linear1, dt))
        y = _dropout(y, rate, generator)
        y = _dropout(_dense(y, self.linear2, dt), rate, generator)
        return self.norm2(x + y)


class _Encoder(nn.Module):
    def __init__(self, dim, num_heads, ffn_dim, num_layers, policy,
                 seq_mesh=None):
        super().__init__()
        self.layers = nn.ModuleList(
            PostNormEncoderLayer(dim, num_heads, ffn_dim, policy, seq_mesh)
            for _ in range(num_layers))

    def forward(self, x, token_mask=None, rate: float = 0.0, generator=None):
        for layer in self.layers:
            x = layer(x, token_mask, rate, generator)
        return x


def _prepend_cls(tokens, token_mask, cls_param):
    """The CLS token in front of every sequence, always a valid key."""
    b = tokens.shape[0]
    cls = cls_param.to(tokens.dtype).expand(b, 1, tokens.shape[-1])
    tokens = torch.cat([cls, tokens], dim=1)
    if token_mask is not None:
        ones = torch.ones(b, 1, dtype=torch.bool, device=token_mask.device)
        token_mask = torch.cat([ones, token_mask.bool()], dim=1)
    return tokens, token_mask


class TransformerNoduleClassifier(nn.Module):
    """CLS-token transformer over masked-voxel descriptor tokens: input
    LayerNorm after the CLS concat, post-norm encoder, MLP head on the
    CLS."""

    def __init__(self, input_dim: int, ffn_dim: int, num_heads: int,
                 num_classes: int, num_layers: int, policy: Policy = FAST,
                 dropout_rate: float = 0.1, seq_mesh=None):
        super().__init__()
        _no_seq_mesh(seq_mesh)
        self.policy, self.dropout_rate = policy, dropout_rate
        self.cls_token = nn.Parameter(torch.zeros(1, 1, input_dim))
        self.norm = LayerNorm(input_dim, eps=1e-5)
        self.transformer_encoder = _Encoder(input_dim, num_heads, ffn_dim,
                                            num_layers, policy)
        self.classifier = _MLPHead(input_dim, 2 * input_dim, num_classes,
                                   policy)

    def forward(self, tokens, token_mask=None, generator=None):
        p = self.policy
        x, m = _prepend_cls(p.cast_input(tokens), token_mask, self.cls_token)
        x = self.transformer_encoder(self.norm(x), m, self.dropout_rate,
                                     generator)
        cls_out = x[:, 0]
        logits = self.classifier(cls_out, min(self.dropout_rate, 0.1),
                                 generator)
        return p.cast_output(logits), p.cast_output(cls_out)


class _CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, policy):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(dim, num_heads, policy)

    def forward(self, query, key_value, key_padding_mask):
        return self.multihead_attn(query, key_value, key_value,
                                   key_padding_mask=key_padding_mask)


class TransformerNoduleBimodalClassifier(nn.Module):
    """Bimodal PET/CT cross-attention classifier: per-modality CLS,
    LayerNorm and encoder, bidirectional cross-attention between the full
    encoded sequences read out at the CLS position, per-modality heads,
    concat → projection → joint head."""

    def __init__(self, input_dim: int, ffn_dim_ct: int, ffn_dim_pet: int,
                 num_heads_ct: int, num_heads_pet: int, num_layers_ct: int,
                 num_layers_pet: int, num_classes: int,
                 policy: Policy = FAST, dropout_rate: float = 0.5,
                 seq_mesh=None):
        super().__init__()
        _no_seq_mesh(seq_mesh)
        d = input_dim
        self.policy, self.dropout_rate = policy, dropout_rate
        self.cls_token_ct = nn.Parameter(torch.zeros(1, 1, d))
        self.cls_token_pet = nn.Parameter(torch.zeros(1, 1, d))
        self.norm_ct = LayerNorm(d, eps=1e-5)
        self.norm_pet = LayerNorm(d, eps=1e-5)
        self.transformer_encoder_ct = _Encoder(d, num_heads_ct, ffn_dim_ct,
                                               num_layers_ct, policy)
        self.transformer_encoder_pet = _Encoder(d, num_heads_pet,
                                                ffn_dim_pet, num_layers_pet,
                                                policy)
        # both directions take the CT head count (the reference's :72-73)
        self.cross_attention_ct = _CrossAttention(d, num_heads_ct, policy)
        self.cross_attention_pet = _CrossAttention(d, num_heads_ct, policy)
        self.classifier_ct = _MLPHead(d, 2 * d, num_classes, policy)
        self.classifier_pet = _MLPHead(d, 2 * d, num_classes, policy)
        self.projection_petct = _MLPHead(2 * d, d, d, policy)
        self.classifier_petct = _MLPHead(d, 2 * d, num_classes, policy)

    def _encode(self, tokens, mask, cls, norm, encoder, generator):
        x, m = _prepend_cls(self.policy.cast_input(tokens), mask, cls)
        return encoder(norm(x), m, self.dropout_rate, generator), m

    def forward(self, ct_tokens=None, pet_tokens=None, ct_mask=None,
                pet_mask=None, generator=None):
        if ct_tokens is None and pet_tokens is None:
            raise ValueError("at least one modality must be provided")
        head_rate = min(self.dropout_rate, 0.1)
        x_ct = x_pet = None
        if ct_tokens is not None:
            x_ct, m_ct = self._encode(ct_tokens, ct_mask, self.cls_token_ct,
                                      self.norm_ct,
                                      self.transformer_encoder_ct, generator)
        if pet_tokens is not None:
            x_pet, m_pet = self._encode(pet_tokens, pet_mask,
                                        self.cls_token_pet, self.norm_pet,
                                        self.transformer_encoder_pet,
                                        generator)
        if x_ct is not None and x_pet is not None:
            ct_cls = self.cross_attention_ct(x_ct, x_pet, m_pet)[:, 0]
            pet_cls = self.cross_attention_pet(x_pet, x_ct, m_ct)[:, 0]
            logits_ct = self.classifier_ct(ct_cls, head_rate, generator)
            logits_pet = self.classifier_pet(pet_cls, head_rate, generator)
            joint = self.projection_petct(torch.cat([ct_cls, pet_cls], -1),
                                          head_rate, generator)
            logits_joint = self.classifier_petct(joint, head_rate, generator)
            petct_cls = joint
        elif x_ct is not None:
            petct_cls = x_ct[:, 0]
            logits_joint = logits_ct = logits_pet = self.classifier_ct(
                petct_cls, head_rate, generator)
        else:
            petct_cls = x_pet[:, 0]
            logits_joint = logits_ct = logits_pet = self.classifier_pet(
                petct_cls, head_rate, generator)
        cast = self.policy.cast_output
        return (cast(logits_joint), cast(petct_cls), cast(logits_ct),
                cast(logits_pet))


def _masked_gap(x, valid_mask):
    """Global average pool of a channels-first (B, C, S, H, W) volume over
    (S, H, W) in fp32, padded voxels left out (``valid_mask`` (B, S, H, W)
    or None for all valid)."""
    xf = x.float()
    if valid_mask is None:
        return xf.mean(dim=(2, 3, 4))
    m = valid_mask.float()[:, None]
    total = (xf * m).sum(dim=(2, 3, 4))
    return total / m.sum(dim=(2, 3, 4)).clamp_min(1.0)


class _SELayer(nn.Module):
    """3D squeeze-excite, reduction 16, bias-free (``fc.0``, ``fc.2``)."""

    def __init__(self, channels: int, policy: Policy, reduction: int = 16):
        super().__init__()
        self.policy = policy
        hidden = max(1, channels // reduction)
        self.fc = nn.Sequential(nn.Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                nn.Linear(hidden, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x, valid_mask=None):
        dt = self.policy.compute_dtype
        y = _masked_gap(x, valid_mask).to(dt)
        y = torch.relu(_dense(y, self.fc[0], dt))
        y = torch.sigmoid(_dense(y, self.fc[2], dt))
        return x * y[:, :, None, None, None]


class ConvNoduleClassifier(nn.Module):
    """3D conv + SE classifier over masked descriptor volumes. Inputs are
    channels-last (B, S, H, W, C) with an optional (B, S, H, W)
    ``valid_mask``; the 3×3×3 convolutions run channels-first. The head's
    dropout is ``dropout_rate`` (0.1, which JAX fixes)."""

    def __init__(self, input_dim: int, num_classes: int, div: int = 2,
                 policy: Policy = FAST, dropout_rate: float = 0.1):
        super().__init__()
        self.policy, self.dropout_rate = policy, dropout_rate
        c1, c2 = input_dim // div, input_dim // (div * div)
        self.conv1 = nn.Conv3d(input_dim, c1, 3, padding=1)
        self.se1 = _SELayer(c1, policy)
        self.conv2 = nn.Conv3d(c1, c2, 3, padding=1)
        self.se2 = _SELayer(c2, policy)
        self.fc1 = nn.Linear(c2, input_dim)
        self.classifier = _MLPHead(input_dim, 2 * input_dim, num_classes,
                                   policy)

    def _conv(self, x, conv: nn.Conv3d):
        dt = self.policy.compute_dtype
        return F.conv3d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)

    def forward(self, x, valid_mask=None, generator=None):
        p = self.policy
        dt = p.compute_dtype
        x = p.cast_input(x).permute(0, 4, 1, 2, 3)
        x = self.se1(torch.relu(self._conv(x, self.conv1)), valid_mask)
        x = self.se2(torch.relu(self._conv(x, self.conv2)), valid_mask)
        x = _dense(_masked_gap(x, valid_mask).to(dt), self.fc1, dt)
        embedding = torch.relu(x)
        logits = self.classifier(embedding, self.dropout_rate, generator)
        return p.cast_output(logits), p.cast_output(embedding)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """Flax's default kernel init: a normal truncated at ±2σ whose
    variance is 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_classifier(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights with JAX's initialisers (the draws are the port's):
    Xavier-uniform attention projections, LeCun-normal Dense and conv
    kernels, zero biases, unit LayerNorms, N(0, 1) CLS tokens."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        host = torch.empty(p.shape, dtype=torch.float32)
        if leaf.startswith("cls_token"):
            host.normal_(generator=gen)
        elif leaf == "in_proj_weight" or name.endswith("out_proj.weight"):
            nn.init.xavier_uniform_(host, generator=gen)
        elif leaf.endswith("bias"):
            host.zero_()
        elif p.ndim == 1:                    # LayerNorm scale
            host.fill_(1.0)
        else:                                # Linear (out, in), conv (out, in, k…)
            _lecun_normal_(host, p[0].numel(), gen)
        p.copy_(host)
    return model


def build_classifier(cfg: dict, arch: str, modality: str,
                     modality_a: str = "pet", modality_b: str = "ct",
                     num_classes: int = 2, policy: Policy = FAST,
                     seq_mesh=None) -> nn.Module:
    """A classifier from the merged config tree: bimodal for
    petct/petchest, conv, or the unimodal transformer (JAX's
    ``build_classifier``)."""
    _no_seq_mesh(seq_mesh)
    cfg_model = cfg["models"][arch]
    feature_dim = cfg_model["feature_dim"]
    if modality in ("petct", "petchest"):
        mb, ma = cfg_model[modality_b], cfg_model[modality_a]
        return TransformerNoduleBimodalClassifier(
            input_dim=feature_dim,
            ffn_dim_ct=int(mb["mlp_ratio"] * feature_dim),
            ffn_dim_pet=int(ma["mlp_ratio"] * feature_dim),
            num_heads_ct=mb["num_heads"], num_heads_pet=ma["num_heads"],
            num_layers_ct=mb["num_layers"], num_layers_pet=ma["num_layers"],
            num_classes=num_classes, policy=policy)
    if arch == "conv":
        return ConvNoduleClassifier(input_dim=feature_dim,
                                    num_classes=num_classes,
                                    div=cfg_model[modality]["div"],
                                    policy=policy)
    m = cfg_model[modality]
    return TransformerNoduleClassifier(
        input_dim=feature_dim, ffn_dim=int(m["mlp_ratio"] * feature_dim),
        num_heads=m["num_heads"], num_classes=num_classes,
        num_layers=m["num_layers"], policy=policy)

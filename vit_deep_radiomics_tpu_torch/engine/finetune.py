"""End-to-end backbone fine-tuning: images → trainable ViT → classifier.

Counterpart of ``vit_deep_radiomics_tpu/engine/finetune.py``. The ViT
backbone (SAM/MedSAM, or a ``dinov2_*`` config) is differentiable end to
end: its attention runs the trainable kernels of ``ops/attention_grad.py``
(under ``fast``: SAM's window layers K1 forward and K4 backward, global
and DINOv2 layers K5; under ``parity``: K6 in every layer), so the (S, S)
score matrices are recomputed in the backward instead of being stored. A
masked-average-pool head trains on top with the reference's focal loss.

Typical use::

    tuner = FineTuner(FineTuneConfig(num_classes=2))
    state = tuner.init(seed=0)
    for images, masks, labels in batches:
        state, loss, logits = tuner.step(state, images, masks, labels)

``freeze_below`` keeps the first N transformer blocks frozen: their
parameters leave the optimizer (the patch and position embeddings stay
trainable, as in JAX's ``_freeze_mask``). ``accum_steps`` splits each
batch into equal microbatches and applies the optimizer once. ZeRO-1 and
the mesh are multi-device work (ROADMAP.md Queue 1 item 10) and raise.
Under ``parity`` the backward runs with TF32 off too (``Policy.backends``
around ``FineTuner.backward``), so no fp32 product of the step rounds to
TF32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .. import default_device
from ..core.precision import Policy, get_policy
from ..models.losses import focal_loss
from ..models.vit import DINOV2_CONFIGS, SAM_VIT_B, ViTDense, \
    ViTDenseConfig

__all__ = ["FineTuneConfig", "FineTuneModel", "FineTuner"]

_MULTI_DEVICE = "is multi-device work, not ported yet (ROADMAP.md Queue 1 " \
                "item 10)"


@dataclasses.dataclass(frozen=True)
class FineTuneConfig:
    backbone: str = "medsam"           # "medsam" | dinov2_* name
    num_classes: int = 2
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    freeze_below: int = 0              # freeze blocks [0, N)
    focal_gamma: float = 2.0
    focal_alpha: tuple[float, ...] = (0.25, 0.75)
    precision: str = "fast"
    # False/'none' | True/'block' (recompute whole blocks) | 'mlp'
    # (recompute only the MLP hidden activations)
    remat: bool | str = False
    accum_steps: int = 1               # microbatches per optimizer step
    zero1: bool = False                # multi-device: raises
    backbone_cfg: ViTDenseConfig | None = None   # override (tests)

    def resolve_backbone(self) -> ViTDenseConfig:
        if self.backbone_cfg is not None:
            return self.backbone_cfg
        if self.backbone == "medsam":
            return SAM_VIT_B
        if self.backbone not in DINOV2_CONFIGS:
            raise KeyError(f"unknown backbone {self.backbone!r}; choose "
                           f"medsam or one of {sorted(DINOV2_CONFIGS)}")
        return DINOV2_CONFIGS[self.backbone]


class FineTuneModel(nn.Module):
    """Trainable ViT + masked-average pool + LayerNorm + linear head.

    ``mask`` (B, H/p, W/p) selects the nodule ROI on the feature grid;
    an empty mask falls back to global average pooling. The head's
    LayerNorm keeps Flax's eps of 1e-6. ``use_flash=False`` runs the
    backbone's plain attention under torch autograd (the oracle)."""

    def __init__(self, cfg: ViTDenseConfig, num_classes: int, policy: Policy,
                 remat: bool | str = False, use_flash: bool = True):
        super().__init__()
        self.backbone = ViTDense(cfg, policy=policy, use_flash=use_flash,
                                 trainable=True, remat=remat)
        self.head_norm = nn.LayerNorm(cfg.feature_dim, eps=1e-6)
        self.head = nn.Linear(cfg.feature_dim, num_classes)

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "FineTuneModel":
        """Seeded backbone weights (``ViTDense.init_random``), a unit
        LayerNorm, a LeCun-normal head kernel and a zero head bias."""
        self.backbone.init_random(seed)
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        w = self.head.weight
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[1]))
        self.head.bias.zero_()
        self.head_norm.reset_parameters()
        return self

    def forward(self, images, mask):
        feats = self.backbone(images).float()               # (B, h, w, C)
        m = mask.float()[..., None]
        denom = m.sum(dim=(1, 2))
        masked = (feats * m).sum(dim=(1, 2)) / denom.clamp_min(1.0)
        pooled = torch.where(denom > 0, masked, feats.mean(dim=(1, 2)))
        return self.head(self.head_norm(pooled))


def _frozen(name: str, freeze_below: int) -> bool:
    parts = name.split(".")
    return (len(parts) > 2 and parts[0] == "backbone"
            and parts[1] == "blocks" and int(parts[2]) < freeze_below)


class FineTuner:
    """Fine-tuning loop around :class:`FineTuneModel` on one device."""

    def __init__(self, config: FineTuneConfig, mesh=None,
                 device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError(f"a fine-tuning mesh {_MULTI_DEVICE}")
        if config.zero1:
            raise NotImplementedError(f"zero1 {_MULTI_DEVICE}")
        self.config = config
        self.device = default_device(device)
        self.policy = get_policy(config.precision)
        if self.policy.quantized:
            raise ValueError(
                "int8 is an inference-only policy (round() kills the "
                "gradients); fine-tune with 'fast' or 'parity'")
        if config.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got "
                             f"{config.accum_steps}")
        self.backbone_cfg = config.resolve_backbone()

    def build_model(self, use_flash: bool = True) -> FineTuneModel:
        return FineTuneModel(self.backbone_cfg, self.config.num_classes,
                             self.policy, remat=self.config.remat,
                             use_flash=use_flash)

    # -- state ------------------------------------------------------------
    def init(self, seed: int = 0, state_dict: dict | None = None) -> dict:
        """``{"model", "optimizer"}``: seeded random weights, or
        ``state_dict`` in the port's names (``models/convert.py::
        finetune_params_from_jax`` bridges a JAX tree), and AdamW over the
        trainable parameters."""
        model = self.build_model()
        if state_dict is None:
            model.init_random(seed)
        else:
            model.load_state_dict(state_dict)
        model = model.to(self.device)
        params = []
        for name, p in model.named_parameters():
            frozen = _frozen(name, self.config.freeze_below)
            p.requires_grad_(not frozen)
            if not frozen:
                params.append(p)
        # optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8 added to
        # sqrt(v̂), decoupled weight decay on every trainable leaf
        opt = torch.optim.AdamW(params, lr=self.config.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.config.weight_decay)
        return {"model": model, "optimizer": opt}

    # -- steps ------------------------------------------------------------
    def loss(self, model, images, mask, labels):
        """(focal loss / batch, logits) of one (micro)batch."""
        cfg = self.config
        logits = model(images, mask)
        loss = focal_loss(logits, labels, gamma=cfg.focal_gamma,
                          alpha=cfg.focal_alpha) / labels.shape[0]
        return loss, logits

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device, dtype)

    def backward(self, model, images, mask, labels):
        """Loss and backward of one batch in ``accum_steps`` microbatches:
        each parameter's ``.grad`` gains the batch's mean gradient. Returns
        (loss, logits), detached."""
        a = self.config.accum_steps
        b = images.shape[0]
        if b % a:
            raise ValueError(f"batch {b} not divisible by accum_steps {a}")
        mb = b // a
        losses, logits = [], []
        with self.policy.backends():     # the backward's products too
            for i in range(a):
                sl = slice(i * mb, (i + 1) * mb)
                loss, out = self.loss(model, images[sl], mask[sl],
                                      labels[sl])
                # mean of the microbatch gradients: the monolithic batch's
                (loss / a).backward()
                losses.append(loss.detach())
                logits.append(out.detach())
        return torch.stack(losses).mean(), torch.cat(logits)

    def step(self, state, images, mask, labels):
        """One optimizer step; returns (state, loss, logits), the loss and
        logits detached."""
        images = self._tensor(images, torch.float32)
        mask = self._tensor(mask, torch.bool)
        labels = self._tensor(labels, torch.float32)
        model, opt = state["model"], state["optimizer"]
        opt.zero_grad(set_to_none=True)
        loss, logits = self.backward(model, images, mask, labels)
        opt.step()
        return state, loss, logits

    # -- convenience ------------------------------------------------------
    def fit(self, state, batches, log=None):
        """Run over an iterable of (images, mask, labels_onehot)."""
        losses = []
        for i, (images, mask, labels) in enumerate(batches):
            state, loss, _ = self.step(state, images, mask, labels)
            losses.append(float(loss))
            if log:
                log(f"step {i}: loss {losses[-1]:.4f}")
        return state, np.asarray(losses)

"""The precision policies of the port against JAX's, and ``_policy_dot``.

``_policy_dot`` under bf16 keeps the fp32 accumulator of the product and
adds the fp32 bias to it before the one cast down, as JAX
``models/vit.py:55-71`` does (``preferred_element_type=float32``). Rounding
the product to bf16 first and adding the bias after rounds twice: on the
integer-valued inputs below, whose fp32 sums are exact in any order, that
moves 6.9% of the outputs by a bf16 step, while the repaired port equals
JAX bit for bit. On Gaussian inputs (sums in another order on the two
sides) the repaired port is within one bf16 step everywhere and off by one
in under 0.2% of the outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_deep_radiomics_tpu.core import precision as JP
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu_torch.core import precision as TP
from vit_deep_radiomics_tpu_torch.models import vit as tvit


def _both(x, w, b):
    """JAX and the port, bf16, same inputs: x (M, K), w (K, N), b (N,)."""
    want = jvit._policy_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            quant=False, dtype=jnp.bfloat16)
    got = tvit._policy_dot(torch.from_numpy(x),
                           torch.from_numpy(np.ascontiguousarray(w.T)),
                           torch.from_numpy(b), torch.bfloat16)
    assert got.dtype == torch.float32
    return (np.asarray(want.astype(jnp.bfloat16), np.float32),
            got.to(torch.bfloat16).float().numpy())


def test_policy_dot_keeps_the_fp32_accumulator(rng):
    """Integer-valued operands (exact in bf16; every fp32 partial sum
    exact, so the order of the sums does not matter) and an fp32 bias:
    the bf16 outputs equal JAX's exactly."""
    x = rng.integers(-8, 9, size=(64, 96)).astype(np.float32)
    w = rng.integers(-8, 9, size=(96, 128)).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    want, got = _both(x, w, b)
    np.testing.assert_array_equal(got, want)
    # the rounding the repair removed: bf16 product, then the bias
    twice = (torch.from_numpy(x).bfloat16() @ torch.from_numpy(w).bfloat16()
             ).float() + torch.from_numpy(b)
    assert (twice.bfloat16().float().numpy() != want).mean() > 0.05


def test_policy_dot_gaussian_within_one_step(rng):
    x = rng.normal(size=(128, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 192)) / 16).astype(np.float32)
    b = rng.normal(size=192).astype(np.float32)
    want, got = _both(x, w, b)
    diff = np.abs(got - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-30).all()
    assert (diff > 0).mean() < 2e-3


def test_policy_dot_backward_is_the_bf16_products():
    """The autograd Function's gradients are those of a bf16 matmul on the
    rounded-down gradient (the backward the fine-tuning path had)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 32, generator=gen).bfloat16().requires_grad_()
    w = torch.randn(24, 32, generator=gen).requires_grad_()
    g = torch.randn(3, 5, 24, generator=gen)
    tvit._policy_dot(x, w, None, torch.bfloat16).backward(g)
    gb = g.bfloat16()
    torch.testing.assert_close(x.grad, gb @ w.detach().bfloat16(), rtol=0,
                               atol=0)
    want_w = (gb.reshape(-1, 24).t() @ x.detach().reshape(-1, 32)).float()
    torch.testing.assert_close(w.grad, want_w, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["parity", "fast", "inference", "fp32",
                                  "bf16", "int8"])
def test_every_jax_policy_name(name):
    j, t = JP.get_policy(name), TP.get_policy(name)
    assert t.name == j.name and t.quantized == j.quantized
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(t, field)).split(".")[-1] == \
            jnp.dtype(getattr(j, field)).name


@pytest.mark.parametrize("policy", [TP.INFERENCE, TP.INT8],
                         ids=["inference", "int8"])
def test_bf16_param_dtype_holds_bf16_parameters(policy):
    import dataclasses

    cfg = dataclasses.replace(tvit.SAM_VIT_B, image_size=32, patch_size=8,
                              width=64, depth=2, num_heads=2, window_size=2,
                              neck_channels=16)
    model = tvit.ViTDense(cfg, policy=policy).init_random(0)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    sd = TP.cast_params(tvit.ViTDense(cfg).init_random(0).state_dict(),
                        torch.bfloat16)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k

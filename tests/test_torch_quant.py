"""Port vs JAX: the dynamic-int8 path (``ops/quant.py``, K8) and the
``int8``/``inference`` policies.

* ``quantize_rows``, ``quantize_weight`` and ``int8_dot`` equal JAX's
  exactly on the same inputs (the same IEEE operations: a division, round
  half to even, a clip, the rescale ``y · (s_x · s_w)``).
* K8's plain version equals the int64 oracle and JAX ``int8_matmul_pallas``
  (interpret) exactly, and refuses untiled shapes as JAX does.
* The guard against an int8 path slower than bf16 behaves as JAX's four
  monkeypatched cases (JAX tests/test_quant.py:298-333).
* A tiny SAM under ``int8``, fused (split q/kv projections sharing one
  quantization) and unfused, against JAX ``int8`` on the same bf16
  weights (``cast_params``, as JAX's init creates them under that policy):
  elementwise within INT8_ATOL (measured on this input 0 unfused, 0.070
  fused; 0.057 and 0.070 on another seed; outputs of max |x| about 3.4: a
  quantized value flips where an upstream bf16 value differs, and JAX's
  fused attention drops the running max and runs its scores in bf16), and
  per-position cosine > 0.995 against the fp32 oracle (JAX's criterion,
  tests/test_quant.py:116; measured 0.99962).
* ``inference`` against JAX ``INFERENCE`` on ``cast_params`` weights, held
  as ``fast`` is in tests/test_torch_vit.py.
* Trainable layers under ``int8`` keep the float matmuls: equal to
  ``fast`` on the same (bf16-valued) weights, gradients live.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.core import precision as JP
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu.ops import quant as JQ
from vit_deep_radiomics_tpu_torch.core import precision as TP
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.convert import params_from_jax
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import quant as Q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_and_int8_dot_equal_jax(rng, dtype):
    x = rng.normal(size=(3, 17, 96)).astype(np.float32)
    x[0, 0] = 0.0                      # an all-zero row stays exactly 0
    w = (rng.normal(size=(96, 40)) / 8).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(jdt)
    for got, want in zip(Q.quantize_rows(tx), JQ.quantize_rows(jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for axis in (0, 1):
        for got, want in zip(Q.quantize_weight(torch.from_numpy(w), axis),
                             JQ.quantize_weight(jnp.asarray(w), axis)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = Q.int8_dot(tx, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (3, 17, 40)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JQ.int8_dot(jx, jnp.asarray(w))))
    assert not got[0, 0].any()


def test_int8_matmul_plain_is_exact(rng):
    x = rng.integers(-127, 128, size=(256, 384)).astype(np.int8)
    w = rng.integers(-127, 128, size=(384, 256)).astype(np.int8)
    oracle = x.astype(np.int64) @ w.astype(np.int64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for got in (Q.int8_matmul_plain(tx, tw), Q.int8_matmul(tx, tw),
                Q.int8_matmul_nk(tx, tw.t().contiguous())):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64), oracle)
    want = JQ.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                 block_m=128, block_n=128, block_k=128,
                                 interpret=True)
    np.testing.assert_array_equal(np.asarray(want), Q.int8_matmul(tx, tw))


@pytest.mark.parametrize("m,k,n", [(100, 128, 128), (128, 96, 128),
                                   (128, 128, 64)])
def test_untiled_shapes_refused_as_jax(m, k, n):
    with pytest.raises(ValueError, match="128-multiple"):
        JQ.int8_matmul_pallas(jnp.zeros((m, k), jnp.int8),
                              jnp.zeros((k, n), jnp.int8), interpret=True)
    with pytest.raises(ValueError, match="128-multiple"):
        Q.int8_matmul(torch.zeros(m, k, dtype=torch.int8),
                      torch.zeros(k, n, dtype=torch.int8))


def test_kernel_wrapper_refuses_before_launch():
    """A non-CPU tensor never takes the plain path (meta tensors stand in
    for CUDA ones): a float operand raises instead of launching."""
    A.reset_launch_counts()
    with pytest.raises(TypeError, match="int8"):
        Q.int8_matmul_nk(torch.empty(128, 128, device="meta"),
                         torch.empty(128, 128, device="meta"))
    assert A.LAUNCHES["int8_matmul"] == 0


@pytest.mark.parametrize("m,k,n", [(19600, 768, 768), (16384, 768, 1000),
                                   (16384, 700, 3072), (0, 768, 768)])
def test_kernel_wrapper_refuses_untiled_shapes_before_launch(m, k, n):
    """K8's one body takes every M, N and K that are positive multiples of
    128; the (N, K) wrapper refuses any other before a launch (the
    windowed layers' 19600 rows are padded to 19712 by its caller)."""
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="128-multiple"):
        Q.int8_matmul_nk(torch.empty(m, k, device="meta", dtype=torch.int8),
                         torch.empty(n, k, device="meta", dtype=torch.int8))
    assert A.LAUNCHES["int8_matmul"] == 0


class TestGuard:
    """warn_if_int8_emulated, JAX tests/test_quant.py:298-333."""

    def test_emulated_backend_raises_without_optin(self, monkeypatch):
        monkeypatch.setattr(Q, "int8_matmul_rate_ratio", lambda **_: 0.04)
        monkeypatch.delenv("VDR_ALLOW_INT8", raising=False)
        with pytest.raises(RuntimeError, match="VDR_ALLOW_INT8"):
            Q.warn_if_int8_emulated()

    def test_optin_downgrades_to_warning(self, monkeypatch):
        monkeypatch.setattr(Q, "int8_matmul_rate_ratio", lambda **_: 0.04)
        monkeypatch.setenv("VDR_ALLOW_INT8", "1")
        logged = []
        assert Q.warn_if_int8_emulated(log=logged.append) == 0.04
        assert logged and "0.04x" in logged[0]

    def test_parity_rate_warns_no_benefit(self, monkeypatch):
        monkeypatch.setattr(Q, "int8_matmul_rate_ratio", lambda **_: 0.97)
        monkeypatch.delenv("VDR_ALLOW_INT8", raising=False)
        logged = []
        assert Q.warn_if_int8_emulated(log=logged.append) == 0.97
        assert logged and "no speed benefit" in logged[0]

    def test_genuine_speedup_passes_silently(self, monkeypatch):
        monkeypatch.setattr(Q, "int8_matmul_rate_ratio", lambda **_: 1.8)
        monkeypatch.delenv("VDR_ALLOW_INT8", raising=False)
        logged = []
        assert Q.warn_if_int8_emulated(log=logged.append) == 1.8
        assert not logged

    def test_live_probe_returns_finite_ratio(self):
        r = Q.int8_matmul_rate_ratio(m=256, k=128, n=256, reps=2,
                                     device="cpu")
        assert 0 < r < 1000


# JAX's fused int8 test config (tests/test_quant.py:121): every layer takes
# the fused window mode
TINY = dict(image_size=64, patch_size=8, width=128, depth=3, num_heads=2,
            window_size=4, global_indexes=(1,), neck_channels=32)
J_CFG = dataclasses.replace(jvit.SAM_VIT_B, **TINY)
T_CFG = dataclasses.replace(tvit.SAM_VIT_B, **TINY)
INT8_ATOL = {False: 0.085, True: 0.105}


@pytest.fixture(scope="module")
def tiny_sam():
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    params = jvit.ViTDense(J_CFG, policy=JP.PARITY, use_flash=False).init(
        jax.random.PRNGKey(0), jnp.asarray(img))
    params = jax.tree_util.tree_map(np.array, params)
    for i in range(J_CFG.depth):
        attn = params["params"][f"block_{i}"]["attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            attn[name] = (rng.normal(size=attn[name].shape) * 0.5).astype(
                np.float32)
    bf16 = JP.cast_params(params, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        def run(pol, flash, p):
            return np.asarray(jvit.ViTDense(J_CFG, policy=pol,
                                            use_flash=flash).apply(
                p, jnp.asarray(img)), np.float32)

        outs = {"oracle": run(JP.PARITY, False, params),
                "inference": run(JP.INFERENCE, True, bf16)}
        for flash in (False, True):
            outs[("int8", flash)] = run(JP.INT8, flash, bf16)
    return img, params_from_jax(params, T_CFG), outs


def _port(setup, policy, use_flash=True, trainable=False):
    img, sd, _ = setup
    model = tvit.ViTDense(T_CFG, policy=policy, use_flash=use_flash,
                          trainable=trainable)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(img)).numpy()


def _min_cosine(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return float((np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                       * np.linalg.norm(b, axis=-1))).min())


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["unfused", "fused"])
def test_int8_forward_matches_jax(tiny_sam, use_flash, monkeypatch):
    calls = []
    real = tvit.int8_dot_prequant
    monkeypatch.setattr(tvit, "int8_dot_prequant",
                        lambda *a: calls.append(1) or real(*a))
    got = _port(tiny_sam, TP.INT8, use_flash)
    outs = tiny_sam[2]
    assert got.dtype == np.float32 and got.shape == (2, 8, 8, 32)
    # the fused layers' q and kv projections share one quantize_rows
    assert len(calls) == (2 * J_CFG.depth if use_flash else 0)
    gap = np.abs(got - outs[("int8", use_flash)]).max()
    cos = _min_cosine(got, outs["oracle"])
    print(f"int8 {'fused' if use_flash else 'unfused'}: gap to JAX int8 "
          f"{gap:.4f}, min cosine to the oracle {cos:.6f}")
    assert gap <= INT8_ATOL[use_flash], gap
    assert cos > 0.995


def test_inference_matches_jax(tiny_sam):
    """bf16 parameters after load; held like ``fast``: within twice JAX
    INFERENCE's own gap to the fp32 oracle and 6e-2 (measured 0.039 vs
    0.037)."""
    img, sd, outs = tiny_sam
    model = tvit.ViTDense(T_CFG, policy=TP.INFERENCE)
    model.load_state_dict(sd)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    jax_gap = np.abs(outs["inference"] - outs["oracle"]).max()
    port_gap = np.abs(got - outs["inference"]).max()
    print(f"inference: gap to JAX {port_gap:.4f}, JAX to oracle "
          f"{jax_gap:.4f}")
    assert port_gap <= 2 * jax_gap and port_gap <= 6e-2, (port_gap, jax_gap)


def test_trainable_int8_keeps_float_matmuls(tiny_sam):
    """Trainable layers ignore ``quantized``: under ``int8`` the forward
    equals ``fast`` on the same bf16-valued weights bit for bit, and the
    MLP's gradient is live."""
    img, sd, _ = tiny_sam
    bf16_sd = TP.cast_params(sd, torch.bfloat16)
    models = {}
    for name, pol in (("fast", TP.FAST), ("int8", TP.INT8)):
        models[name] = tvit.ViTDense(T_CFG, policy=pol, use_flash=False,
                                     trainable=True)
        models[name].load_state_dict(bf16_sd)
    x = torch.from_numpy(img)
    want = models["fast"](x)
    got = models["int8"](x)
    assert torch.equal(got, want)
    got.square().sum().backward()
    assert models["int8"].blocks[0].mlp.lin1.weight.grad.abs().max() > 0


def test_finetuner_refuses_int8():
    """JAX engine/finetune.py:141-144: int8 is inference-only."""
    from vit_deep_radiomics_tpu_torch.engine.finetune import (
        FineTuneConfig, FineTuner,
    )

    with pytest.raises(ValueError, match="inference-only"):
        FineTuner(FineTuneConfig(precision="int8"), device="cpu")


class TestCli:
    def test_precision_choices_are_jax_s(self):
        from vit_deep_radiomics_tpu.cli.extract import build_parser as jax_p
        from vit_deep_radiomics_tpu_torch.cli.extract import build_parser

        def choices(parser):
            return next(a.choices for a in parser._actions
                        if a.dest == "precision")

        assert sorted(choices(build_parser())) == sorted(choices(jax_p()))

    def test_int8_guard_runs_before_the_sweep(self, monkeypatch, tmp_path):
        """Under --precision int8 the guard probes the device first and a
        rate under half of bf16 refuses without VDR_ALLOW_INT8=1, before
        any model is built."""
        from vit_deep_radiomics_tpu_torch.cli import extract as cli

        seen = []
        monkeypatch.setattr(Q, "int8_matmul_rate_ratio",
                            lambda device=None: seen.append(device) or 0.3)
        monkeypatch.delenv("VDR_ALLOW_INT8", raising=False)
        with pytest.raises(RuntimeError, match="VDR_ALLOW_INT8"):
            cli.main(["-h5", str(tmp_path / "x.hdf5"), "-df",
                      str(tmp_path / "x.csv"), "--precision", "int8",
                      "--device", "cpu"])
        assert seen == ["cpu"]

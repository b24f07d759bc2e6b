"""Port vs JAX: K3, the generic head-major flash attention, and the tiny
SAM whose layers take the generic path (``WindowedAttention._flash``).

The same numpy inputs go through the JAX ``flash_attention`` (Pallas in
interpret mode) and the port's ``flash_attention`` on CPU tensors (K3's
plain version), in every mode: the decomposed bias, the bias on a padded
key grid with ``kv_grid``, ``window_tokens`` block-diagonal attention, and
``kv_len`` with a row that has no valid key (both average V over all keys:
JAX's masked scores are -1e30, not -inf). Tolerances are those of
tests/test_torch_attention.py: fp32 2e-5; bf16 2e-2 (JAX rounds the scaled
q, the bias and the probabilities to bf16 and runs exp2 in bf16, the port
keeps fp32 scores). Every ValueError JAX raises, the port raises too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.core.precision import PARITY as J_PARITY
from vit_deep_radiomics_tpu.models import vit as jvit
from vit_deep_radiomics_tpu.ops.attention import flash_attention as jax_flash
from vit_deep_radiomics_tpu_torch.core.precision import PARITY
from vit_deep_radiomics_tpu_torch.models import vit as tvit
from vit_deep_radiomics_tpu_torch.models.convert import params_from_jax
from vit_deep_radiomics_tpu_torch.ops import attention as A

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# name: (B, H, Sq, Sk, Kh, Kw, kv_grid, window_tokens, kv_len, block_q,
#        block_k) — JAX's blocks are TPU tiles, chosen so that they divide
CASES = {
    "bias": (2, 2, 64, 64, 8, 8, None, None, None, 32, 32),
    "bias_kv_grid": (2, 2, 48, 64, 8, 8, (6, 5), None, None, 16, 32),
    "window_tokens": (2, 2, 64, 64, 4, 4, (3, 3), 16, None, 32, 32),
    # SAM's grouped layout (WindowedAttention's window_group > 1): two
    # 16 x 16 windows with 14 x 14 valid
    "window_sam": (1, 2, 512, 512, 16, 16, (14, 14), 256, None, 512, 512),
    "kv_len": (2, 2, 64, 64, 0, 0, None, None, (0, 37), 32, 32),
}


def _inputs(rng, b, h, sq, sk, d, kh, kw):
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    bh = bw = None
    if kh:
        bh = (rng.normal(size=(b, h, sq, kh)) * 0.5).astype(np.float32)
        bw = (rng.normal(size=(b, h, sq, kw)) * 0.5).astype(np.float32)
    return q, k, v, bh, bw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(rng, case, d, dtype):
    b, h, sq, sk, kh, kw, grid, win, kv_len, bq, bk = CASES[case]
    q, k, v, bh, bw = _inputs(rng, b, h, sq, sk, d, kh, kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def jx(a):
        return None if a is None else jnp.asarray(a).astype(jdt)

    def tt(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    want = jax_flash(jx(q), jx(k), jx(v), jx(bh), jx(bw),
                     None if kv_len is None else jnp.asarray(kv_len,
                                                             jnp.int32),
                     kv_grid=grid, window_tokens=win, block_q=bq,
                     block_k=bk, interpret=True)
    got = A.flash_attention(tt(q), tt(k), tt(v), tt(bh), tt(bw),
                            None if kv_len is None else torch.tensor(kv_len),
                            kv_grid=grid, window_tokens=win, block_q=bq,
                            block_k=bk)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, sq, d)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    if case == "kv_len":     # batch row 0 has no valid key: the mean of V
        mean_v = torch.from_numpy(v[0]).to(tdt).float().mean(dim=1)
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.broadcast_to(mean_v[:, None].numpy(),
                                                   (h, sq, d)),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_cpu_wrapper_does_not_count_launches(rng):
    q, k, v, bh, bw = map(lambda a: torch.from_numpy(a),
                          _inputs(rng, 1, 2, 64, 64, 32, 8, 8))
    A.reset_launch_counts()
    A.flash_attention(q, k, v, bh, bw)
    assert A.LAUNCHES == dict.fromkeys(A.LAUNCHES, 0)


@pytest.mark.parametrize("case,match", [
    ("bias_alone", "given together"),
    ("blocks", "must divide blocks"),
    ("grid_without_bias", "kv_grid requires"),
    ("bias_grid", r"Kh\*Kw"),
    ("window_without_grid", "window_tokens requires kv_grid"),
    ("window_sq_sk", "requires Sq == Sk"),
    ("window_kv_len", "kv_len is not supported in window mode"),
    ("window_divides", "must divide block"),
    ("window_bias_grid", "block-diagonal bias grid"),
])
def test_same_value_errors(rng, case, match):
    """The port refuses what JAX ``flash_attention`` refuses (ops/attention.py:
    265-318), with the same messages."""
    q, k, v, bh, bw = _inputs(rng, 1, 2, 64, 64, 32, 8, 8)
    kw = dict(block_q=32, block_k=32)
    bias = [bh, bw]
    kv_len = None
    if case == "bias_alone":
        bias = [bh, None]
    elif case == "blocks":
        kw = dict(block_q=24, block_k=32)
    elif case == "grid_without_bias":
        bias, kw["kv_grid"] = [None, None], (4, 4)
    elif case == "bias_grid":
        bias = [bh[..., :4], bw]
    elif case == "window_without_grid":
        kw["window_tokens"] = 64
        bias = [bh, bw]
    elif case == "window_sq_sk":
        k, v = k[:, :, :32], v[:, :, :32]
        kw.update(kv_grid=(4, 4), window_tokens=16)
        bias = [bh[..., :4], bw[..., :4]]
    elif case == "window_kv_len":
        kv_len = np.array([64], np.int32)
        kw.update(kv_grid=(4, 4), window_tokens=16)
        bias = [bh[..., :4], bw[..., :4]]
    elif case == "window_divides":
        kw.update(kv_grid=(4, 4), window_tokens=24)
    elif case == "window_bias_grid":
        kw.update(kv_grid=(4, 4), window_tokens=16)
    args = [q, k, v] + bias
    j_args = [None if a is None else jnp.asarray(np.ascontiguousarray(a))
              for a in args]
    t_args = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
              for a in args]
    with pytest.raises(ValueError, match=match):
        jax_flash(*j_args, None if kv_len is None else jnp.asarray(kv_len),
                  interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        A.flash_attention(*t_args,
                          None if kv_len is None else torch.from_numpy(kv_len),
                          **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_is_plain_on_the_cpu_and_checks_the_layout(rng, case):
    """K3's route query answers "plain" for CPU tensors in every mode (the
    card's answers, "tiled" for fp32 at D 64 outside window mode, are held
    in tests/test_torch_cuda_kernels.py) and refuses what the wrapper
    refuses, before any build: a bias grid that is not Sk, and a dtype with
    no build on a non-CPU tensor."""
    b, h, sq, sk, kh, kw, grid, win, kv_len, bq, bk = CASES[case]
    q, k, v, bh, bw = map(lambda a: None if a is None else torch.from_numpy(a),
                          _inputs(rng, b, h, sq, sk, 64, kh, kw))
    kl = None if kv_len is None else torch.tensor(kv_len)
    opts = dict(kv_grid=grid, window_tokens=win, block_q=bq, block_k=bk)
    assert A.flash_attention_route(q, k, v, bh, bw, kl, **opts) == "plain"
    if bh is not None:
        with pytest.raises(ValueError, match="Kh|grid|window"):
            A.flash_attention_route(q, k, v, bh[..., :1], bw, kl, **opts)
    meta = [torch.empty(t.shape, dtype=torch.float16, device="meta")
            for t in (q, k, v)]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.flash_attention_route(*meta, kv_len=kl, block_q=bq, block_k=bk)


def test_empty_kv_grid_is_refused(rng):
    """The port's own refusal: a kv_grid that keeps no key."""
    q, k, v, bh, bw = map(torch.from_numpy,
                          _inputs(rng, 1, 2, 64, 64, 32, 8, 8))
    with pytest.raises(ValueError, match="keeps no key"):
        A.flash_attention(q, k, v, bh, bw, kv_grid=(0, 4))


@pytest.mark.parametrize("s", [16, 49, 196, 1370, 2304, 4096])
def test_padding_rules_match_jax(s):
    assert tvit._q_blocking(s) == jvit._q_blocking(s)
    sq_pad = tvit._q_blocking(s)[0]
    for cap in (512, 1024, 2048):
        assert tvit._pick_block_k(sq_pad, cap) == jvit._pick_block_k(
            sq_pad, cap)


# A SAM-shaped config whose head layout the fused kernels refuse (3 heads
# of 24: _head_group is None), so every layer takes _flash: the 4x4 windows
# pad their key grid to 8x8 (kv_grid (4, 4)) and their queries to 128, the
# 8x8 global layer runs unpadded.
TINY = dict(image_size=64, patch_size=8, width=72, depth=3, num_heads=3,
            window_size=4, global_indexes=(1,), neck_channels=16)
J_CFG = dataclasses.replace(jvit.SAM_VIT_B, **TINY)
T_CFG = dataclasses.replace(tvit.SAM_VIT_B, **TINY)


@pytest.fixture(scope="module")
def tiny_sam():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    params = jvit.ViTDense(J_CFG, policy=J_PARITY, use_flash=False).init(
        jax.random.PRNGKey(0), jnp.asarray(img))
    params = jax.tree_util.tree_map(np.array, params)
    for i in range(J_CFG.depth):
        attn = params["params"][f"block_{i}"]["attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            attn[name] = (rng.normal(size=attn[name].shape) * 0.5).astype(
                np.float32)
    with jax.default_matmul_precision("highest"):
        outs = {flash: np.asarray(jvit.ViTDense(
            J_CFG, policy=J_PARITY, use_flash=flash).apply(
                params, jnp.asarray(img)), np.float32)
            for flash in (False, True)}
    return img, params_from_jax(params, T_CFG), outs


def test_tiny_sam_takes_the_generic_path():
    attn = tvit.WindowedAttention(T_CFG, input_size=4)
    assert attn._fused_variant(4, 4) is None
    assert attn._fused_variant(8, 8) is None


@pytest.mark.parametrize("jax_flash_path", [False, True])
def test_tiny_sam_matches_jax(tiny_sam, jax_flash_path, monkeypatch):
    """fp32: the port's _flash path (K3's plain version) against the JAX
    _flash path (K3 in interpret mode, its queries padded to
    ``_q_blocking``'s length) and the JAX oracle, 2e-5; every layer called
    K3's wrapper with the S query rows it keeps (16 a window, 64 in the
    global layer), not the padded length (128)."""
    img, sd, outs = tiny_sam
    calls = []
    real = tvit.flash_attention
    monkeypatch.setattr(tvit, "flash_attention",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    model = tvit.ViTDense(T_CFG, policy=PARITY)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert len(calls) == 3
    assert [k.get("kv_grid") for _, k in calls] == [(4, 4), None, (4, 4)]
    assert [a[0].shape[2] for a, _ in calls] == [16, 64, 16]
    assert [tvit._q_blocking(a[0].shape[2])[0] for a, _ in calls] == [128] * 3
    np.testing.assert_allclose(got, outs[jax_flash_path], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kept_query_rows_match_jax_padded(rng, dtype):
    """K3 as ``WindowedAttention._flash`` now calls it, on the S query rows
    it keeps, against JAX's K3 (interpret mode) on the queries and bias
    rows padded to ``_q_blocking``'s length as JAX's _flash pads them, on
    the same padded key grid (a 6 x 6 grid padded to 8 x 8, ``kv_grid``
    (6, 6); 36 queries padded to 128): the kept rows agree at the file's
    tolerances (fp32 2e-5, bf16 2e-2)."""
    b, h, d, g, gp = 2, 2, 64, 6, 8
    s = g * g
    sq_pad, bq = tvit._q_blocking(s)
    q, k, v, bh, bw = _inputs(rng, b, h, s, gp * gp, d, gp, gp)
    grid_keys = np.zeros((gp, gp), bool)
    grid_keys[:g, :g] = True
    k[:, :, ~grid_keys.ravel()] = 0.0      # the grid's padding is zeros
    v[:, :, ~grid_keys.ravel()] = 0.0
    bh[..., g:] = 0.0
    bw[..., g:] = 0.0

    def pad_rows(a):
        return np.pad(a, ((0, 0), (0, 0), (0, sq_pad - s), (0, 0)))

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (
        pad_rows(q), k, v, pad_rows(bh), pad_rows(bw))), None,
        kv_grid=(g, g), block_q=bq, block_k=gp * gp, interpret=True)
    got = A.flash_attention(*(torch.from_numpy(a).to(tdt)
                              for a in (q, k, v, bh, bw)),
                            kv_grid=(g, g), block_q=s, block_k=gp * gp)
    assert tuple(got.shape) == (b, h, s, d) and sq_pad == 128
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32)[:, :, :s],
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_window_group_batches_windows(monkeypatch):
    """window_group > 1 (JAX _flash_grouped): 14x14 windows, padded to
    16x16 (256 queries and keys), batched 4 per K3 call in window_tokens
    mode, 6 windows so the last group is padded; the result equals the
    ungrouped path's."""
    cfg = dataclasses.replace(T_CFG, window_size=14)
    attn = tvit.WindowedAttention(cfg, input_size=14)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p_ in attn.parameters():
            p_.copy_(torch.randn(p_.shape, generator=gen) * 0.2)
        x = torch.randn(6, 14, 14, cfg.width, generator=gen)
        want = attn(x, PARITY)
        calls = []
        real = tvit.flash_attention
        monkeypatch.setattr(tvit, "flash_attention",
                            lambda *a, **k: calls.append(k) or real(*a, **k))
        attn.window_group = 4
        got = attn(x, PARITY)
    assert [c.get("window_tokens") for c in calls] == [256]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)

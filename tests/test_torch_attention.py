"""Port vs JAX: fused-QKV attention (window mode K1, global mode K2).

The same numpy inputs go through the JAX ``flash_attention_fused_qkv``
(Pallas kernels in interpret mode, pair-merged bias) and the port's
function (plain PyTorch versions on CPU tensors, per-head bias).
Tolerances are those of tests/test_fused_qkv_attention.py: fp32 2e-5,
bf16 2e-2 (both sides round q/k/v and the output to bf16; JAX also runs
its score chain in bf16 and drops the running max, the port keeps fp32
scores and the max).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_deep_radiomics_tpu.ops.attention import (
    flash_attention_fused_qkv as jax_fused,
)
from vit_deep_radiomics_tpu_torch.ops import attention as port

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pack_pairs(bias, pair):
    """(B, H, S, K) per-head bias → (B, H/pair, S, pair·K) pair-merged."""
    b, h, s, k = bias.shape
    return bias.reshape(b, h // pair, pair, s, k).transpose(
        0, 1, 3, 2, 4).reshape(b, h // pair, s, pair * k)


def _inputs(rng, b, s, heads, d, kh=0, kw=0):
    q = rng.normal(size=(b, s, heads * d)).astype(np.float32)
    kv = rng.normal(size=(b, s, 2 * heads * d)).astype(np.float32)
    if not kh:
        return q, kv, None, None
    bh = (rng.normal(size=(b, heads, s, kh)) * 0.3).astype(np.float32)
    bw = (rng.normal(size=(b, heads, s, kw)) * 0.3).astype(np.float32)
    return q, kv, bh, bw


def _run_both(q, kv, bh, bw, heads, dtype, kv_len=None, window=None,
              block=128, nomax=None):
    d = q.shape[-1] // heads
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    pair = port._head_group(heads, d)

    def jx(a):
        return None if a is None else jnp.asarray(a).astype(jdt)

    def tt(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    s = q.shape[1]
    want = jax_fused(
        (jx(q), jx(kv)),
        bias_h=None if bh is None else jx(_pack_pairs(bh, pair)),
        bias_w=None if bw is None else jx(_pack_pairs(bw, pair)),
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
        num_heads=heads, window_tokens=window,
        block_q=s if window else block, block_k=s if window else block,
        nomax=nomax, interpret=True)
    got = port.flash_attention_fused_qkv(
        tt(q), tt(kv), tt(bh), tt(bw),
        None if kv_len is None else torch.tensor(kv_len),
        num_heads=heads, window_tokens=window)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestWindowMode:
    def test_non_square_grid(self, rng, dtype):
        """3x5 windows (15 tokens, not a multiple of 8 or 16), D=32."""
        q, kv, bh, bw = _inputs(rng, 2, 8 * 15, 4, 32, 3, 5)
        want, got = _run_both(q, kv, bh, bw, 4, dtype, window=15)
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])

    def test_head_dim_64_group_of_4(self, rng, dtype):
        """SAM's head layout: D=64, pair-merged groups of 4 heads on the
        JAX side (_head_group(4, 64) == 4)."""
        assert port._head_group(4, 64) == 4
        q, kv, bh, bw = _inputs(rng, 3, 2 * 16, 4, 64, 4, 4)
        want, got = _run_both(q, kv, bh, bw, 4, dtype, window=16)
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])

    def test_no_bias(self, rng, dtype):
        q, kv, _, _ = _inputs(rng, 1, 4 * 32, 8, 16)
        want, got = _run_both(q, kv, None, None, 8, dtype, window=32)
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestGlobalMode:
    def test_decomposed_bias_16x16(self, rng, dtype):
        """S=256 over a 16x16 key grid, 128-token blocks on the JAX side."""
        q, kv, bh, bw = _inputs(rng, 2, 256, 4, 64, 16, 16)
        want, got = _run_both(q, kv, bh, bw, 4, dtype)
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])

    @pytest.mark.parametrize("kh,kw", [(4, 64), (2, 128)])
    def test_decomposed_bias_wide_grid_rows(self, rng, dtype, kh, kw):
        """Key-grid rows of 64 and 128 keys, the widths K2's wgmma kernel
        takes on the card (SAM @1024's global layers have Kw = 64): the
        plain version that kernel is held to agrees with JAX there."""
        q, kv, bh, bw = _inputs(rng, 2, kh * kw, 4, 64, kh, kw)
        want, got = _run_both(q, kv, bh, bw, 4, dtype)
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])

    def test_kv_len_zero_row_averages_v(self, rng, dtype):
        """A batch row with no valid key: every score is masked alike, so
        a softmax that keeps the running max (the port's kernels, JAX's
        with ``nomax=False``) averages V over all S keys. JAX's default
        unnormalised softmax writes 0 there instead, and in bf16 its
        max-keeping one NaN (its fp32 initial max -1e30 sits above the
        bf16-rounded masked score, so the first rescale overflows): there
        the port is held to the mean of V alone, and JAX on the other row."""
        q, kv, _, _ = _inputs(rng, 2, 128, 4, 64)
        want, got = _run_both(q, kv, None, None, 4, dtype, kv_len=[0, 70],
                              nomax=False)
        rows = slice(None) if dtype == "float32" else slice(1, None)
        np.testing.assert_allclose(got[rows], want[rows], atol=TOL[dtype],
                                   rtol=TOL[dtype])
        mean_v = kv[0, :, 256:].mean(axis=0)
        np.testing.assert_allclose(got[0], np.broadcast_to(mean_v, (128, 256)),
                                   atol=TOL[dtype], rtol=TOL[dtype])

    def test_kv_len_no_bias(self, rng, dtype):
        q, kv, _, _ = _inputs(rng, 2, 256, 8, 16)
        want, got = _run_both(q, kv, None, None, 8, dtype,
                              kv_len=[100, 256])
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


class TestPlainVersions:
    def test_window_plain_is_per_window_reference(self, rng):
        """K1's plain version equals attention_reference window by window
        with the dense bias built by hand."""
        b, heads, d, win, n_win = 2, 2, 64, 6, 3
        q, kv, bh, bw = _inputs(rng, b, n_win * win, heads, d, 2, 3)
        q, kv, bh, bw = map(torch.from_numpy, (q, kv, bh, bw))
        out = port.fused_window_attention(
            q, kv, bh, bw, num_heads=heads, window_tokens=win, scale=0.125)
        c = heads * d
        for w in range(n_win):
            sl = slice(w * win, (w + 1) * win)

            def hs(x):
                return x[:, sl].reshape(b, win, heads, d).transpose(1, 2)

            dense = (bh[:, :, sl, :, None] + bw[:, :, sl, None, :]).reshape(
                b, heads, win, win)
            ref = port.attention_reference(
                hs(q), hs(kv[..., :c]), hs(kv[..., c:]), bias=dense,
                scale=0.125)
            np.testing.assert_allclose(
                out[:, sl].numpy(),
                ref.transpose(1, 2).reshape(b, win, c).numpy(),
                atol=1e-6, rtol=1e-6)

    def test_cpu_wrappers_do_not_count_launches(self, rng):
        port.reset_launch_counts()
        q, kv, bh, bw = map(torch.from_numpy,
                            _inputs(rng, 1, 16, 2, 64, 4, 4))
        port.flash_attention_fused_qkv(q, kv, bh, bw, num_heads=2,
                                       window_tokens=16)
        port.flash_attention_fused_qkv(q, kv, bh, bw, num_heads=2)
        assert port.LAUNCHES == dict.fromkeys(port.LAUNCHES, 0)

    def test_window_route_is_plain_on_the_cpu_and_checks_the_layout(self,
                                                                     rng):
        """The route query answers "plain" for CPU tensors (the card's
        answers are held in tests/test_torch_cuda_kernels.py) and refuses
        what the wrapper refuses."""
        q, kv, bh, bw = map(torch.from_numpy,
                            _inputs(rng, 1, 16, 2, 64, 4, 4))
        kw = dict(num_heads=2, window_tokens=16, scale=0.125)
        assert port.fused_window_attention_route(q, kv, bh, bw, **kw) == \
            "plain"
        with pytest.raises(ValueError, match="per-window bias grid"):
            port.fused_window_attention_route(q, kv, bh[..., :2], bw, **kw)

    @pytest.mark.parametrize("mode", ["bias", "nobias", "kv_len"])
    def test_global_route_is_plain_on_the_cpu_and_checks_the_layout(
            self, rng, mode):
        """K2's route query answers "plain" for CPU tensors in each mode
        (the card's answers, "tiled" for fp32, are held in
        tests/test_torch_cuda_kernels.py) and refuses what the wrapper
        refuses: a bias grid that is not S, a kv_len of the wrong length,
        and (on a non-CPU tensor, before any build) a head dim with no
        build."""
        q, kv, bh, bw = map(torch.from_numpy,
                            _inputs(rng, 2, 16, 2, 64, 4, 4))
        kv_len = torch.tensor([16, 0]) if mode == "kv_len" else None
        if mode != "bias":
            bh = bw = None
        kw = dict(num_heads=2, scale=0.125)
        assert port.fused_global_attention_route(q, kv, bh, bw, kv_len,
                                                 **kw) == "plain"
        with pytest.raises(ValueError, match=r"Kh\*Kw"):
            port.fused_global_attention_route(
                q, kv, *map(torch.from_numpy, _inputs(rng, 2, 16, 2, 64, 2,
                                                      4)[2:]), **kw)
        with pytest.raises(ValueError, match="kv_len shape"):
            port.fused_global_attention_route(q, kv, bh, bw,
                                              torch.tensor([16]), **kw)
        meta_q = torch.empty(2, 16, 4 * 32, device="meta")
        meta_kv = torch.empty(2, 16, 8 * 32, device="meta")
        with pytest.raises(ValueError, match="head dim 32"):
            port.fused_global_attention_route(meta_q, meta_kv, num_heads=4,
                                              scale=0.125)


class TestKernelWrapperChecks:
    """The kernel wrappers refuse, before any launch, what their kernels
    cannot take (meta tensors stand in for CUDA ones: any non-CPU tensor
    takes the kernel path)."""

    @pytest.mark.parametrize("case", ["kv_shape", "bias_shape", "bias_grid",
                                      "bias_alone", "segments", "head_dim",
                                      "kv_len"])
    def test_refused_before_launch(self, case):
        b, s, heads, d, win = 2, 32, 2, 64, 16

        def meta(*shape):
            return torch.empty(*shape, device="meta")

        q, kv = meta(b, s, heads * d), meta(b, s, 2 * heads * d)
        bh, bw = meta(b, heads, s, 4), meta(b, heads, s, 4)
        kw = dict(num_heads=heads, scale=0.125)
        if case == "kv_shape":
            kv = meta(b, s, heads * d)
        elif case == "bias_shape":
            bh = meta(b, heads, s - 1, 4)
        elif case == "bias_grid":
            bw = meta(b, heads, s, 2)
        elif case == "bias_alone":
            bw = None
        elif case == "segments":
            win = 12
        elif case == "head_dim":
            q, kv = meta(b, s, 2 * 48), meta(b, s, 4 * 48)
        port.reset_launch_counts()
        with pytest.raises(ValueError):
            if case == "kv_len":      # one entry for two batch rows
                port.fused_global_attention(
                    q, kv, None, None, torch.tensor([s]), **kw)
            else:
                port.fused_window_attention(q, kv, bh, bw,
                                            window_tokens=win, **kw)
        with pytest.raises(ValueError):   # 4x4 bias grid != 32 tokens
            port.fused_global_attention(q, kv, bh, bw, **kw)
        assert port.LAUNCHES == dict.fromkeys(port.LAUNCHES, 0)

    def test_unbuilt_head_dim_refused(self):
        """A layout the JAX function takes (4 heads of 32) but the kernels
        are not built for: the wrappers raise instead of launching."""
        b, s, heads, d = 1, 16, 4, 32
        q = torch.empty(b, s, heads * d, device="meta")
        kv = torch.empty(b, s, 2 * heads * d, device="meta")
        port.reset_launch_counts()
        with pytest.raises(ValueError, match="head dim 32"):
            port.fused_window_attention(q, kv, num_heads=heads,
                                        window_tokens=s, scale=0.125)
        with pytest.raises(ValueError, match="head dim 32"):
            port.fused_global_attention(q, kv, num_heads=heads, scale=0.125)
        assert port.LAUNCHES == dict.fromkeys(port.LAUNCHES, 0)


class TestLayoutErrors:
    """The port refuses the layouts the JAX function refuses, with the
    same messages (JAX ops/attention.py:933-1084)."""

    @pytest.mark.parametrize("case,match", [
        ("kv_shape", "kv shape"),
        ("head_layout", "128-lane"),
        ("bias_alone", "given together"),
        ("window_divides", "must divide block"),
        ("window_grid", "per-window bias grid"),
        ("window_kv_len", "kv_len is not supported in window mode"),
        ("global_grid", r"Kh\*Kw"),
    ])
    def test_same_value_errors(self, rng, case, match):
        heads, d, s = 2, 64, 64
        q, kv, bh, bw = _inputs(rng, 1, s, heads, d, 8, 8)
        args = dict(num_heads=heads)
        jbias = dict(bias_h=jnp.asarray(_pack_pairs(bh, 2)),
                     bias_w=jnp.asarray(_pack_pairs(bw, 2)))
        tbias = dict(bias_h=torch.from_numpy(bh), bias_w=torch.from_numpy(bw))
        jq, jkv, tq, tkv = (jnp.asarray(q), jnp.asarray(kv),
                            torch.from_numpy(q), torch.from_numpy(kv))
        jextra, textra = dict(jbias), dict(tbias)
        if case == "kv_shape":
            jkv, tkv = jkv[..., :-2], tkv[..., :-2]
        elif case == "head_layout":
            q3 = rng.normal(size=(1, s, 96)).astype(np.float32)
            kv3 = rng.normal(size=(1, s, 192)).astype(np.float32)
            jq, jkv = jnp.asarray(q3), jnp.asarray(kv3)
            tq, tkv = torch.from_numpy(q3), torch.from_numpy(kv3)
            args = dict(num_heads=3)
            jextra, textra = {}, {}
        elif case == "bias_alone":
            jextra.pop("bias_w")
            textra.pop("bias_w")
        elif case == "window_divides":
            jextra, textra = {}, {}
            args.update(window_tokens=24)
        elif case == "window_grid":
            args.update(window_tokens=16)
        elif case == "window_kv_len":
            jextra = dict(kv_len=jnp.asarray([s], jnp.int32))
            textra = dict(kv_len=torch.tensor([s]))
            args.update(window_tokens=16)
        elif case == "global_grid":
            bh2 = bh[..., :4]
            jextra["bias_h"] = jnp.asarray(_pack_pairs(bh2, 2))
            textra["bias_h"] = torch.from_numpy(np.ascontiguousarray(bh2))
        jblocks = dict(block_q=s, block_k=s)
        with pytest.raises(ValueError, match=match):
            jax_fused((jq, jkv), **jextra, **args, **jblocks,
                      interpret=True)
        with pytest.raises(ValueError, match=match):
            port.flash_attention_fused_qkv(tq, tkv, **textra, **args)

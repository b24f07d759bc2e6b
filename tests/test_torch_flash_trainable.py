"""Port vs JAX: K6, the generic trainable flash attention (fp32).

The same numpy inputs go through the JAX ``flash_attention_trainable``
(Pallas in interpret mode, per-head (B, H, S, D) layout, as
tests/test_attention_grad.py runs it) and the port's
``flash_attention_trainable`` on CPU tensors (K6's plain PyTorch versions).
Values, the lse residual and the gradients of ``sum(out * cot)`` for q, k,
v and both bias factors agree to TOL = 2e-5 (abs and rel); the largest gap
measured is 1.4e-6 on gradients of max |g| about 3. Three cases: a bias on
one whole key grid whose width (7) is not a power of two, a bias over
several key tiles, and a ``kv_len`` padding mask. Each plain backward is
also held to torch autograd through the plain forward (1e-5). A fourth
input, a ``kv_len`` of 0 on one batch row, is held to JAX alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.ops.attention_grad import (
    _fwd_impl,
    flash_attention_trainable as jax_flash,
)
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

TOL = 2e-5
D = 64
SCALE = D ** -0.5

# name: (B, H, S, Kh, Kw, kv_len, JAX block_q, JAX block_k)
CASES = {
    "bias_7x7_one_tile": (2, 2, 49, 7, 7, None, 49, 49),
    "bias_16x16_four_key_tiles": (1, 2, 256, 16, 16, None, 128, 64),
    "kv_len": (2, 2, 128, 0, 0, (70, 128), 64, 64),
}
# Batch row 0 has kv_len 0: every key scores -1e30, so the forward averages
# V, the lse is -1e30 and the backward (JAX's _recompute_p_ds) takes P = 1
# per key. That backward is not autograd of the forward (whose output does
# not depend on q or k there), so this case is held to JAX only.
KV_LEN_ZERO = (2, 2, 128, 0, 0, (0, 100), 64, 64)


def _inputs(seed, b, h, s, kh, kw, kv_len):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.normal(size=(b, h, s, D)).astype(np.float32)
                    for _ in range(4))
    bh = bw = None
    if kh:
        bh = (rng.normal(size=(b, h, s, kh)) * 0.3).astype(np.float32)
        bw = (rng.normal(size=(b, h, s, kw)) * 0.3).astype(np.float32)
    if kv_len is not None:
        kv_len = np.asarray(kv_len, np.int32)
    return q, k, v, bh, bw, kv_len, cot


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    b, h, s, kh, kw, kv_len, bq, bk = CASES[request.param]
    inputs = _inputs(sorted(CASES).index(request.param), b, h, s, kh, kw,
                     kv_len)
    return request.param, inputs, (bq, bk)


def _jax(inputs, blocks):
    q, k, v, bh, bw, kv_len, cot = inputs
    bq, bk = blocks
    kl = None if kv_len is None else jnp.asarray(kv_len)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bh is not None:
        args += [jnp.asarray(bh), jnp.asarray(bw)]

    def run(*a):
        bias = dict(bias_h=a[3], bias_w=a[4]) if len(a) == 5 else {}
        return jax_flash(*a[:3], **bias, kv_len=kl, block_q=bq, block_k=bk,
                         interpret=True)

    out = run(*args)
    grads = jax.grad(lambda *a: (run(*a) * cot).sum(),
                     argnums=tuple(range(len(args))))(*args)
    grads = [np.asarray(g) for g in grads] + [None] * (5 - len(args))
    return np.asarray(out), grads


def _port(inputs):
    q, k, v, bh, bw, kv_len, cot = inputs
    args = [None if a is None else torch.tensor(a, requires_grad=True)
            for a in (q, k, v, bh, bw)]
    out = G.flash_attention_trainable(
        *args, kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [None if a is None else a.grad.numpy()
                                  for a in args]


class TestPortVsJax:
    def test_values_and_gradients(self, case):
        _, inputs, blocks = case
        (out_p, g_p), (out_j, g_j) = _port(inputs), _jax(inputs, blocks)
        np.testing.assert_allclose(out_p, out_j, atol=TOL, rtol=TOL)
        for name, a, b in zip(("dq", "dk", "dv", "dbias_h", "dbias_w"),
                              g_p, g_j):
            if b is None:
                assert a is None, name
                continue
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=name)

    def test_lse_residual(self, case):
        """The forward's log2 log-sum-exp per row, against the JAX
        forward's (laid out (B, S/bq, H, bq))."""
        _, (q, k, v, bh, bw, kv_len, _), (bq, bk) = case
        t = [None if a is None else torch.from_numpy(a)
             for a in (q, k, v, bh, bw)]
        _, lse = G.flash_attention_fwd(
            *t, None if kv_len is None else torch.from_numpy(kv_len),
            scale=SCALE)
        _, jlse = _fwd_impl(
            *(None if a is None else jnp.asarray(a)
              for a in (q, k, v, bh, bw, kv_len)),
            scale=SCALE, block_q=bq, block_k=bk, interpret=True)
        b, nq, h, _ = jlse.shape
        jlse = np.asarray(jlse).transpose(0, 2, 1, 3).reshape(b, h, -1)
        np.testing.assert_allclose(lse.numpy(), jlse, atol=TOL, rtol=TOL)

    def test_kv_len_zero_row(self):
        """Values, lse and gradients on a batch with a kv_len 0 row; the
        row's gradients are sums of 128 unnormalised terms, so the
        tolerance is relative to each output's largest value there."""
        b, h, s, kh, kw, kv_len, bq, bk = KV_LEN_ZERO
        inputs = _inputs(11, b, h, s, kh, kw, kv_len)
        (out_p, g_p), (out_j, g_j) = _port(inputs), _jax(inputs, (bq, bk))
        np.testing.assert_allclose(out_p, out_j, atol=TOL, rtol=TOL)
        for name, a, b_ in zip(("dq", "dk", "dv"), g_p, g_j):
            assert np.abs(a[0]).max() > 0, name     # P = 1, not 0
            np.testing.assert_allclose(
                a, b_, atol=TOL * max(1.0, np.abs(b_).max()), rtol=TOL,
                err_msg=name)
        q, k, v = (torch.from_numpy(x) for x in inputs[:3])
        _, lse = G.flash_attention_fwd(q, k, v, None, None,
                                       torch.from_numpy(inputs[5]),
                                       scale=SCALE)
        assert (lse[0] == -1e30).all()

    def test_padded_keys_get_no_gradient(self):
        inputs = _inputs(7, *CASES["kv_len"][:6])
        _, grads = _port(inputs)
        assert not grads[1][0, :, 70:].any() and \
            not grads[2][0, :, 70:].any()


class TestPlainBackwards:
    """Each plain backward = torch autograd of the plain forward."""

    def test_dq_dkv(self, case):
        _, (q, k, v, bh, bw, kv_len, cot), _ = case
        kl = None if kv_len is None else torch.from_numpy(kv_len)
        args = [None if a is None else torch.tensor(a, requires_grad=True)
                for a in (q, k, v, bh, bw)]
        out, lse = G.flash_attention_fwd_plain(*args, kl, scale=SCALE)
        dout = torch.from_numpy(cot)
        want = torch.autograd.grad((out * dout).sum(),
                                   [a for a in args if a is not None])
        t = [None if a is None else a.detach() for a in args]
        rest = (dout, lse.detach(), G.flash_attention_delta(out.detach(),
                                                            dout))
        dq, dbh, dbw = G.flash_attention_bwd_dq_plain(*t, kl, *rest,
                                                      scale=SCALE)
        dk, dv = G.flash_attention_bwd_dkv_plain(*t, kl, *rest, scale=SCALE)
        got = [g for g in (dq, dk, dv, dbh, dbw) if g is not None]
        assert len(got) == len(want)
        for name, a, b in zip(("dq", "dk", "dv", "dbh", "dbw"), got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


class TestWrapper:
    def test_cpu_takes_no_kernel(self, case):
        _, inputs, _ = case
        A.reset_launch_counts()
        _port(inputs)
        assert not any(A.LAUNCHES.values()), A.LAUNCHES

    def test_cuda_tensor_goes_to_the_kernel(self, monkeypatch):
        """A non-CPU tensor never takes the plain path: an fp32 one reaches
        the kernel's launch (here stopped at the library load), any other
        dtype is refused."""
        def launch(*_, **__):
            raise RuntimeError("kernel launch reached")

        monkeypatch.setattr(G, "_load", launch)
        monkeypatch.setattr(G, "flash_attention_fwd_plain", None)
        q = torch.zeros(1, 2, 16, D, device="meta")
        with pytest.raises(RuntimeError, match="launch reached"):
            G.flash_attention_trainable(q, q, q)
        with pytest.raises(TypeError, match="float32"):
            G.flash_attention_trainable(*(q.to(torch.bfloat16),) * 3)

    @pytest.mark.parametrize("shapes,match", [
        (((1, 2, 16, D), (1, 2, 12, D)), "share one"),
        (((1, 2, 16, D), (1, 2, 16, D), (1, 2, 16, 3), (1, 2, 16, 5)),
         "Kh\\*Kw"),
    ])
    def test_layout_errors(self, shapes, match):
        ts = [torch.zeros(s) for s in shapes]
        q, k = ts[0], ts[1]
        bias = ts[2:] if len(ts) > 2 else (None, None)
        with pytest.raises(ValueError, match=match):
            G.flash_attention_fwd(q, k, q if k.shape == q.shape else k,
                                  *bias, scale=SCALE)

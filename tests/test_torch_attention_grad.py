"""Port vs JAX: trainable fused attention (K4 window backward, K5 global).

The same numpy inputs go through the JAX ``window_attention_trainable`` /
``global_attention_trainable`` (Pallas in interpret mode, pair-merged bias)
and the port's autograd Functions (plain PyTorch versions on CPU tensors,
per-head bias). Values and the gradients of ``sum(out * cot)`` for q, kv
and both bias factors agree to fp32 2e-4 (abs and rel), the tolerance of
tests/test_attention_grad.py. Each plain backward is also held to torch
autograd through its plain forward (1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.ops.attention_grad import (
    _fgt_fwd_impl,
    global_attention_trainable as jax_global,
    window_attention_trainable as jax_window,
)
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

TOL = 2e-4
HEADS, D = 4, 64
PAIR = A._head_group(HEADS, D)


def _pack(bias):
    """(B, H, S, K) per-head → (B, H/pair, S, pair·K) pair-merged."""
    b, h, s, k = bias.shape
    return bias.reshape(b, h // PAIR, PAIR, s, k).transpose(
        0, 1, 3, 2, 4).reshape(b, h // PAIR, s, PAIR * k)


def _unpack(bias, k):
    """(B, H/pair, S, pair·K) pair-merged → (B, H, S, K) per-head."""
    b, hp, s, _ = bias.shape
    return bias.reshape(b, hp, s, PAIR, k).transpose(0, 1, 3, 2, 4).reshape(
        b, hp * PAIR, s, k)


def _inputs(seed, b, kh, kw, bias=True):
    rng = np.random.default_rng(seed)
    s, c = kh * kw, HEADS * D
    q = (rng.normal(size=(b, s, c)) * 0.5).astype(np.float32)
    kv = (rng.normal(size=(b, s, 2 * c)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(b, s, c)).astype(np.float32)
    if not bias:
        return q, kv, None, None, cot
    bh = (rng.normal(size=(b, HEADS, s, kh)) * 0.3).astype(np.float32)
    bw = (rng.normal(size=(b, HEADS, s, kw)) * 0.3).astype(np.float32)
    return q, kv, bh, bw, cot


def _port(fn, q, kv, bh, bw, cot, **kw):
    args = [None if a is None else torch.tensor(a, requires_grad=True)
            for a in (q, kv, bh, bw)]
    out = fn(*args, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = [None if a is None else a.grad.numpy() for a in args]
    return out.detach().numpy(), grads


def _jax(fn, q, kv, bh, bw, cot, **kw):
    def loss(q, kv, bh, bw):
        return (fn(q, kv, bias_h=bh, bias_w=bw, **kw) * cot).sum()

    args = [jnp.asarray(q), jnp.asarray(kv)]
    if bh is not None:
        args += [jnp.asarray(_pack(bh)), jnp.asarray(_pack(bw))]
        out = fn(*args[:2], bias_h=args[2], bias_w=args[3], **kw)
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
        grads = [np.asarray(g) for g in grads]
        grads[2] = _unpack(grads[2], bh.shape[-1])
        grads[3] = _unpack(grads[3], bw.shape[-1])
    else:
        out = fn(*args, **kw)
        grads = jax.grad(lambda q, kv: loss(q, kv, None, None),
                         argnums=(0, 1))(*args)
        grads = [np.asarray(g) for g in grads] + [None, None]
    return np.asarray(out), grads


def _jax_lse(q, kv, bh, bw):
    """The JAX forward's lse residual (laid out (B, H/pair, S/bq, pair,
    bq)) as the port's (B, H, S)."""
    _, jlse = _fgt_fwd_impl(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(_pack(bh)),
        jnp.asarray(_pack(bw)), None, num_heads=HEADS, scale=D ** -0.5,
        block_q=64, block_k=64, schedule="base", interpret=True)
    b, hp, nq, pair, bq = jlse.shape
    return np.asarray(jlse).transpose(0, 1, 3, 2, 4).reshape(
        b, hp * pair, nq * bq)


def _assert_all(got, want):
    (out_p, g_p), (out_j, g_j) = got, want
    np.testing.assert_allclose(out_p, out_j, atol=TOL, rtol=TOL)
    for name, a, b in zip(("dq", "dkv", "dbias_h", "dbias_w"), g_p, g_j):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def window_case():
    """tests/test_attention_grad.py:154's shapes: 6 windows of 4x4."""
    return _inputs(1, 6, 4, 4)


@pytest.fixture(scope="module")
def global_case():
    """tests/test_attention_grad.py:278's shapes: one 8x16 grid."""
    return _inputs(2, 2, 8, 16)


class TestPortVsJax:
    def test_window_values_and_grads(self, window_case):
        q, kv, bh, bw, cot = window_case
        got = _port(G.window_attention_trainable, q, kv, bh, bw, cot,
                    num_heads=HEADS, window_tokens=16)
        want = _jax(jax_window, q, kv, bh, bw, cot, num_heads=HEADS,
                    window_tokens=16, window_batch=2, interpret=True)
        _assert_all(got, want)

    def test_global_values_and_grads(self, global_case):
        q, kv, bh, bw, cot = global_case
        got = _port(G.global_attention_trainable, q, kv, bh, bw, cot,
                    num_heads=HEADS)
        want = _jax(jax_global, q, kv, bh, bw, cot, num_heads=HEADS,
                    block_q=64, block_k=32, interpret=True)
        _assert_all(got, want)

    def test_global_kv_len_values_and_grads(self):
        q, kv, _, _, cot = _inputs(3, 2, 8, 16, bias=False)
        kv_len = np.array([77, 128], np.int32)
        got = _port(G.global_attention_trainable, q, kv, None, None, cot,
                    kv_len=torch.from_numpy(kv_len), num_heads=HEADS)
        want = _jax(jax_global, q, kv, None, None, cot,
                    kv_len=jnp.asarray(kv_len), num_heads=HEADS,
                    block_q=64, block_k=64, interpret=True)
        _assert_all(got, want)

    def test_global_kw64_values_lse_and_grads(self):
        """The width the Hopper route takes (Kw 64; S = 5 × 64, ragged
        against the kernel's 192-row blocks): out, the lse residual and
        every gradient against JAX. The inputs are bf16 values (what the
        `fast` path hands the kernels) carried in fp32, so both sides run
        at fp32 precision under the same tolerance."""
        q, kv, bh, bw, cot = (
            torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for a in _inputs(4, 2, 5, 64))
        got = _port(G.global_attention_trainable, q, kv, bh, bw, cot,
                    num_heads=HEADS)
        want = _jax(jax_global, q, kv, bh, bw, cot, num_heads=HEADS,
                    block_q=64, block_k=64, interpret=True)
        _assert_all(got, want)
        _, lse = G.global_attention_fwd_lse(
            *(torch.from_numpy(a) for a in (q, kv, bh, bw)), None,
            num_heads=HEADS, scale=D ** -0.5)
        np.testing.assert_allclose(lse.numpy(), _jax_lse(q, kv, bh, bw),
                                   atol=TOL, rtol=TOL)

    def test_global_kw128_values_lse_and_grads(self):
        """A key grid 128 keys wide (Kh 2: S = 256), which JAX's K5 takes
        and the port's kernels take on their mma.sync loops: out, the lse
        residual and every gradient against JAX, bf16 values carried in
        fp32 as above."""
        q, kv, bh, bw, cot = (
            torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for a in _inputs(5, 2, 2, 128))
        got = _port(G.global_attention_trainable, q, kv, bh, bw, cot,
                    num_heads=HEADS)
        want = _jax(jax_global, q, kv, bh, bw, cot, num_heads=HEADS,
                    block_q=64, block_k=128, interpret=True)
        _assert_all(got, want)
        _, lse = G.global_attention_fwd_lse(
            *(torch.from_numpy(a) for a in (q, kv, bh, bw)), None,
            num_heads=HEADS, scale=D ** -0.5)
        np.testing.assert_allclose(lse.numpy(), _jax_lse(q, kv, bh, bw),
                                   atol=TOL, rtol=TOL)

    def test_lse_residual(self, global_case):
        """The K5 forward's residual: log2 log-sum-exp per row and head,
        against the JAX forward's (laid out (B, H/pair, S/bq, pair, bq))."""
        q, kv, bh, bw, _ = global_case
        out, lse = G.global_attention_fwd_lse(
            *(torch.from_numpy(a) for a in (q, kv, bh, bw)), None,
            num_heads=HEADS, scale=D ** -0.5)
        np.testing.assert_allclose(lse.numpy(), _jax_lse(q, kv, bh, bw),
                                   atol=TOL, rtol=TOL)

    def test_cpu_takes_no_kernel(self, window_case):
        q, kv, bh, bw, cot = window_case
        A.reset_launch_counts()
        _port(G.window_attention_trainable, q, kv, bh, bw, cot,
              num_heads=HEADS, window_tokens=16)
        assert not any(A.LAUNCHES.values()), A.LAUNCHES


def _plain_autograd(fwd, q, kv, bh, bw, extra, cot, **kw):
    """Plain forward under torch autograd: (out, [dq, dkv, dbh, dbw])."""
    args = [None if a is None else torch.tensor(a, requires_grad=True)
            for a in (q, kv, bh, bw)]
    out = fwd(*args, *extra, **kw)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum(),
        [a for a in args if a is not None])
    return out.detach(), list(grads) + [None] * (4 - len(grads))


class TestPlainBackwards:
    """Each kernel's plain backward = torch autograd of its plain forward."""

    def test_window(self, window_case):
        q, kv, bh, bw, cot = window_case
        kw = dict(num_heads=HEADS, window_tokens=16, scale=D ** -0.5)
        out, want = _plain_autograd(A.fused_window_attention_plain, q, kv,
                                    bh, bw, (), cot, **kw)
        got = G.window_attention_bwd_plain(
            *(torch.from_numpy(a) for a in (q, kv, bh, bw)), out,
            torch.from_numpy(cot), **kw)
        for name, a, b in zip(("dq", "dkv", "dbh", "dbw"), got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                       msg=name)

    @pytest.mark.parametrize("bias", [True, False])
    def test_global_dq_dkv(self, global_case, bias):
        q, kv, bh, bw, cot = global_case
        kv_len = None
        if not bias:
            bh = bw = None
            kv_len = torch.tensor([100, 128])
        kw = dict(num_heads=HEADS, scale=D ** -0.5)
        out, want = _plain_autograd(A.fused_global_attention_plain, q, kv,
                                    bh, bw, (kv_len,), cot, **kw)
        t = [None if a is None else torch.from_numpy(a)
             for a in (q, kv, bh, bw)]
        out2, lse = G.global_attention_fwd_lse_plain(*t, kv_len, **kw)
        torch.testing.assert_close(out2, out, atol=1e-6, rtol=1e-6)
        dout = torch.from_numpy(cot)
        args = (*t, kv_len, dout, lse, G.attention_delta(out, dout, HEADS))
        dq, dbh, dbw = G.global_attention_bwd_dq_plain(*args, **kw)
        dkv = G.global_attention_bwd_dkv_plain(*args, **kw)
        for name, a, b in zip(("dq", "dkv", "dbh", "dbw"),
                              (dq, dkv, dbh, dbw), want):
            if b is None:
                assert a is None, name
                continue
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                       msg=name)


def test_cuda_tensor_never_takes_the_plain_path():
    """A non-CPU tensor is checked for the kernels and refused (fp32: the
    trainable kernels are bf16 only), not sent to the plain version."""
    q = torch.zeros(1, 16, 128, device="meta")
    kv = torch.zeros(1, 16, 256, device="meta")
    A.reset_launch_counts()
    with pytest.raises(TypeError, match="bfloat16"):
        G.global_attention_fwd_lse(q, kv, None, None, None, num_heads=2,
                                   scale=0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        G.window_attention_bwd(q, kv, None, None, q, q, num_heads=2,
                               window_tokens=16, scale=0.125)
    assert not any(A.LAUNCHES.values())


def test_k5_refuses_an_untileable_bias_grid():
    q = torch.zeros(1, 120, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.zeros(1, 120, 256, dtype=torch.bfloat16, device="meta")
    bh = torch.zeros(1, 2, 120, 10, dtype=torch.bfloat16, device="meta")
    bw = torch.zeros(1, 2, 120, 12, dtype=torch.bfloat16, device="meta")
    lse = torch.zeros(1, 2, 120, device="meta")
    with pytest.raises(ValueError, match="key-grid width"):
        G.global_attention_bwd_dq(q, kv, bh, bw, None, q, lse, lse,
                                  num_heads=2, scale=0.125)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_k5_bwd_route_is_plain_on_the_cpu(kernel):
    q = torch.zeros(1, 64, 128, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 256, dtype=torch.bfloat16)
    bh = torch.zeros(1, 2, 64, 1, dtype=torch.bfloat16)
    bw = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    assert G.global_attention_bwd_route(q, kv, bh, bw, num_heads=2,
                                        kernel=kernel) == "plain"


def test_k5_bwd_route_refuses_what_no_kernel_takes():
    """The route is asked of a kernel by name, and a non-CPU tensor is
    checked as a launch would check it (never answered "plain")."""
    q = torch.zeros(1, 120, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.zeros(1, 120, 256, dtype=torch.bfloat16, device="meta")
    bh = torch.zeros(1, 2, 120, 10, dtype=torch.bfloat16, device="meta")
    bw = torch.zeros(1, 2, 120, 12, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="'dq' or 'dkv'"):
        G.global_attention_bwd_route(q, kv, num_heads=2, kernel="dv")
    with pytest.raises(TypeError, match="bfloat16"):
        G.global_attention_bwd_route(q.float(), kv.float(), num_heads=2)
    with pytest.raises(ValueError, match="key-grid width"):
        G.global_attention_bwd_route(q, kv, bh, bw, num_heads=2)


@pytest.mark.parametrize("case", ["kw64", "kw16", "kv_len"])
def test_k5_fwd_route_is_plain_on_the_cpu(case):
    """The CPU takes the plain forward whatever the width (the card's
    answers, "hopper" at Kw 64 and 128 and with no bias, "loops" at Kw
    8/16/32, are held in tests/test_torch_cuda_kernels.py)."""
    kw = {"kw64": 64, "kw16": 16}.get(case)
    s = 128
    q = torch.zeros(1, s, 128, dtype=torch.bfloat16)
    kv = torch.zeros(1, s, 256, dtype=torch.bfloat16)
    bh = bw = kv_len = None
    if kw:
        bh = torch.zeros(1, 2, s, s // kw, dtype=torch.bfloat16)
        bw = torch.zeros(1, 2, s, kw, dtype=torch.bfloat16)
    else:
        kv_len = torch.tensor([77])
    assert G.global_attention_fwd_route(q, kv, bh, bw, kv_len,
                                        num_heads=2) == "plain"


@pytest.mark.parametrize("case,exc,err", [
    ("kw48", ValueError, "key-grid width"),
    ("fp32", TypeError, "bfloat16"),
    ("d32", ValueError, "head dim 32")])
@pytest.mark.parametrize("entry", ["route", "kernel"])
def test_k5_fwd_refused_before_launch(case, exc, err, entry):
    """What no K5 kernel takes is refused by the forward's route and by its
    wrapper before any build or launch, as the backward refuses it: a
    key-grid width outside (8, 16, 32, 64, 128) (Kw 48: S = 240, whose 64-key
    tiles would cut grid rows), fp32 and a head dim other than 64 (meta
    tensors stand in for CUDA ones)."""
    heads, d, dt = (4, 32, torch.bfloat16) if case == "d32" else \
        (2, 64, torch.float32 if case == "fp32" else torch.bfloat16)
    s, c = (240 if case == "kw48" else 256), heads * d

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=dt)

    q, kv = meta(1, s, c), meta(1, s, 2 * c)
    bh = bw = None
    if case == "kw48":
        bh, bw = meta(1, heads, s, 5), meta(1, heads, s, 48)
    A.reset_launch_counts()
    with pytest.raises(exc, match=err):
        if entry == "route":
            G.global_attention_fwd_route(q, kv, bh, bw, num_heads=heads)
        else:
            G.global_attention_fwd_lse(q, kv, bh, bw, None, num_heads=heads,
                                       scale=d ** -0.5)
    assert A.LAUNCHES["global_attention_fwd_lse"] == 0


@pytest.mark.parametrize("biased", [True, False])
def test_k4_bwd_route_is_plain_on_the_cpu_and_checks_the_layout(biased):
    """K4's route query answers "plain" for CPU tensors (the card's answers,
    "hopper" up to 208 tokens a window and "loops" beyond, are held in
    tests/test_torch_cuda_kernels.py) and refuses what the wrapper
    refuses: a bias grid that is not the window, a window that does not
    divide S, and (on a non-CPU tensor, before any build) fp32."""
    q = torch.zeros(2, 98, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 98, 256, dtype=torch.bfloat16)
    bh = torch.zeros(2, 2, 98, 7, dtype=torch.bfloat16) if biased else None
    bw = torch.zeros(2, 2, 98, 7, dtype=torch.bfloat16) if biased else None
    kw = dict(num_heads=2, window_tokens=49, scale=0.125)
    assert G.window_attention_bwd_route(q, kv, bh, bw, **kw) == "plain"
    if biased:
        with pytest.raises(ValueError, match="per-window bias grid"):
            G.window_attention_bwd_route(q, kv, bh[..., :3], bw, **kw)
    with pytest.raises(ValueError, match="window_tokens 40"):
        G.window_attention_bwd_route(q, kv, None, None, num_heads=2,
                                     window_tokens=40, scale=0.125)
    meta = [None if t is None else t.to("meta") for t in (q, kv, bh, bw)]
    with pytest.raises(TypeError, match="bfloat16"):
        G.window_attention_bwd_route(meta[0].float(), meta[1].float(),
                                     *[None if t is None else t.float()
                                       for t in meta[2:]], **kw)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("answer,body", [(1, "hopper"), (0, "loops")])
@pytest.mark.parametrize("kh,kw", [(128, 128), (64, 64), (0, 0)])
def test_bwd_route_names_the_c_entrys_body(kernel, answer, body, kh, kw,
                                           monkeypatch):
    """On a non-CPU tensor the K5 backward's route asks its source's C entry
    (vdr_global_attention_bwd_route) with (S, H, D, Kh, Kw, biased) and
    reports "hopper" or "loops" by its answer; the entry is replaced by a
    stand-in (meta tensors stand in for CUDA ones)."""
    asked, loaded = [], []

    def stand_in(*a):
        asked.append(a)
        return answer

    def load(name, argtypes, entry=None):
        loaded.append((name, entry))
        return None, stand_in

    monkeypatch.setattr(G, "_load", load)
    heads, d, s, dt = 12, 64, (kh * kw or 320), torch.bfloat16

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=dt)

    q, kv = meta(1, s, heads * d), meta(1, s, 2 * heads * d)
    bh = meta(1, heads, s, kh) if kh else None
    bw = meta(1, heads, s, kw) if kh else None
    assert G.global_attention_bwd_route(q, kv, bh, bw, num_heads=heads,
                                        kernel=kernel) == body
    assert asked == [(s, heads, d, kh, kw, int(kh > 0))]
    assert loaded == [(f"global_attention_bwd_{kernel}",
                       "vdr_global_attention_bwd_route")]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_k6_bwd_route_is_plain_on_the_cpu(kernel):
    """K6's backward route answers "plain" for CPU tensors (the card's
    answers, "hopper" with no bias or Kw 48 and "mma" at other widths, are
    held in tests/test_torch_cuda_kernels.py) and checks the layout."""
    q = torch.zeros(1, 2, 240, 64, dtype=torch.bfloat16)
    bh, bw = torch.zeros(1, 2, 240, 5), torch.zeros(1, 2, 240, 48)
    assert G.flash_attention_bwd_route(q, q, q, bh, bw,
                                       kernel=kernel) == "plain"
    with pytest.raises(ValueError, match="Kh\\*Kw"):
        G.flash_attention_bwd_route(q, q, q, bh[..., :4], bw, kernel=kernel)
    with pytest.raises(ValueError, match="'dq' or 'dkv'"):
        G.flash_attention_bwd_route(q, q, q, kernel="dv")


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("answer,counter", [
    (2, "_hopper"), (1, "_bf16"), (0, "")])
def test_k6_bwd_counts_the_body_its_entry_reports(kernel, answer, counter,
                                                  monkeypatch):
    """A K6 backward wrapper counts each launch under the body that ran, as
    its bf16 C entry reports it through its last argument: ``_hopper`` for
    the TMA + wgmma bodies (2), ``_bf16`` for the mma.sync ones (1); an
    fp32 call (answer 0) passes no such argument and counts under the fp32
    build's name. No route entry is asked. The entries are stand-ins and
    meta tensors stand in for CUDA ones."""
    asked, argc = [], []

    def entry_fn(*args):
        argc.append(len(args))
        if answer:
            args[-1]._obj.value = answer
        return 0

    def load(name, argtypes, entry=None):
        asked.append(entry)
        return None, entry_fn

    monkeypatch.setattr(G, "_load", load)
    monkeypatch.setattr(G, "_stream", lambda t: None)
    dt = torch.float32 if answer == 0 else torch.bfloat16

    def meta(*shape, dtype=dt):
        return torch.empty(*shape, device="meta", dtype=dtype)

    q = meta(1, 2, 2304, 64)
    bh, bw = (meta(1, 2, 2304, 48, dtype=torch.float32) for _ in range(2))
    lse = meta(1, 2, 2304, dtype=torch.float32)
    fn = getattr(G, f"flash_attention_bwd_{kernel}")
    A.reset_launch_counts()
    fn(q, q, q, bh, bw, None, q, lse, lse, scale=0.125)
    source = f"flash_attention_bwd_{kernel}"
    assert {k: v for k, v in A.LAUNCHES.items() if v} == \
        {source + counter: 1}
    suffix = "_bf16" if answer else ""
    assert asked == [f"vdr_{source}{suffix}"]
    n_out = 3 if kernel == "dq" else 2
    assert argc == [9 + n_out + 8 + bool(answer)]


@pytest.mark.parametrize("answer,counter", [
    (2, "_hopper"), (1, "_bf16"), (0, "")])
def test_k6_fwd_counts_the_body_its_entry_reports(answer, counter,
                                                  monkeypatch):
    """The K6 forward wrapper counts each launch as the backward's do: in
    bf16 under the body its C entry reports through its last argument
    (``_hopper`` for the TMA + wgmma body, ``_bf16`` for the mma.sync
    one), in fp32 (answer 0, no such argument) under the fp32 build's
    name. The entry is a stand-in and meta tensors stand in for CUDA
    ones."""
    asked, argc = [], []

    def entry_fn(*args):
        argc.append(len(args))
        if answer:
            args[-1]._obj.value = answer
        return 0

    def load(name, argtypes, entry=None):
        asked.append(entry)
        return None, entry_fn

    monkeypatch.setattr(G, "_load", load)
    monkeypatch.setattr(G, "_stream", lambda t: None)
    dt = torch.float32 if answer == 0 else torch.bfloat16
    q = torch.empty(1, 2, 2304, 64, device="meta", dtype=dt)
    bh, bw = (torch.empty(1, 2, 2304, 48, device="meta") for _ in range(2))
    A.reset_launch_counts()
    out, lse = G.flash_attention_fwd(q, q, q, bh, bw, None, scale=0.125)
    assert {k: v for k, v in A.LAUNCHES.items() if v} == \
        {"flash_attention_fwd" + counter: 1}
    assert asked == ["vdr_flash_attention_fwd" + ("_bf16" if answer else "")]
    assert argc == [8 + 8 + bool(answer)]
    assert out.shape == q.shape and lse.shape == (1, 2, 2304)


class _Built(Exception):
    """Raised in place of a kernel build: every check before it passed."""


@pytest.mark.parametrize("entry", ["fwd_route", "fwd", "bwd_route_dq",
                                   "bwd_route_dkv", "dq", "dkv"])
def test_k5_kw128_reaches_the_kernels(entry, monkeypatch):
    """A key grid 128 keys wide (SAM's global layers at 2048 px, which JAX
    takes) passes every check of the three K5 wrappers and their routes
    and goes on to the build, where the three routes answer "hopper" (the
    card tests hold that and the kernels); meta tensors stand in for CUDA
    ones and the build is replaced by a marker."""
    def built(*args, **kwargs):
        raise _Built()

    monkeypatch.setattr(G, "_load", built)
    heads, d, s, dt = 2, 64, 256, torch.bfloat16

    def meta(*shape, dtype=dt):
        return torch.empty(*shape, device="meta", dtype=dtype)

    q, kv = meta(1, s, heads * d), meta(1, s, 2 * heads * d)
    bh, bw = meta(1, heads, s, 2), meta(1, heads, s, 128)
    lse = meta(1, heads, s, dtype=torch.float32)
    kw = dict(num_heads=heads)
    calls = {
        "fwd_route": lambda: G.global_attention_fwd_route(q, kv, bh, bw,
                                                          **kw),
        "fwd": lambda: G.global_attention_fwd_lse(q, kv, bh, bw, None,
                                                  scale=0.125, **kw),
        "bwd_route_dq": lambda: G.global_attention_bwd_route(
            q, kv, bh, bw, kernel="dq", **kw),
        "bwd_route_dkv": lambda: G.global_attention_bwd_route(
            q, kv, bh, bw, kernel="dkv", **kw),
        "dq": lambda: G.global_attention_bwd_dq(q, kv, bh, bw, None, q, lse,
                                                lse, scale=0.125, **kw),
        "dkv": lambda: G.global_attention_bwd_dkv(q, kv, bh, bw, None, q,
                                                  lse, lse, scale=0.125,
                                                  **kw),
    }
    A.reset_launch_counts()
    with pytest.raises(_Built):
        calls[entry]()
    assert not any(A.LAUNCHES.values())

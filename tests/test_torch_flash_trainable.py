"""Port vs JAX: K6, the generic trainable flash attention, in fp32 and bf16.

The same numpy inputs go through the JAX ``flash_attention_trainable``
(Pallas in interpret mode, per-head (B, H, S, D) layout, as
tests/test_attention_grad.py runs it) and the port's
``flash_attention_trainable`` on CPU tensors (K6's plain PyTorch versions).

fp32: values, the lse residual and the gradients of ``sum(out * cot)`` for
q, k, v and both bias factors agree to TOL = 2e-5 (abs and rel); the
largest gap measured is 1.4e-6 on gradients of max |g| about 3. Three
cases: a bias on one whole key grid whose width (7) is not a power of two,
a bias over several key tiles, and a ``kv_len`` padding mask. Each plain
backward is also held to torch autograd through the plain forward (1e-5).
A fourth input, a ``kv_len`` of 0 on one batch row, is held to JAX alone.

bf16: the same three cases, a key grid 48 keys wide (SAM's global grid
at 768 px) over several JAX key tiles (S 192 = 4 x 48, blocks of 96), a
12 x 20 grid (a width of 4 mod 8, as SAM's at 576-960 px) over three key
tiles (blocks of 80), and SAM's global grids at 640 px (40 x 40) and 896 px (56 x 56) at two heads
(blocks of eight grid rows), q, k and v rounded to bf16 on both sides, the bias fp32 as the fine-tuning path
gives it. The port's plain versions round where the JAX kernels' source
does (Q^, the bias terms, P before P·V, dS before each product and the
bias sums, P before dV). By default XLA on the CPU drops an fp32 → bf16 →
fp32 round trip and so most of those roundings; the JAX side therefore runs
in a process of its own with ``--xla_allow_excess_precision=false``
(``JAX_STRICT_FLAGS``), where it rounds as its source says. Each case runs
JAX twice:

* at one key tile (block_k = S): JAX's online softmax then rounds P
  against the row's final max, as the plain versions do, and the two sides
  round at the same points on the same values. Measured: out, dq, dk, dbias
  equal bit for bit; dv, out and lse off in a few elements. Held, per
  output, to a mean gap of at most ONE_TILE_MEAN_TOL = 1e-4 of the mean
  |value| (measured at most 2.9e-6, dv) and a largest gap of one bf16 step
  of the output's max |value|. Leaving out any one rounding point (Q^, the
  bias terms, P in the forward, dS before dq or before dk, P before dv)
  moves the output it feeds by a mean of 1.0e-3 to 2.7e-3 of its mean
  |value|: ten times the limit or more.
* at the case's own key tiles: JAX rounds P per tile against the running
  max, the plain versions against the final one, so single roundings flip
  and the gap is about one bf16 step of each output's largest value.
  Measured over the four cases, each at its test seed and at another: out,
  dq, dk and dv at most 0.0090 of the output's max |value|, dbias_h 0.0086
  and dbias_w 0.0075. Held to BF16_TOL = 0.01 of each output's max |value|.

The fp32 lse agrees at both: at most 9.5e-7 apart (one fp32 step); held to
LSE_BF16_TOL = 2e-6. A rounding point left out of the scores moves it by
2e-4 or more.

One rounding of JAX's is not followed: where a key tile holds fewer key-grid
rows than Kh, the dq kernel rounds each tile's dbias_h row sums to bf16
before it adds them to the fp32 result (JAX attention_grad.py:252). The
port has no key-tile size of its own to follow and sums dbias_h in fp32, as
JAX does at one key tile; the difference is at most one bf16 rounding of
each dbias_h element, inside BF16_TOL.
"""

import os
import subprocess
import sys
from pathlib import Path

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
# bf16: the fp32 cases, a key grid 48 keys wide over four JAX key tiles,
# one 20 keys wide (4 mod 8, as SAM's grids at 576, 704, 832 and 960 px)
# over three key tiles of four grid rows, and SAM ViT-B/16's global grids
# at 640 px (40 x 40) and 896 px (56 x 56) at two heads, over five and
# seven JAX key tiles of eight grid rows
BF16_CASES = dict(CASES, kw48_four_key_tiles=(1, 2, 192, 4, 48, None, 96,
                                              96),
                  kw20_three_key_tiles=(1, 2, 240, 12, 20, None, 80, 80),
                  sam640_grid=(1, 2, 1600, 40, 40, None, 320, 320),
                  sam896_grid=(1, 2, 3136, 56, 56, None, 448, 448))
BF16_TOL = 0.01
ONE_TILE_MEAN_TOL = 1e-4
LSE_BF16_TOL = 2e-6
# XLA keeps every fp32 -> bf16 -> fp32 round trip the JAX kernels write
JAX_STRICT_FLAGS = "--xla_allow_excess_precision=false"
BF16_OUTPUTS = ("out", "lse", "dq", "dk", "dv", "dbias_h", "dbias_w")
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


def _jax(inputs, blocks, dtype=jnp.float32):
    q, k, v, bh, bw, kv_len, cot = inputs
    bq, bk = blocks
    kl = None if kv_len is None else jnp.asarray(kv_len)
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    if bh is not None:
        args += [jnp.asarray(bh), jnp.asarray(bw)]

    def run(*a):
        bias = dict(bias_h=a[3], bias_w=a[4]) if len(a) == 5 else {}
        return jax_flash(*a[:3], **bias, kv_len=kl, block_q=bq, block_k=bk,
                         interpret=True)

    out = run(*args)
    grads = jax.grad(lambda *a: (run(*a) * cot).sum(),
                     argnums=tuple(range(len(args))))(*args)
    grads = [np.asarray(g.astype(jnp.float32)) for g in grads] + \
        [None] * (5 - len(args))
    return np.asarray(out.astype(jnp.float32)), grads


def _port(inputs, dtype=torch.float32):
    q, k, v, bh, bw, kv_len, cot = inputs
    args = [None if a is None else
            torch.tensor(a).to(dtype if i < 3 else torch.float32)
            .requires_grad_() for i, a in enumerate((q, k, v, bh, bw))]
    out = G.flash_attention_trainable(
        *args, kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().float().numpy(), [
        None if a is None else a.grad.float().numpy() for a in args]


def _jax_lse(inputs, blocks, dtype=jnp.float32):
    """The JAX forward's lse, (B, S/bq, H, bq) laid out as (B, H, S)."""
    q, k, v, bh, bw, kv_len, _ = inputs
    _, lse = _fwd_impl(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
        *(None if a is None else jnp.asarray(a) for a in (bh, bw, kv_len)),
        scale=SCALE, block_q=blocks[0], block_k=blocks[1], interpret=True)
    b, _, h, _ = lse.shape
    return np.asarray(lse).transpose(0, 2, 1, 3).reshape(b, h, -1)


def _port_lse(inputs, dtype=torch.float32):
    q, k, v, bh, bw, kv_len, _ = inputs
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    t += [None if a is None else torch.from_numpy(a) for a in (bh, bw)]
    return G.flash_attention_fwd(
        *t, None if kv_len is None else torch.from_numpy(kv_len),
        scale=SCALE)[1].numpy()


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
        _, inputs, blocks = case
        np.testing.assert_allclose(_port_lse(inputs), _jax_lse(inputs, blocks),
                                   atol=TOL, rtol=TOL)

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


def _bf16_inputs(name):
    b, h, s, kh, kw, kv_len = BF16_CASES[name][:6]
    return _inputs(20 + sorted(BF16_CASES).index(name), b, h, s, kh, kw,
                   kv_len)


def _bf16_jax_main(name, path):
    """The JAX side of bf16 case ``name``, saved to ``path`` (npz): every
    output of ``BF16_OUTPUTS`` at the case's key tiles (``tiles/<out>``)
    and at one key tile (``one_tile/<out>``). Run in a process whose
    XLA_FLAGS hold ``JAX_STRICT_FLAGS`` (module docstring)."""
    jax.config.update("jax_platforms", "cpu")
    bq, bk = BF16_CASES[name][6:]
    s = BF16_CASES[name][2]
    inputs = _bf16_inputs(name)
    res = {}
    for run, blocks in (("tiles", (bq, bk)), ("one_tile", (bq, s))):
        out, grads = _jax(inputs, blocks, jnp.bfloat16)
        lse = _jax_lse(inputs, blocks, jnp.bfloat16)
        for label, x in zip(BF16_OUTPUTS, (out, lse, *grads)):
            if x is not None:
                res[f"{run}/{label}"] = x
    np.savez(path, **res)


def _as_outputs(out_grads, lse):
    out, (dq, dk, dv, dbh, dbw) = out_grads
    return dict(zip(BF16_OUTPUTS, (out, lse, dq, dk, dv, dbh, dbw)))


@pytest.fixture(scope="module", params=sorted(BF16_CASES))
def bf16_runs(request, tmp_path_factory):
    """Both sides on bf16 q, k, v: (port outputs, JAX outputs at the
    case's key tiles, JAX outputs at one key tile), each a dict over
    ``BF16_OUTPUTS`` (None where the case has no bias)."""
    name = request.param
    path = tmp_path_factory.mktemp("k6_bf16") / f"{name}.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} "
                         f"{JAX_STRICT_FLAGS}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(root), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, name, str(path)],
                         env=env, cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    jax_out = dict(np.load(path))
    inputs = _bf16_inputs(name)
    port = _as_outputs(_port(inputs, torch.bfloat16),
                       _port_lse(inputs, torch.bfloat16))
    return port, *({label: jax_out.get(f"{run}/{label}")
                    for label in BF16_OUTPUTS}
                   for run in ("tiles", "one_tile"))


def _assert_bf16_close(got, want, name):
    """|got - want| <= BF16_TOL · the output's max |value| (module
    docstring)."""
    limit = BF16_TOL * np.abs(want).max()
    gap = np.abs(got - want).max()
    assert gap <= limit, (name, gap, limit)


def _bf16_step(x):
    """One bf16 step (the spacing of bf16 numbers) at |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


class TestBf16PortVsJax:
    def test_values_and_gradients(self, bf16_runs):
        """Against JAX at the case's key tiles: BF16_TOL of each output's
        max |value|."""
        port, jax_tiles, _ = bf16_runs
        for name in BF16_OUTPUTS:
            if name == "lse":
                continue
            if jax_tiles[name] is None:
                assert port[name] is None, name
                continue
            _assert_bf16_close(port[name], jax_tiles[name], name)

    def test_lse_residual(self, bf16_runs):
        port, jax_tiles, jax_one = bf16_runs
        for want in (jax_tiles["lse"], jax_one["lse"]):
            np.testing.assert_allclose(port["lse"], want, atol=LSE_BF16_TOL,
                                       rtol=0)

    def test_rounding_points_at_one_key_tile(self, bf16_runs):
        """Against JAX at one key tile, where both sides round at the same
        points on the same values: per output a mean gap of at most
        ONE_TILE_MEAN_TOL of the mean |value| and a largest gap of one
        bf16 step of the max |value| (module docstring)."""
        port, _, jax_one = bf16_runs
        for name in BF16_OUTPUTS:
            if name == "lse":
                continue
            got, want = port[name], jax_one[name]
            if want is None:
                assert got is None, name
                continue
            gap = np.abs(got - want)
            assert gap.mean() <= ONE_TILE_MEAN_TOL * np.abs(want).mean(), \
                (name, gap.mean() / np.abs(want).mean())
            assert gap.max() <= _bf16_step(np.abs(want).max()), \
                (name, gap.max())

    def test_dtypes(self):
        """Outputs take q's, k's and v's dtype, the bias gradients the
        bias's (JAX :492-493, :572-573); fp32 plain results unchanged by
        the bf16 rounding points (each is a no-op on fp32)."""
        inputs = _inputs(5, *BF16_CASES["kw48_four_key_tiles"][:6])
        q, k, v, bh, bw, _, cot = inputs
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
        bias = [torch.from_numpy(a) for a in (bh, bw)]
        out, lse = G.flash_attention_fwd_plain(*t, *bias, None, scale=SCALE)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        dout = torch.from_numpy(cot).to(torch.bfloat16)
        rest = (dout, lse, G.flash_attention_delta(out, dout))
        dq, dbh, dbw = G.flash_attention_bwd_dq_plain(*t, *bias, None, *rest,
                                                      scale=SCALE)
        dk, dv = G.flash_attention_bwd_dkv_plain(*t, *bias, None, *rest,
                                                 scale=SCALE)
        assert {x.dtype for x in (dq, dk, dv)} == {torch.bfloat16}
        assert dbh.dtype == dbw.dtype == torch.float32


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
        """A non-CPU tensor never takes the plain path: an fp32 or bf16 one
        reaches its build's launch (here stopped at the library load), any
        other dtype is refused."""
        entries = []

        def launch(_, __, entry=None):
            entries.append(entry)
            raise RuntimeError("kernel launch reached")

        monkeypatch.setattr(G, "_load", launch)
        monkeypatch.setattr(G, "flash_attention_fwd_plain", None)
        q = torch.zeros(1, 2, 16, D, device="meta")
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(RuntimeError, match="launch reached"):
                G.flash_attention_trainable(*(q.to(dt),) * 3)
        assert entries == ["vdr_flash_attention_fwd",
                           "vdr_flash_attention_fwd_bf16"]
        with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
            G.flash_attention_trainable(*(q.to(torch.float16),) * 3)

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


if __name__ == "__main__":
    _bf16_jax_main(*sys.argv[1:])

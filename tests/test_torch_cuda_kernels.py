"""The CUDA kernels against their plain versions, on the card.

These tests build ``csrc/*.cu`` with nvcc and need an NVIDIA GPU; without
one they skip (the ``cuda`` marker). Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
``chip_smoke.py`` covers the same kernels at the main path's full shapes.
"""

import pytest
import torch

from vit_deep_radiomics_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

# |got - want| <= ATOL + RTOL·|want| elementwise: in bf16 both sides round
# the output, one step (at most 2^-7·|want|) apart; ATOL bounds the fp32 gap
# before that rounding, as in chip_smoke.py. At these shapes the bf16 gap
# measured on an H100 SXM is 4.09e-3 (window) and 3.04e-3 (global, the
# larger of its two cases), fp32 at most 1.6e-6; the limits are about 1.5
# times that (fewer keys than the main path: more peaked rows, larger gaps).
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
ATOL = {"window": {torch.float32: 2e-5, torch.bfloat16: 6e-3},
        "global": {torch.float32: 2e-5, torch.bfloat16: 5e-3}}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernel, no CPU "
                    "interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(
        dtype)


def _assert_close(got, want, dtype, mode):
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - RTOL[dtype] * want.abs()).max().item()
    assert torch.isfinite(got).all() and gap <= ATOL[mode][dtype], gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_kernel_matches_plain(gen, dtype):
    b, heads, d, win = 6, 2, 64, 15       # 3x5 windows, ragged edges
    q = _rand(gen, b, 2 * win, heads * d, dtype=dtype)
    kv = _rand(gen, b, 2 * win, 2 * heads * d, dtype=dtype)
    bh = _rand(gen, b, heads, 2 * win, 3, dtype=dtype, scale=0.3)
    bw = _rand(gen, b, heads, 2 * win, 5, dtype=dtype, scale=0.3)
    kw = dict(num_heads=heads, window_tokens=win, scale=d ** -0.5)
    # bf16 takes the Hopper kernel (15 rows: one 64-row tile, 64 keys),
    # fp32 the register-tiled forward
    assert A.fused_window_attention_route(q, kv, bh, bw, **kw) == (
        "hopper" if dtype == torch.bfloat16 else "tiled")
    A.reset_launch_counts()
    got = A.fused_window_attention(q, kv, bh, bw, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_window_attention"] == 1
    want = A.fused_window_attention_plain(q, kv, bh, bw, **kw)
    _assert_close(got, want, dtype, "window")


# (key grid, windows per batch row, bias, the body the C entry takes)
WINDOW_CASES = {
    "sam_14x14": ((14, 14), 3, True, "hopper"),   # 196 tokens, 4 row tiles
    "grid_8x8": ((8, 8), 2, True, "hopper"),      # 64 tokens, one tile
    "grid_10x10": ((10, 10), 2, True, "hopper"),  # 100 tokens, 208 keys
    "grid_16x16": ((16, 16), 2, True, "hopper"),  # 256: bias rows unstaged
    "sam_no_bias": ((14, 14), 3, False, "hopper"),
    "over_256": ((17, 17), 2, True, "loops"),     # 289 tokens
    "terms_47": ((3, 44), 2, True, "hopper"),     # Kh + Kw = 47: 3 steps
    "terms_48": ((4, 44), 2, True, "loops"),      # 48 terms: past them
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_kernel_routes_match_plain(gen, case):
    """bf16 K1 at the window shapes of its routes: the Hopper kernel at
    each of its key widths (TMA boxes of exactly one window, so a batch
    row's next window is never read or written; keys padded to 64, 208
    or 256 and masked; 256-token windows keep two buffered items with the
    bias rows read from device memory) and at the most bias terms its
    three bias steps take, and for a window of more than 256 tokens or
    more terms the mma.sync loop."""
    (kh, kw), n_win, biased, route = WINDOW_CASES[case]
    b, heads, d, dt = 2, 2, 64, torch.bfloat16
    win = kh * kw
    s = n_win * win
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = None
    if biased:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kwargs = dict(num_heads=heads, window_tokens=win, scale=d ** -0.5)
    assert A.fused_window_attention_route(q, kv, bh, bw, **kwargs) == route
    A.reset_launch_counts()
    got = A.fused_window_attention(q, kv, bh, bw, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_window_attention"] == 1
    want = A.fused_window_attention_plain(q, kv, bh, bw, **kwargs)
    _assert_close(got, want, dt, "window")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_global_kernel_matches_plain(gen, dtype, with_bias):
    """fp32 runs the register-tiled body; the biased bf16 Kw 20 call the
    kept mma.sync loop of flash_attention_core.cuh (Kw is no multiple of
    64); the bf16 kv_len call the wgmma/TMA kernel with a ragged S."""
    b, heads, d, kh, kw = 2, 4, 64, 10, 20   # S = 200: ragged 64/128 tiles
    s = kh * kw
    q = _rand(gen, b, s, heads * d, dtype=dtype)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dtype)
    bh = bw = kv_len = None
    if with_bias:
        bh = _rand(gen, b, heads, s, kh, dtype=dtype, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dtype, scale=0.3)
    else:
        kv_len = torch.tensor([77, 200], device="cuda")
    got = A.fused_global_attention(q, kv, bh, bw, kv_len, num_heads=heads,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    want = A.fused_global_attention_plain(q, kv, bh, bw, kv_len,
                                          num_heads=heads, scale=d ** -0.5)
    _assert_close(got, want, dtype, "global")


@pytest.mark.parametrize("case", ["kw64", "kw64_ragged_rows", "kw128",
                                  "kv_len_ragged", "kv_len_zero",
                                  "kv_len_zero_ragged_s"])
def test_global_hopper_kernel_matches_plain(gen, case):
    """The shapes the wgmma/TMA kernel takes (bf16; Kw 64 or 128, or no
    bias): 8x64 and 4x128 key grids, a 5x64 grid whose second 192-row
    query block runs past S, and kv_len at a padded length with a ragged
    last key tile (77 of 512) or no valid key at all (the row averages V
    over its S keys, also where S = 200 leaves the last key tile
    ragged)."""
    b, heads, d, dt = 2, 4, 64, torch.bfloat16
    grids = {"kw64": (8, 64), "kw64_ragged_rows": (5, 64), "kw128": (4, 128)}
    kh, kw = grids.get(case, (0, 0))
    s = kh * kw or (200 if case == "kv_len_zero_ragged_s" else 512)
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = kv_len = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    else:
        kv_len = torch.tensor([77, 512] if case == "kv_len_ragged"
                              else [0, 150], device="cuda")
    A.reset_launch_counts()
    got = A.fused_global_attention(q, kv, bh, bw, kv_len, num_heads=heads,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_global_attention"] == 1
    want = A.fused_global_attention_plain(q, kv, bh, bw, kv_len,
                                          num_heads=heads, scale=d ** -0.5)
    _assert_close(got, want, dt, "global")


def test_kv_len_zero_row_matches_plain(gen):
    """A batch row with kv_len 0 (S = 200): K2's fp32 body and the three
    K5 kernels follow their plain versions, where every key of the row
    scores -1e30: the forward averages V, the lse is the plain version's
    (-1e30 log2 e), and the backward takes P = 1 per key from it."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d, s = 2, 4, 64, 200
    kv_len = torch.tensor([0, 150], device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    q = _rand(gen, b, s, heads * d, dtype=torch.float32)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=torch.float32)
    _assert_close(
        A.fused_global_attention(q, kv, None, None, kv_len, **kwargs),
        A.fused_global_attention_plain(q, kv, None, None, kv_len, **kwargs),
        torch.float32, "global")
    dt = torch.bfloat16
    q, kv = q.to(dt), kv.to(dt)
    out, lse = G.global_attention_fwd_lse(q, kv, None, None, kv_len,
                                          **kwargs)
    want_out, want_lse = G.global_attention_fwd_lse_plain(
        q, kv, None, None, kv_len, **kwargs)
    _assert_close(out, want_out, dt, "global")
    assert (lse - want_lse).abs().max().item() <= 1e-2
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    args = (q, kv, None, None, kv_len, dout, lse,
            G.attention_delta(out, dout, heads))
    got = (G.global_attention_bwd_dq(*args, **kwargs)[0],
           G.global_attention_bwd_dkv(*args, **kwargs))
    want = (G.global_attention_bwd_dq_plain(*args, **kwargs)[0],
            G.global_attention_bwd_dkv_plain(*args, **kwargs))
    for g_, w_, name in zip(got, want, ("dq", "dkv")):
        _assert_grad_close(g_[1:], w_[1:], name, "global")
    # Batch row 0 has P = 1 on all 200 keys, so its dS is some 200 times a
    # softmax row's, and the kernels round dS to bf16 as an mma operand:
    # hold each element of dq and dk to that rounding's worst case,
    # 2^-8 · scale · Σ |dS| |K| (|Q| for dk), beyond one bf16 step of the
    # output and the rule of the other rows; dv takes P = 1 exactly.
    c = heads * d

    def hs(x):   # batch row 0, (S, H·D) -> (H, S, D) in fp32
        return x[0].float().reshape(s, heads, -1).transpose(0, 1)

    ds = (hs(dout) @ hs(kv[..., c:]).transpose(-1, -2)
          - args[7][0][..., None]).abs()
    scale = d ** -0.5

    def rows(x):   # (H, S, D) -> (S, H·D)
        return x.transpose(0, 1).reshape(s, c)

    rounding = (rows(ds @ hs(kv[..., :c]).abs()),
                torch.cat([rows(ds.transpose(-1, -2) @ hs(q).abs()),
                           torch.zeros(s, c, device="cuda")], dim=-1))
    for g_, w_, r_, name in zip(got, want, rounding, ("dq", "dkv")):
        g_, w_ = g_[0].float(), w_[0].float()
        excess = ((g_ - w_).abs() - 2.0 ** -7 * w_.abs()
                  - 2.0 ** -8 * scale * r_).max().item()
        print(f"{name} kv_len 0 row: excess {excess:.3e}")
        assert torch.isfinite(g_).all() and excess <= GRAD_ATOL["global"], (
            name, excess)


# The trainable kernels (bf16 only) against their plain versions, which
# compute in fp32 from the same bf16 inputs; each output elementwise
# |got - want| <= GRAD_ATOL + 2^-7·|want|. At these shapes the largest gap
# measured on an H100 SXM is 8.97e-3 (K4, dbias_h) and 4.13e-3 (K5,
# dbias_w); the limits are about 1.5 times that.
GRAD_ATOL = {"window": 1.4e-2, "global": 6.5e-3}


def _assert_grad_close(got, want, name, mode):
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - 2.0 ** -7 * want.abs()).max().item()
    print(f"{name}: gap {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= GRAD_ATOL[mode], (name, gap)


def test_window_bwd_kernel_matches_plain(gen):
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d, win = 6, 2, 64, 15       # 3x5 windows, ragged edges
    dt = torch.bfloat16
    q = _rand(gen, b, 2 * win, heads * d, dtype=dt)
    kv = _rand(gen, b, 2 * win, 2 * heads * d, dtype=dt)
    bh = _rand(gen, b, heads, 2 * win, 3, dtype=dt, scale=0.3)
    bw = _rand(gen, b, heads, 2 * win, 5, dtype=dt, scale=0.3)
    kw = dict(num_heads=heads, window_tokens=win, scale=d ** -0.5)
    out = A.fused_window_attention(q, kv, bh, bw, **kw)
    dout = _rand(gen, b, 2 * win, heads * d, dtype=dt)
    A.reset_launch_counts()
    got = G.window_attention_bwd(q, kv, bh, bw, out, dout, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["window_attention_bwd"] == 1
    want = G.window_attention_bwd_plain(q, kv, bh, bw, out, dout, **kw)
    for g_, w_, name in zip(got, want, ("dq", "dkv", "dbh", "dbw")):
        _assert_grad_close(g_, w_, name, "window")


# K4 at the window shapes of its routes: (key grid, windows per batch row,
# bias, the body the C entry takes)
K4_CASES = {
    "grid_7x7": ((7, 7), 3, True, "hopper"),      # 49 tokens: N 64
    "grid_7x7_no_bias": ((7, 7), 3, False, "hopper"),
    "grid_10x10": ((10, 10), 2, True, "hopper"),  # 100: N 208, 2 tiles
    "sam_14x14": ((14, 14), 3, True, "hopper"),   # 196: N 208, 4 tiles
    "sam_no_bias": ((14, 14), 3, False, "hopper"),
    "grid_16x16": ((16, 16), 2, True, "loops"),   # 256 tokens, 33 terms
    "grid_16x16_no_bias": ((16, 16), 2, False, "loops"),
    "over_256": ((17, 17), 2, True, "loops"),     # 289 tokens
}


def _k4_inputs(gen, grid, n_win, biased, b=2, heads=2):
    kh, kw = grid
    win, dt = kh * kw, torch.bfloat16
    s = n_win * win
    q = _rand(gen, b, s, heads * 64, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * 64, dtype=dt)
    bh = bw = None
    if biased:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kwargs = dict(num_heads=heads, window_tokens=win, scale=0.125)
    out = A.fused_window_attention(q, kv, bh, bw, **kwargs)
    dout = _rand(gen, b, s, heads * 64, dtype=dt)
    return (q, kv, bh, bw, out, dout), kwargs


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_window_bwd_routes_match_plain(gen, case):
    """bf16 K4 at each key width of its Hopper body (TMA boxes of one
    window, rows past it read as zeros; keys padded to 64 or 208 and masked
    by E's mask term; 64-row query and key tiles), with and without the
    bias, and windows of 256 and 289 tokens on the mma.sync loops;
    every output against the plain version, several windows and heads a
    call (so items of other windows and heads sit beside each one)."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    grid, n_win, biased, route = K4_CASES[case]
    args, kwargs = _k4_inputs(gen, grid, n_win, biased)
    assert G.window_attention_bwd_route(*args[:4], **kwargs) == route
    A.reset_launch_counts()
    got = G.window_attention_bwd(*args, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["window_attention_bwd"] == 1
    want = G.window_attention_bwd_plain(*args, **kwargs)
    for g_, w_, name in zip(got, want, ("dq", "dkv", "dbh", "dbw")):
        if w_ is None:
            assert g_ is None, name
            continue
        _assert_grad_close(g_, w_, name, "window")


def test_window_bwd_hopper_is_deterministic_and_builds_without_spill(
        gen, tmp_path, monkeypatch):
    """No atomics: two launches of K4's Hopper body give the same bits; and
    its source (Hopper instances and loops) fits its registers: ptxas
    (-Xptxas -v, the build's flags) reports no spill."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    args, kwargs = _k4_inputs(gen, (14, 14), 3, True)
    runs = [G.window_attention_bwd(*args, **kwargs) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    log = cb.build_all(("window_attention_bwd",))["window_attention_bwd"]
    print([ln for ln in log.splitlines() if "registers" in ln])
    assert "spill" in log and cb.spill_bytes(log) == 0, log


@pytest.mark.parametrize("with_bias", [True, False])
def test_global_trainable_kernels_match_plain(gen, with_bias):
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d, kh, kw = 2, 4, 64, 13, 16   # S = 208: ragged 64/128 tiles
    s = kh * kw
    dt = torch.bfloat16
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = kv_len = None
    if with_bias:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    else:
        kv_len = torch.tensor([77, 208], device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    A.reset_launch_counts()
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kv_len, **kwargs)
    want_out, want_lse = G.global_attention_fwd_lse_plain(
        q, kv, bh, bw, kv_len, **kwargs)
    _assert_close(out, want_out, dt, "global")
    assert (lse - want_lse).abs().max().item() <= 1e-2
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    delta = G.attention_delta(out, dout, heads)
    args = (q, kv, bh, bw, kv_len, dout, lse, delta)
    got = (*G.global_attention_bwd_dq(*args, **kwargs),
           G.global_attention_bwd_dkv(*args, **kwargs))
    torch.cuda.synchronize()
    assert [A.LAUNCHES[k] for k in ("global_attention_fwd_lse",
                                    "global_attention_bwd_dq",
                                    "global_attention_bwd_dkv")] == [1, 1, 1]
    want = (*G.global_attention_bwd_dq_plain(*args, **kwargs),
            G.global_attention_bwd_dkv_plain(*args, **kwargs))
    for g_, w_, name in zip(got, want, ("dq", "dbh", "dbw", "dkv")):
        if w_ is not None:
            _assert_grad_close(g_, w_, name, "global")


def _k5_inputs(gen, b, heads, s, kh, kw, kv_len):
    """bf16 operands of the K5 backward and the forward's residuals."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    dt, d = torch.bfloat16, 64
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    if kv_len is not None:
        kv_len = torch.tensor(kv_len, device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kv_len, **kwargs)
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    return (q, kv, bh, bw, kv_len, dout, lse,
            G.attention_delta(out, dout, heads)), kwargs


# The Hopper bodies of the K5 backward (TMA + wgmma): a 5 x 64 key grid
# (S = 320, ragged against 128-row and 128-key blocks) and no bias with
# kv_len, one row at 77 keys or at none (every key at -1e30, P = 1 from
# the residual).
K5_HOPPER_CASES = {"kh5_kw64": (5, 64, None), "kv_len_77": (0, 0, [77, 320]),
                   "kv_len_0": (0, 0, [0, 320])}


@pytest.mark.parametrize("case", sorted(K5_HOPPER_CASES))
def test_global_hopper_bwd_matches_plain(gen, case):
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    kh, kw, kv_len = K5_HOPPER_CASES[case]
    b, heads, s, d = 2, 4, 320, 64
    args, kwargs = _k5_inputs(gen, b, heads, s, kh, kw, kv_len)
    for kernel in ("dq", "dkv"):
        assert G.global_attention_bwd_route(
            *args[:5], num_heads=heads, kernel=kernel) == "hopper"
    A.reset_launch_counts()
    got = (*G.global_attention_bwd_dq(*args, **kwargs),
           G.global_attention_bwd_dkv(*args, **kwargs))
    torch.cuda.synchronize()
    assert [A.LAUNCHES[k] for k in ("global_attention_bwd_dq",
                                    "global_attention_bwd_dkv")] == [1, 1]
    want = (*G.global_attention_bwd_dq_plain(*args, **kwargs),
            G.global_attention_bwd_dkv_plain(*args, **kwargs))
    names = ("dq", "dbh", "dbw", "dkv")
    if kv_len is None or kv_len[0] > 0:
        for g_, w_, name in zip(got, want, names):
            if w_ is not None:
                _assert_grad_close(g_, w_, name, "global")
        if kv_len is not None:
            assert not got[3][0, kv_len[0]:].any()
        return
    # a kv_len 0 row: the other row under the rule; row 0 has P = 1 on all
    # S keys, so dS is some S times a softmax row's and its bf16 rounding
    # as an mma operand is held to its worst case, 2^-8 scale sum |dS| |K|
    # (|Q| for dk), beyond one bf16 step (the rule of
    # test_kv_len_zero_row_matches_plain)
    q, kv, dout, delta = args[0], args[1], args[5], args[7]
    for g_, w_, name in zip(got, want, names):
        if w_ is not None:
            _assert_grad_close(g_[1:], w_[1:], name, "global")
    c, scale = heads * d, kwargs["scale"]

    def hs(x):   # batch row 0, (S, H·D) -> (H, S, D) in fp32
        return x[0].float().reshape(s, heads, -1).transpose(0, 1)

    def rows(x):   # (H, S, D) -> (S, H·D)
        return x.transpose(0, 1).reshape(s, c)

    ds = (hs(dout) @ hs(kv[..., c:]).transpose(-1, -2)
          - delta[0][..., None]).abs()
    rounding = (rows(ds @ hs(kv[..., :c]).abs()),
                torch.cat([rows(ds.transpose(-1, -2) @ hs(q).abs()),
                           torch.zeros(s, c, device="cuda")], dim=-1))
    for g_, w_, r_, name in zip((got[0], got[3]), (want[0], want[3]),
                                rounding, ("dq", "dkv")):
        g_, w_ = g_[0].float(), w_[0].float()
        excess = ((g_ - w_).abs() - 2.0 ** -7 * w_.abs()
                  - 2.0 ** -8 * scale * r_).max().item()
        print(f"{name} kv_len 0 row: excess {excess:.3e}")
        assert torch.isfinite(g_).all() and excess <= GRAD_ATOL["global"], (
            name, excess)


@pytest.mark.parametrize("case", sorted(K5_HOPPER_CASES))
def test_global_hopper_fwd_matches_plain(gen, case):
    """The K5 forward's Hopper body (K2's, with the lse store) at the
    backward's cases: out and lse against the plain version; a kv_len 0
    row averages V over its S keys and gets the plain version's lse,
    -1e30 log2 e + log2 S (the backward then takes P = 1 per key)."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    kh, kw, kv_len = K5_HOPPER_CASES[case]
    b, heads, s, d, dt = 2, 4, 320, 64, torch.bfloat16
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kl = None if kv_len is None else torch.tensor(kv_len, device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    assert G.global_attention_fwd_route(q, kv, bh, bw, kl,
                                        num_heads=heads) == "hopper"
    A.reset_launch_counts()
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kl, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["global_attention_fwd_lse"] == 1
    want_out, want_lse = G.global_attention_fwd_lse_plain(
        q, kv, bh, bw, kl, **kwargs)
    _assert_close(out, want_out, dt, "global")
    gap = (lse - want_lse).abs().max().item()
    print(f"{case}: lse gap {gap:.3e}")
    assert torch.isfinite(lse).all() and gap <= 1e-2
    if kv_len is not None and kv_len[0] == 0:
        assert torch.equal(lse[0], want_lse[0]), (lse[0], want_lse[0])


def _scores_as_the_kernel(q, kv, bh, bw, kv_len, heads, scale):
    """The scores the K5 kernels build, (B, H, S, S) in fp32 log2 units:
    Q^ = bf16(q · scale · log2 e), S = Q^ Kᵀ, plus the bias terms times
    log2 e, keys at or past kv_len at -1e30 log2 e."""
    log2e = 1.4426950408889634
    b, s, c = q.shape
    d = c // heads

    def hs(x):
        return x.float().reshape(b, s, heads, d).transpose(1, 2)

    qhat = (q.float() * (scale * log2e)).to(torch.bfloat16)
    sc = hs(qhat) @ hs(kv[..., :c]).transpose(-1, -2)
    if bh is not None:
        th, tw = bh.float() * log2e, bw.float() * log2e
        sc = sc + (th[..., :, None] + tw[..., None, :]).reshape(sc.shape)
    if kv_len is not None:
        masked = torch.tensor(-1e30, device=q.device) * log2e
        key = torch.arange(s, device=q.device)
        sc = torch.where((key[None, :] < kv_len[:, None])[:, None, None, :],
                         sc, masked)
    return sc


def _lse_as_the_backward_scores(q, kv, bh, bw, kv_len, heads, scale):
    """The log2 lse of the scores the K5 backward rebuilds, in fp32
    (``_scores_as_the_kernel``)."""
    sc = _scores_as_the_kernel(q, kv, bh, bw, kv_len, heads, scale)
    m = sc.amax(-1, keepdim=True)
    return (m + torch.log2(torch.exp2(sc - m).sum(-1, keepdim=True)))[..., 0]


# The K5 forward's lse against the lse of the scores the backward rebuilds
# (``_lse_as_the_backward_scores``): the order of the fp32 sums and the
# exp2 approximation alone. Measured on an H100 SXM: 9.54e-7 in both cases,
# one fp32 step at |lse| in [8, 16), where the plain version's unrounded
# fp32 scores sit 2.8e-3 to 3.5e-3 away (as would a forward that scaled
# the fp32 Q Kᵀ, K2's order); the limit is four such steps
LSE_REBUILT_ATOL = 4e-6


@pytest.mark.parametrize("case", ["kh5_kw64", "kv_len_77"])
def test_global_hopper_fwd_scores_as_the_backward(gen, case):
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    kh, kw, kv_len = K5_HOPPER_CASES[case]
    b, heads, s, d, dt = 2, 4, 320, 64, torch.bfloat16
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kl = None if kv_len is None else torch.tensor(kv_len, device="cuda")
    _, lse = G.global_attention_fwd_lse(q, kv, bh, bw, kl, num_heads=heads,
                                        scale=d ** -0.5)
    want = _lse_as_the_backward_scores(q, kv, bh, bw, kl, heads, d ** -0.5)
    gap = (lse - want).abs().max().item()
    print(f"{case}: lse against the backward's scores {gap:.3e}")
    assert gap <= LSE_REBUILT_ATOL, gap


@pytest.mark.parametrize("case", ["kh5_kw64", "kv_len_77"])
def test_global_kernel_chain_matches_plain_chain(gen, case):
    """The whole K5 chain: the kernel forward's out and lse fed to the
    kernel dq and dkv, against the plain forward's fed to the plain
    backward (a forward that scored unlike the backward would show in the
    gradients, not in out)."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    kh, kw, kv_len = K5_HOPPER_CASES[case]
    b, heads, s, d, dt = 2, 4, 320, 64, torch.bfloat16
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    bh = bw = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kl = None if kv_len is None else torch.tensor(kv_len, device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    grads = []
    for fwd, dq, dkv in (
            (G.global_attention_fwd_lse, G.global_attention_bwd_dq,
             G.global_attention_bwd_dkv),
            (G.global_attention_fwd_lse_plain,
             G.global_attention_bwd_dq_plain,
             G.global_attention_bwd_dkv_plain)):
        out, lse = fwd(q, kv, bh, bw, kl, **kwargs)
        args = (q, kv, bh, bw, kl, dout, lse,
                G.attention_delta(out, dout, heads))
        grads.append((*dq(*args, **kwargs), dkv(*args, **kwargs)))
    for g_, w_, name in zip(*grads, ("dq", "dbh", "dbw", "dkv")):
        if w_ is not None:
            _assert_grad_close(g_, w_, f"chain {name}", "global")


def test_global_hopper_fwd_is_deterministic(gen):
    """Two launches of the K5 forward give the same bits (out and lse), at
    Kw 64 and in kv_len mode."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    for case in ("kh5_kw64", "kv_len_77"):
        kh, kw, kv_len = K5_HOPPER_CASES[case]
        b, heads, s, d, dt = 2, 4, 320, 64, torch.bfloat16
        q = _rand(gen, b, s, heads * d, dtype=dt)
        kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
        bh = bw = None
        if kh:
            bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
            bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
        kl = None if kv_len is None else torch.tensor(kv_len, device="cuda")
        runs = [G.global_attention_fwd_lse(q, kv, bh, bw, kl, num_heads=heads,
                                           scale=d ** -0.5)
                for _ in range(2)]
        for a, b_ in zip(*runs):
            assert torch.equal(a, b_), case


def test_global_fwd_builds_without_spill(gen, tmp_path, monkeypatch):
    """The K5 forward's source fits its registers: its three Hopper kernels
    (no bias, Kw 64, Kw 128 in the halves order) and the loop show no spill
    and ptxas no wgmma serialisation (C75xx)."""
    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    log = cb.build_all(("global_attention_fwd_lse",))[
        "global_attention_fwd_lse"]
    funcs = cb.ptxas_functions(log)
    print(funcs)
    hopper = [f for f in funcs if "hopper_kernel" in f]
    assert len(hopper) == 3 and cb.spill_bytes(log) == 0, log
    assert "C75" not in log, log


@pytest.mark.parametrize("kh,kw,route", [(5, 64, "hopper"), (0, 0, "hopper"),
                                         (20, 16, "loops"),
                                         (4, 128, "hopper")])
def test_global_fwd_route(gen, kh, kw, route):
    """The K5 forward routes as the backward does: Kw 64, Kw 128 and no
    bias take the Hopper body, Kw 16 the mma.sync loop."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    s, heads = (kh * kw or 320), 2
    q = _rand(gen, 1, s, heads * 64, dtype=torch.bfloat16)
    kv = _rand(gen, 1, s, 2 * heads * 64, dtype=torch.bfloat16)
    bh = bw = None
    if kh:
        bh = _rand(gen, 1, heads, s, kh, dtype=torch.bfloat16)
        bw = _rand(gen, 1, heads, s, kw, dtype=torch.bfloat16)
    assert G.global_attention_fwd_route(q, kv, bh, bw,
                                        num_heads=heads) == route


@pytest.mark.parametrize("kh,kw,route", [(5, 64, "hopper"), (0, 0, "hopper"),
                                         (20, 16, "loops"),
                                         (4, 128, "hopper")])
def test_global_bwd_route(gen, kh, kw, route):
    """Kw 64, Kw 128 and no bias take the Hopper bodies, Kw 16 the mma.sync
    loops; the two kernels choose alike."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    s, heads = (kh * kw or 320), 2
    q = _rand(gen, 1, s, heads * 64, dtype=torch.bfloat16)
    kv = _rand(gen, 1, s, 2 * heads * 64, dtype=torch.bfloat16)
    bh = bw = None
    if kh:
        bh = _rand(gen, 1, heads, s, kh, dtype=torch.bfloat16)
        bw = _rand(gen, 1, heads, s, kw, dtype=torch.bfloat16)
    for kernel in ("dq", "dkv"):
        assert G.global_attention_bwd_route(q, kv, bh, bw, num_heads=heads,
                                            kernel=kernel) == route


# Kh 128 at B=1 (S = 16384, SAM @2048's global grid) fills the largest
# bias_h table the route takes, and its last grid row's odd tile comes
# after the swap of the bias_w register set
@pytest.mark.parametrize("kh,b", [(2, 2), (5, 2), (128, 1)])
def test_global_kw128_hopper_bodies_match_plain(gen, kh, b):
    """A key grid 128 keys wide (JAX takes it; SAM's global grid at 2048
    px): the K5 forward and the dq and dkv kernels take their Hopper
    bodies, where a 64-key tile is half a grid row, and each output
    matches its plain version; the kernel chain (the kernel forward's out
    and lse fed to the kernel dq and dkv) matches the plain chain."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    heads, d, kw, dt = 2, 64, 128, torch.bfloat16
    s = kh * kw
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
    bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    assert G.global_attention_fwd_route(q, kv, bh, bw,
                                        num_heads=heads) == "hopper"
    for kernel in ("dq", "dkv"):
        assert G.global_attention_bwd_route(q, kv, bh, bw, num_heads=heads,
                                            kernel=kernel) == "hopper"
    A.reset_launch_counts()
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, None, **kwargs)
    want_out, want_lse = G.global_attention_fwd_lse_plain(q, kv, bh, bw,
                                                          None, **kwargs)
    _assert_close(out, want_out, dt, "global")
    assert (lse - want_lse).abs().max().item() <= 4e-3
    for res in ((out, lse), (want_out, want_lse)):
        args = (q, kv, bh, bw, None, dout, res[1],
                G.attention_delta(res[0], dout, heads))
        got = (*G.global_attention_bwd_dq(*args, **kwargs),
               G.global_attention_bwd_dkv(*args, **kwargs))
        want = (*G.global_attention_bwd_dq_plain(*args, **kwargs),
                G.global_attention_bwd_dkv_plain(*args, **kwargs))
        for g_, w_, name in zip(got, want, ("dq", "dbh", "dbw", "dkv")):
            _assert_grad_close(g_, w_, name, "global")
    torch.cuda.synchronize()
    assert [A.LAUNCHES[k] for k in ("global_attention_fwd_lse",
                                    "global_attention_bwd_dq",
                                    "global_attention_bwd_dkv")] == [1, 2, 2]


# The K5 forward's Hopper body on a key grid 128 keys wide visits the even
# key tiles before the odd ones on one bias_w register set: Kh 1 is two
# tiles, Kh 3 an odd number of grid rows; kv_len "ragged" cuts row 0 at
# S - 59 keys (the last, odd tile ragged) and row 1 at 50 (one tile
# visited, no odd tile).
@pytest.mark.parametrize("kh", [1, 3, 32])
@pytest.mark.parametrize("kv_len", [None, "ragged"])
def test_global_hopper_fwd_kw128_matches_plain(gen, kh, kv_len):
    """Out and lse against the plain version (the rules of
    test_global_hopper_fwd_matches_plain), keys past kv_len leaving no
    trace, two launches with the same bits; at the shapes LSE_REBUILT_ATOL
    was measured at (S at most 384) the lse against the lse of the scores
    the backward rebuilds."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d, dt = 2, 2, 64, torch.bfloat16
    s = kh * 128
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
    bw = _rand(gen, b, heads, s, 128, dtype=dt, scale=0.3)
    kl = None
    if kv_len is not None:
        kl = torch.tensor([max(1, s - 59), 50], device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    assert G.global_attention_fwd_route(q, kv, bh, bw, kl,
                                        num_heads=heads) == "hopper"
    A.reset_launch_counts()
    runs = [G.global_attention_fwd_lse(q, kv, bh, bw, kl, **kwargs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert A.LAUNCHES["global_attention_fwd_lse"] == 2
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    out, lse = runs[0]
    if kl is not None:      # keys past kv_len changed: the same output
        kv2 = kv.clone()
        for row, n in enumerate(kl.tolist()):
            kv2[row, n:] = 0
        out2, lse2 = G.global_attention_fwd_lse(q, kv2, bh, bw, kl, **kwargs)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want_out, want_lse = G.global_attention_fwd_lse_plain(
        q, kv, bh, bw, kl, **kwargs)
    _assert_close(out, want_out, dt, "global")
    gap = (lse - want_lse).abs().max().item()
    print(f"Kh {kh} kv_len {kv_len}: lse gap {gap:.3e}")
    assert torch.isfinite(lse).all() and gap <= 1e-2
    if s <= 384:
        want = _lse_as_the_backward_scores(q, kv, bh, bw, kl, heads,
                                           d ** -0.5)
        gap = (lse - want).abs().max().item()
        print(f"Kh {kh} kv_len {kv_len}: lse against the backward's "
              f"scores {gap:.3e}")
        assert gap <= LSE_REBUILT_ATOL, gap


@pytest.mark.parametrize("kh,kw", [(32, 128), (64, 64)])
def test_global_bias_grads_follow_the_kernels_scoring(gen, kh, kw):
    """The K5 dq kernel scores on Q^ = bf16(q D^-1/2 log2 e), the plain
    version on the fp32 q: fed the kernel forward's lse, the plain
    version's bias gradients sit up to a few bf16 steps from the kernel's
    (PERF.md §6). Fed q rounded as Q^ is, the plain version gives the
    kernel's dbias_h and dbias_w within one bf16 step plus 1e-6, at Kw 128
    and Kw 64 (both on the Hopper body): what is left is the order of the
    fp32 sums."""
    import math

    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d = 1, 12, 64
    c, scale, s = heads * d, d ** -0.5, kh * kw
    dt = torch.bfloat16
    q, kv, dout = (_rand(gen, b, s, w, dtype=dt) for w in (c, 2 * c, c))
    bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
    bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kwargs = dict(num_heads=heads, scale=scale)
    out, lse = G.global_attention_fwd_lse(q, kv, bh, bw, None, **kwargs)
    args = (q, kv, bh, bw, None, dout, lse,
            G.attention_delta(out, dout, heads))
    got = G.global_attention_bwd_dq(*args, **kwargs)
    k = scale * math.log2(math.e)
    qhat = (q.float() * k).to(dt).float() / k
    want = G.global_attention_bwd_dq_plain(qhat, *args[1:], **kwargs)
    fp32_q = G.global_attention_bwd_dq_plain(*args, **kwargs)
    for name, g_, w_, f_ in zip(("dbias_h", "dbias_w"), got[1:], want[1:],
                                fp32_q[1:]):
        g_, w_, f_ = g_.float(), w_.float(), f_.float()
        gap = ((g_ - w_).abs() - 2.0 ** -7 * w_.abs()).max().item()
        fp32_gap = ((g_ - f_).abs() - 2.0 ** -7 * f_.abs()).max().item()
        print(f"Kh {kh} Kw {kw} {name}: gap beyond one bf16 step to the "
              f"plain version on Q^ {gap:.3e}, on the fp32 q {fp32_gap:.3e}")
        assert gap <= 1e-6, (name, gap)


def _qhat_plain(q, scale):
    """q rounded as the K5 kernels round Q^ = bf16(q D^-1/2 log2 e), back
    in q's units (fp32): fed it, a plain version scores as the kernels
    do."""
    import math

    k = scale * math.log2(math.e)
    return (q.float() * k).to(torch.bfloat16).float() / k


def _k5_rounding(args, heads, scale):
    """Worst cases of the K5 backward's bf16 operands, in fp32 from the
    scores the kernels build (``_scores_as_the_kernel``) and ``args``' lse
    and D: P and dS are rounded to bf16 for the products (relative 2^-9
    each), so 2^-8 of "dq" (scale Σ_j |dS| |K|) and "dkv" (scale Σ_i |dS|
    |Q|, Σ_i P |dO|) bounds what that rounding moves; "dbh"/"dbw" are Σ
    |dS| over a grid row or column, which scales the fp32 sums' order."""
    q, kv, bh, bw, kv_len, dout, lse, delta = args
    b, s, c = q.shape
    d, kh, kw = c // heads, bh.shape[-1], bw.shape[-1]

    def hs(x):
        return x.float().reshape(b, s, heads, d).transpose(1, 2)

    def rows(x):
        return x.transpose(1, 2).reshape(b, s, c)

    p = torch.exp2(_scores_as_the_kernel(q, kv, bh, bw, kv_len, heads, scale)
                   - lse[..., None])
    v, do = hs(kv[..., c:]), hs(dout)
    ds = (p * (do @ v.transpose(-1, -2) - delta[..., None])).abs()
    grid = ds.reshape(b, heads, s, kh, kw)
    return {"dq": scale * rows(ds @ hs(kv[..., :c]).abs()),
            "dkv": torch.cat([scale * rows(ds.transpose(-1, -2)
                                           @ hs(q).abs()),
                              rows(p.transpose(-1, -2) @ do.abs())], -1),
            "dbh": grid.sum(-1), "dbw": grid.sum(-2)}


def _assert_within(got, want, bound, limit, name):
    """|got - want| beyond one bf16 step (2^-7 |want|) and ``bound`` is at
    most ``limit`` elementwise (also printed without ``bound``)."""
    got, want = got.float(), want.float()
    gap = (got - want).abs() - 2.0 ** -7 * want.abs()
    excess = (gap - bound).max().item()
    print(f"{name}: gap {gap.max().item():.3e}, beyond the bound "
          f"{excess:.3e}")
    assert torch.isfinite(got).all() and excess <= limit, (name, excess)


# The Hopper dq and dkv on a key grid 128 keys wide: a grid row is two
# 64-key tiles, which dq visits even tiles first. kv_len ("ragged") cuts
# row 0 at S - 59 keys (the last, odd tile ragged; Kh 1: two tiles) and a
# second row at 50 keys (one tile visited: no odd half).
@pytest.mark.parametrize("kh", [1, 2, 5, 32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kv_len", [None, "ragged"])
def test_global_hopper_bwd_kw128_matches_plain(gen, kh, b, kv_len):
    """Against the plain versions fed q rounded as Q^, so that both score
    alike (with a few keys a row's P is peaked, and scores on the fp32 q
    sit further off than the kernels' own rounding): dq and dkv beyond one
    bf16 step and 2^-8 of the worst case of the kernels' bf16 operands
    (``_k5_rounding``) within GRAD_ATOL, dbias_h and dbias_w (fp32 sums of
    dS, no rounded operand) beyond one bf16 step and 2^-16 of their Σ |dS|
    within 1e-6. The chain: the same, the plain backward fed the plain
    forward's lse (scored on the same Q^) in place of the forward loop's,
    so a forward that scored unlike the backward would show. A second
    launch gives the same bits."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    heads, d, s = 2, 64, kh * 128
    kl = None if kv_len is None else [max(1, s - 59), 50][:b]
    args, kwargs = _k5_inputs(gen, b, heads, s, kh, 128, kl)
    assert G.global_attention_fwd_route(*args[:5],
                                        num_heads=heads) == "hopper"
    for kernel in ("dq", "dkv"):
        assert G.global_attention_bwd_route(
            *args[:5], num_heads=heads, kernel=kernel) == "hopper"
    A.reset_launch_counts()
    got = (*G.global_attention_bwd_dq(*args, **kwargs),
           G.global_attention_bwd_dkv(*args, **kwargs))
    again = (*G.global_attention_bwd_dq(*args, **kwargs),
             G.global_attention_bwd_dkv(*args, **kwargs))
    torch.cuda.synchronize()
    assert [A.LAUNCHES[k] for k in ("global_attention_bwd_dq",
                                    "global_attention_bwd_dkv")] == [2, 2]
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    if kl is not None:
        for row, n in enumerate(kl):
            assert not got[3][row, n:].any()
    scale = kwargs["scale"]
    qhat = _qhat_plain(args[0], scale)
    r = _k5_rounding(args, heads, scale)
    bounds = (2.0 ** -8 * r["dq"], 2.0 ** -16 * r["dbh"],
              2.0 ** -16 * r["dbw"], 2.0 ** -8 * r["dkv"])
    limits = (GRAD_ATOL["global"], 1e-6, 1e-6, GRAD_ATOL["global"])
    names = ("dq", "dbias_h", "dbias_w", "dkv")
    _, lse = G.global_attention_fwd_lse_plain(qhat, *args[1:5], **kwargs)
    for tag, lse_ in (("", args[6]), ("chain ", lse)):
        p_args = (qhat, *args[1:6], lse_, args[7])
        want = (*G.global_attention_bwd_dq_plain(*p_args, **kwargs),
                G.global_attention_bwd_dkv_plain(*p_args, **kwargs))
        for g_, w_, bound, limit, name in zip(got, want, bounds, limits,
                                              names):
            _assert_within(g_, w_, bound, limit, tag + name)


def test_global_hopper_bwd_is_deterministic(gen):
    """No atomics: two launches of each Hopper body give the same bits."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    args, kwargs = _k5_inputs(gen, 2, 4, 320, 5, 64, None)
    runs = [(*G.global_attention_bwd_dq(*args, **kwargs),
             G.global_attention_bwd_dkv(*args, **kwargs)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_global_trainable_backward_builds_without_spill(gen, tmp_path,
                                                        monkeypatch):
    """Both K5 backward sources, Hopper bodies (no bias, Kw 64, Kw 128) and
    loops, fit their registers: build_all's ptxas report (-Xptxas -v)
    shows no spill and no wgmma serialisation (C75xx)."""
    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    names = ("global_attention_bwd_dq", "global_attention_bwd_dkv")
    logs = cb.build_all(names)
    for name in names:
        print(name, [ln for ln in logs[name].splitlines()
                     if "registers" in ln])
        assert "spill" in logs[name] and cb.spill_bytes(logs[name]) == 0, \
            logs[name]
        hopper = [f for f in cb.ptxas_functions(logs[name])
                  if "hopper_kernel" in f]
        assert len(hopper) == 3 and "C75" not in logs[name], logs[name]


@pytest.mark.parametrize("remat", ["block", "mlp"])
def test_remat_on_the_card_matches_no_remat(gen, remat):
    """Fine-tuning a small SAM-shaped model whose global layer has a 64x64
    grid (K5) and whose windowed layer has 8x8 windows (K1/K4): remat
    recomputes the forward kernels inside the backward and must give the
    loss and gradients of the plain schedule."""
    import dataclasses

    from vit_deep_radiomics_tpu_torch.core.precision import FAST
    from vit_deep_radiomics_tpu_torch.engine.finetune import FineTuneModel
    from vit_deep_radiomics_tpu_torch.models.vit import SAM_VIT_B

    cfg = dataclasses.replace(
        SAM_VIT_B, image_size=64, patch_size=1, width=128, depth=2,
        num_heads=2, window_size=8, global_indexes=(1,), neck_channels=16)
    images = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    mask = torch.zeros(2, 64, 64, dtype=torch.bool, device="cuda")
    mask[:, 10:30, 20:40] = True
    runs = {}
    for mode in (False, remat):
        model = FineTuneModel(cfg, 2, FAST, remat=mode).init_random(0)
        model = model.cuda()
        A.reset_launch_counts()
        loss = model(images, mask).square().sum()
        loss.backward()
        torch.cuda.synchronize()
        runs[mode] = (loss.item(), dict(A.LAUNCHES),
                      {k: p.grad for k, p in model.named_parameters()})
    (loss0, counts0, g0), (loss1, counts1, g1) = runs[False], runs[remat]
    assert counts0["window_attention_bwd"] == 1
    assert counts0["global_attention_bwd_dkv"] == 1
    assert counts1["global_attention_fwd_lse"] == (2 if remat == "block"
                                                   else 1)
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, atol=1e-6, rtol=1e-5, msg=k)


# K6 (fp32, per-head (B, H, S, D)) against its plain versions, elementwise
# |got - want| <= K6_ATOL: both sides are fp32, so the gap is the order of
# the sums alone.
K6_ATOL = 1e-4


def _k6_inputs(gen, b, heads, s, kh, kw, kv_len=None):
    q, k, v, dout = (_rand(gen, b, heads, s, 64, dtype=torch.float32)
                     for _ in range(4))
    bh = bw = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=torch.float32, scale=0.3)
        bw = _rand(gen, b, heads, s, kw, dtype=torch.float32, scale=0.3)
    if kv_len is not None:
        kv_len = torch.tensor(kv_len, device="cuda")
    return q, k, v, bh, bw, kv_len, dout


def _k6_run(fwd, dq, dkv, delta, args, dout, scale):
    out, lse = fwd(*args, scale=scale)
    rest = (dout, lse, delta(out, dout))
    return (out, lse, *dq(*args, *rest, scale=scale),
            *dkv(*args, *rest, scale=scale))


@pytest.mark.parametrize("b,s,kh,kw,kv_len", [
    (2, 196, 14, 14, None),      # SAM window: Kw = 14 cuts every key tile
    (1, 320, 5, 64, None),       # SAM global's Kw = 64 over 5 key tiles
    (2, 200, 0, 0, [77, 200]),   # kv_len, ragged 64-row tiles
    (3, 196, 14, 14, None),      # three windows' batch entries, ragged tiles
    (2, 200, 10, 20, None),      # ragged S, Kw = 20 across the tiles
    (2, 40, 5, 8, None),         # S shorter than one tile
    (2, 1536, 0, 0, [1370, 1370]),   # DINOv2's kv_len cuts a tile
    (2, 200, 0, 0, None),        # no bias, no kv_len
    (2, 256, 8, 32, [100, 256]),  # Kw a multiple of the dq tile, kv_len
], ids=["kw14", "kw64", "kv_len", "windows_3", "s200_kw20", "s40",
        "kv_len_1370", "no_bias", "kw32_kv_len"])
def test_flash_trainable_kernels_match_plain(gen, b, s, kh, kw, kv_len):
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    q, k, v, bh, bw, kv_len, dout = _k6_inputs(gen, b, 3, s, kh, kw, kv_len)
    args, scale = (q, k, v, bh, bw, kv_len), 64 ** -0.5
    A.reset_launch_counts()
    got = _k6_run(G.flash_attention_fwd, G.flash_attention_bwd_dq,
                  G.flash_attention_bwd_dkv, G.flash_attention_delta, args,
                  dout, scale)
    torch.cuda.synchronize()
    assert [A.LAUNCHES[n] for n in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")] == [1, 1, 1]
    want = _k6_run(G.flash_attention_fwd_plain,
                   G.flash_attention_bwd_dq_plain,
                   G.flash_attention_bwd_dkv_plain, G.flash_attention_delta,
                   args, dout, scale)
    names = ("out", "lse", "dq", "dbh", "dbw", "dk", "dv")
    for g_, w_, name in zip(got, want, names):
        if w_ is None:
            assert g_ is None, name
            continue
        gap = (g_ - w_).abs().max().item()
        print(f"{name}: gap {gap:.3e}")
        assert torch.isfinite(g_).all() and gap <= K6_ATOL, (name, gap)
    if kv_len is not None:     # keys past kv_len get no gradient
        for i, n in enumerate(kv_len.tolist()):
            assert not got[5][i, :, n:].any() and not got[6][i, :, n:].any()


def test_flash_trainable_kv_len_zero_row_matches_plain(gen):
    """A batch row with kv_len 0 (S = 200, kv_len [0, 150]): the K6
    forward, dq and dkv follow their plain versions, where every key of
    the row scores -1e30: the forward averages V, the lse is -1e30, and the
    backward takes P = 1 per key."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    q, k, v, _, _, kv_len, dout = _k6_inputs(gen, 2, 3, 200, 0, 0, [0, 150])
    args, scale = (q, k, v, None, None, kv_len), 64 ** -0.5
    got = _k6_run(G.flash_attention_fwd, G.flash_attention_bwd_dq,
                  G.flash_attention_bwd_dkv, G.flash_attention_delta, args,
                  dout, scale)
    torch.cuda.synchronize()
    want = _k6_run(G.flash_attention_fwd_plain,
                   G.flash_attention_bwd_dq_plain,
                   G.flash_attention_bwd_dkv_plain, G.flash_attention_delta,
                   args, dout, scale)
    assert torch.equal(got[1][0], want[1][0])      # lse -1e30 on every row
    names = ("out", "lse", "dq", "dbh", "dbw", "dk", "dv")
    for g_, w_, name in zip(got, want, names):
        if w_ is None:
            assert g_ is None, name
            continue
        # Row 1 as every other row. Row 0 has P = 1 on all 200 keys, so
        # its gradients are sums of 200 unnormalised terms, some 200 times
        # a softmax row's: the same fp32 rule relative to its largest value.
        gap1 = (g_[1] - w_[1]).abs().max().item()
        gap0 = (g_[0] - w_[0]).abs().max().item()
        lim0 = K6_ATOL * max(1.0, w_[0].abs().max().item())
        print(f"{name}: gap {gap1:.3e}, kv_len 0 row {gap0:.3e} "
              f"(limit {lim0:.3e})")
        assert torch.isfinite(g_).all() and gap1 <= K6_ATOL, (name, gap1)
        assert gap0 <= lim0, (name, gap0)


# the K6 forward on the tiled body: (B, S, Kh, Kw, kv_len)
K6_FWD_CASES = {"grid_14x14": (2, 196, 14, 14, None),
                "grid_16x16": (1, 256, 16, 16, None),
                "kv_len_zero_row": (2, 200, 0, 0, [0, 150]),
                "s40": (2, 40, 5, 8, None)}


@pytest.mark.parametrize("case", sorted(K6_FWD_CASES))
def test_flash_trainable_forward_matches_plain(gen, case):
    """The K6 forward (the register-tiled body with K6's problem and split
    score chains) against its plain version at the CPU shim's limits: out
    within 2e-5, the log2 lse within 1e-5 (the fp32 sums' order alone; a
    kv_len 0 row's lse is -1e30 on both sides, exactly); ragged rows (196
    = 3 x 64 + 4) and ragged key tiles."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, s, kh, kw, kv_len = K6_FWD_CASES[case]
    q, k, v, bh, bw, kv_len, _ = _k6_inputs(gen, b, 3, s, kh, kw, kv_len)
    args = (q, k, v, bh, bw, kv_len)
    A.reset_launch_counts()
    out, lse = G.flash_attention_fwd(*args, scale=0.125)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention_fwd"] == 1
    want_out, want_lse = G.flash_attention_fwd_plain(*args, scale=0.125)
    gap_o = (out - want_out).abs().max().item()
    gap_l = (lse - want_lse).abs().max().item()
    print(f"out gap {gap_o:.3e}, lse gap {gap_l:.3e}")
    assert torch.isfinite(out).all() and gap_o <= 2e-5 and gap_l <= 1e-5
    if kv_len is not None and kv_len[0] == 0:
        assert torch.equal(lse[0], want_lse[0])


def test_flash_trainable_backward_builds_without_spill(gen, tmp_path):
    """The register-tiled dq and dkv kernels fit their registers: ptxas
    (-Xptxas -v, the build's flags) reports no spill bytes."""
    import subprocess

    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        res = subprocess.run(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(tmp_path / f"{name}.so"),
             str(cb.CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stdout + res.stderr
        log = res.stdout + res.stderr
        print(name, [ln for ln in log.splitlines() if "registers" in ln])
        assert "spill" in log and cb.spill_bytes(log) == 0, log


def test_flash_trainable_kernels_are_deterministic(gen):
    """No atomics: two runs give the same bits (the remat and gradient
    checks rely on it)."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    q, k, v, bh, bw, _, dout = _k6_inputs(gen, 2, 3, 196, 14, 14)
    runs = [_k6_run(G.flash_attention_fwd, G.flash_attention_bwd_dq,
                    G.flash_attention_bwd_dkv, G.flash_attention_delta,
                    (q, k, v, bh, bw, None), dout, 0.125) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# K6 on bf16 operands (the mma.sync bodies) against the plain versions on
# the same bf16 inputs, fp32 bias: |got - want| <= K6_BF16_ATOL +
# 2^-7·|want| on the bf16 outputs (a flip of one bf16 rounding after fp32
# sums in another order), the fp32 lse and bias gradients absolutely;
# about 1.5 times the largest gap measured over these cases on an H100 SXM
# (out 1.09e-3, lse 1.91e-6, dq 1.32e-4, dk 1.05e-4, dv 2.30e-4); the bias
# gradients 9.77e-4 = 2^-10, one flipped bf16 rounding of a dS term in a
# sum, so their limit allows two.
K6_BF16_ATOL = {"out": 1.6e-3, "lse": 3e-6, "dq": 2e-4, "dbh": 2e-3,
                "dbw": 2e-3, "dk": 2e-4, "dv": 3.5e-4}


def _k6_bf16(args, dout):
    q, k, v = (t.to(torch.bfloat16) for t in args[:3])
    return (q, k, v, *args[3:]), dout.to(torch.bfloat16)


def _k6_bf16_steps():
    """The rule of chip_smoke.py's phase 10 (K6_BF16_STEPS): a gap in bf16
    steps of the output's largest |value|, the fp32 lse absolutely. Phase
    10 holds each of its shapes to limits set from that shape's readings;
    the widths here have none of their own, so each output takes the
    loosest of phase 10's limits at the shapes where the Hopper backward
    runs (not those of the mma.sync bodies' own shapes)."""
    import chip_smoke as cs

    names = {"dbias_h": "dbh", "dbias_w": "dbw"}
    steps = {"lse": None}
    for shape, by_output in cs.K6_BF16_STEPS.items():
        if cs.K6_BF16_BWD_BODY[shape] != "hopper":
            continue
        for name, x in by_output.items():
            name = names.get(name, name)
            steps[name] = max(steps.get(name, 0.0), x)
    return steps


def _k6_bf16_check(gen, b, heads, s, kh, kw, kv_len, steps=None):
    """K6 in bf16 at one shape: the forward and the backward (the bodies
    their routes name, one choice for dq and dkv, each launch counted under
    its body's name) against the plain versions, the backward fed the kernel
    forward's lse and delta: K6_BF16_ATOL, or with ``steps``
    (``_k6_bf16_steps()``) that many bf16 steps of each output's largest
    |value|. The forward's body is the backward's, but at Kw 2 mod 4, where
    the backward's Hopper bodies take the lse of the forward's mma.sync
    one. Returns the backward's body."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    *args, dout = _k6_inputs(gen, b, heads, s, kh, kw, kv_len)
    args, dout = _k6_bf16(args, dout)
    scale = 64 ** -0.5
    body = G.flash_attention_bwd_route(*args)
    assert body == G.flash_attention_bwd_route(*args, kernel="dkv")
    fwd_body = G.flash_attention_route(*args)
    assert fwd_body == ("mma" if body == "hopper" and kw % 4 == 2 else body)
    A.reset_launch_counts()
    out, lse = G.flash_attention_fwd(*args, scale=scale)
    rest = (dout, lse, G.flash_attention_delta(out, dout))
    got = (out, lse, *G.flash_attention_bwd_dq(*args, *rest, scale=scale),
           *G.flash_attention_bwd_dkv(*args, *rest, scale=scale))
    torch.cuda.synchronize()
    # counted under the names of the bodies that ran, the Hopper or
    # mma.sync ones; none under the fp32 builds' names
    suffix, fwd_suffix = ("_hopper" if b_ == "hopper" else "_bf16"
                          for b_ in (body, fwd_body))
    names = (f"flash_attention_fwd{fwd_suffix}",
             f"flash_attention_bwd_dq{suffix}",
             f"flash_attention_bwd_dkv{suffix}")
    assert {n: c for n, c in A.LAUNCHES.items() if c} == \
        dict.fromkeys(names, 1)
    # the forward against the plain forward; the backward against the
    # plain backward fed the same lse and delta
    want = (*G.flash_attention_fwd_plain(*args, scale=scale),
            *G.flash_attention_bwd_dq_plain(*args, *rest, scale=scale),
            *G.flash_attention_bwd_dkv_plain(*args, *rest, scale=scale))
    names = ("out", "lse", "dq", "dbh", "dbw", "dk", "dv")
    for g_, w_, name in zip(got, want, names):
        if w_ is None:
            assert g_ is None, name
            continue
        assert g_.dtype == w_.dtype, name
        g_, w_ = g_.float(), w_.float()
        rtol = 2.0 ** -7 if name in ("out", "dq", "dk", "dv") else 0.0
        # a kv_len 0 row sums unnormalised terms: the rule relative to the
        # output's largest value
        rel = max(1.0, w_.abs().max().item()) if kv_len and \
            kv_len[0] == 0 and name != "lse" else 1.0
        gap = ((g_ - w_).abs() - rtol * w_.abs()).max().item()
        limit = K6_BF16_ATOL[name] * rel
        if steps and steps[name] is not None:
            limit = steps[name] * 2.0 ** -8 * w_.abs().max().item()
        print(f"{name} [{body}]: gap {gap:.3e} beyond {rtol:g}·|want| "
              f"(limit {limit:.3e})")
        assert torch.isfinite(g_).all() and gap <= limit, (name, gap, limit)
    if kv_len is not None:     # keys past a non-zero kv_len: no gradient
        for i, n in enumerate(kv_len):
            if n:
                assert not got[5][i, :, n:].float().any()
                assert not got[6][i, :, n:].float().any()
    return body


@pytest.mark.parametrize("b,s,kh,kw,kv_len", [
    (1, 192, 4, 48, None),       # Kw 48: a 64-key tile spans two grid rows
    (2, 2304, 48, 48, None),     # SAM @768's global grid
    (2, 196, 14, 14, None),      # SAM window: Kw = 14 cuts every key tile
    (2, 200, 0, 0, [77, 200]),   # kv_len, ragged 64-row tiles
    (2, 130, 0, 0, [0, 70]),     # a kv_len 0 row
    (2, 1536, 0, 0, [1370, 1370]),   # DINOv2's kv_len cuts a tile
    (2, 100, 10, 10, [37, 100]),  # a bias and kv_len together
], ids=["kw48", "sam768", "kw14", "kv_len", "kv_len_zero_row",
        "kv_len_1370", "bias_kv_len"])
def test_flash_trainable_bf16_kernels_match_plain(gen, b, s, kh, kw, kv_len):
    """Three heads: the forward and the backward take the Hopper bodies
    with no bias or Kw 48 and the mma.sync bodies at Kw 14 and 10."""
    body = _k6_bf16_check(gen, b, 3, s, kh, kw, kv_len)
    assert body == ("mma" if kw in (10, 14) else "hopper")


@pytest.mark.parametrize("s,kh,kv_len", [
    (2304, 48, None),     # SAM @768's global grid, Kh = Kw = 48
    (240, 5, None),       # S = 5 x 48: not a multiple of 64 or 128
    (2304, 48, [1000]),   # a bias and kv_len inside a 48-key tile
    (130, 0, [0]),        # no bias, a kv_len 0 row over a ragged S
    (200, 0, [77]),       # no bias, kv_len inside a tile
    (200, 0, [200]),      # no bias, kv_len at S (ragged S)
    (1000, 0, None),      # no bias, no kv_len, ragged S
], ids=["sam768", "kh5", "sam768_kv_len", "kv_len_zero", "kv_len_77",
        "kv_len_at_s", "s1000"])
def test_flash_trainable_bf16_hopper_bodies_match_plain(gen, s, kh, kv_len):
    """The Hopper bodies of K6's bf16 backward (TMA + wgmma, key tiles of
    one 48-key grid row in dq, 128-key blocks in dkv) at B=1 and two heads
    against the plain versions."""
    assert _k6_bf16_check(gen, 1, 2, s, kh, 48 if kh else 0,
                          kv_len) == "hopper"


@pytest.mark.parametrize("b,s,kh,kw,kv_len", [
    (2, 1600, 40, 40, None),      # SAM @640: 48-key dq tiles, half blocks
    (2, 3136, 56, 56, None),      # SAM @896: 64-key dq tiles, half blocks
    (1, 1440, 20, 72, None),      # two 48-key passes a row (24 live in
                                  # the second), 1/4 blocks
    (1, 160, 10, 16, None),       # 16-key tiles, 9 grid rows a dkv block
    (1, 240, 10, 24, None),       # 32-key tiles over 24 keys
    (1, 320, 10, 32, None),
    (1, 640, 10, 64, None),       # two 32-key passes, 3 dkv stages
    (1, 800, 10, 80, None),       # two 48-key passes, 32 live in the
                                  # second
    (1, 880, 10, 88, None),
    (1, 960, 10, 96, None),       # two whole 48-key passes
    (1, 1040, 10, 104, None),     # three 48-key passes (8 live in the
                                  # third), 2 dkv stages
    (1, 1120, 10, 112, None),
    (1, 1200, 10, 120, None),
    (1, 1280, 10, 128, None),     # three 48-key passes, 2 grid rows a
                                  # dkv block
    (1, 5120, 128, 40, None),     # 128 grid rows
    (2, 1600, 40, 40, [900, 1600]),   # kv_len inside a grid row
    (1, 1440, 20, 72, [1000]),        # kv_len inside the second pass
    (2, 3136, 56, 56, [0, 3000]),     # a kv_len 0 row
    # widths 4 mod 8: a dq pass ends inside an 8-column chunk, dkv's 8-key
    # blocks wrap grid rows or start at 4 mod 8 (doubled terms)
    (1, 320, 16, 20, None),       # 32-key tiles over 20 keys
    (2, 1296, 36, 36, None),      # SAM @576: 48-key tiles over 36 keys,
                                  # a last dkv block of 16 keys
    (1, 1936, 44, 44, None),      # SAM @704
    (1, 2704, 52, 52, None),      # SAM @832: 64-key tiles, 3 dkv stages
    (1, 3600, 60, 60, None),      # SAM @960: two 32-key passes (28 live
                                  # in the second)
    (1, 1240, 10, 124, None),     # three 48-key passes (28 live in the
                                  # third), 2 dkv stages
    (2, 1296, 36, 36, [700, 1296]),   # kv_len inside a grid row
    (2, 1936, 44, 44, [0, 1936]),     # a kv_len 0 row
    # widths 2 mod 4 (the backward alone; the forward takes its mma.sync
    # body): dkv's key-major terms and bulk-copied bias_w rows
    (1, 324, 18, 18, None),       # 32-key tiles over 18 keys
    (2, 1156, 34, 34, None),      # SAM @544: a last dq and dkv block of 4
                                  # rows, a last bulk copy of 4 rows
    (1, 580, 10, 58, None),       # two 32-key passes (26 live in the
                                  # second), 3 dkv stages
    (1, 980, 10, 98, None),       # three 48-key passes (2 live in the
                                  # third)
    (1, 1260, 10, 126, None),     # three 48-key passes, 2 dkv stages
    (2, 1156, 34, 34, [700, 1156]),   # kv_len inside a grid row
    (2, 1156, 34, 34, [0, 1156]),     # a kv_len 0 row
], ids=["sam640", "sam896", "kw72", "kw16", "kw24", "kw32", "kw64", "kw80",
        "kw88", "kw96", "kw104", "kw112", "kw120", "kw128", "kw40_kh128",
        "sam640_kv_len", "kw72_kv_len", "sam896_kv_len_zero_row", "kw20",
        "sam576", "sam704", "sam832", "sam960", "kw124", "sam576_kv_len",
        "sam704_kv_len_zero_row", "kw18", "sam544", "kw58", "kw98", "kw126",
        "sam544_kv_len", "sam544_kv_len_zero_row"])
def test_flash_trainable_bf16_hopper_bodies_at_every_grid_width(
        gen, b, s, kh, kw, kv_len):
    """The Hopper bodies at key-grid widths other than 48 (multiples of 8
    from 16 to 128, and of 4: Kw 20, SAM @576-@960's 36, 44, 52, 60, and
    124; in the backward also 2 mod 4: Kw 18, SAM @544's 34, 58, 98 and
    126): dq in one to three passes a grid row of 16-, 32-, 48- or 64-key
    tiles (``hopper_dq_passes``, ``hopper_dq_tile``), masking the next
    row's keys in a tile wider than the row's share (per column pair where
    a pass ends inside an 8-column chunk); dkv with the grid rows, the
    bias_w term layout (key-major at Kw 2 mod 4, the fp32 rows by bulk
    copy) and ring depth of each width;
    S not a multiple of 128 (the last block half idle), kv_len with a bias,
    against the plain versions at two heads, by phase 10's rule."""
    assert _k6_bf16_check(gen, b, 2, s, kh, kw, kv_len,
                          steps=_k6_bf16_steps()) == "hopper"


@pytest.mark.parametrize("b,s,kh,kw,kv_len", [
    (1, 16, 1, 16, None),         # one grid row of 16 keys, 48 query rows
                                  # of the block past S
    (2, 80, 5, 16, None),         # 16-key tiles, S not a multiple of 64
    (1, 36, 1, 36, None),         # 48-key tiles over 36 keys (4 mod 8: the
                                  # column-pair mask)
    (2, 180, 5, 36, None),
    (1, 40, 1, 40, None),
    (2, 200, 5, 40, None),        # a 48-key tile holds the next row's 8
    (1, 48, 1, 48, None),
    (2, 240, 5, 48, None),
    (2, 1296, 36, 36, None),      # SAM @576's global grid
    (2, 300, 5, 60, None),        # one 64-key pass over 60 keys (4 mod 8)
    (1, 320, 5, 64, None),        # one pass of 64 live keys
    (1, 360, 5, 72, None),        # two 48-key passes (24 live in the
                                  # second)
    (2, 130, 0, 0, [0, 70]),      # no bias: a kv_len 0 row, ragged S
    (2, 200, 0, 0, [77, 200]),    # kv_len inside a 64-key tile
    (1, 1000, 0, 0, None),        # no bias, no kv_len, ragged S
    (2, 180, 5, 36, [0, 100]),    # a bias with a kv_len 0 row
], ids=["kw16_kh1", "kw16_kh5", "kw36_kh1", "kw36_kh5", "kw40_kh1",
        "kw40_kh5", "kw48_kh1", "kw48_kh5", "sam576", "kw60", "kw64",
        "kw72", "kv_len_zero_row", "kv_len_77", "s1000",
        "kw36_kv_len_zero_row"])
def test_flash_trainable_bf16_hopper_forward_matches_plain(gen, b, s, kh, kw,
                                                           kv_len):
    """The forward's Hopper body (TMA + wgmma, dq's key tiles of a grid
    row but one 64-key pass at Kw 60 and 64, an online softmax with the
    exact running max) against the plain
    forward at two heads, by phase 10's rule (the loosest of
    K6_BF16_STEPS for out, K6_BF16_LSE_ATOL for the lse), and the Hopper
    dq and dkv fed its lse within theirs; two runs give the same bits."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    assert _k6_bf16_check(gen, b, 2, s, kh, kw, kv_len,
                          steps=_k6_bf16_steps()) == "hopper"
    *args, dout = _k6_inputs(gen, b, 2, s, kh, kw, kv_len)
    args, _ = _k6_bf16(args, dout)
    runs = [G.flash_attention_fwd(*args, scale=0.125) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_flash_trainable_bf16_route_and_determinism(gen):
    """fp32 calls take the tiled bodies; bf16 calls the Hopper bodies at
    Kw 48, 72 (two passes a grid row) and 36 (4 mod 8: the doubled dkv
    terms, the pair masks), the Hopper backward and the mma.sync forward
    at SAM @544's Kw 34 (2 mod 4: the key-major dkv terms) and the mma.sync
    ones at Kw 14; a bf16 bias grid of more than 320 terms is refused by
    the C entry; two bf16 runs give the same bits on either body (no
    atomics)."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    for shape, body, fwd_body in (((2, 3, 192, 4, 48), "hopper", "hopper"),
                                  ((1, 2, 1440, 20, 72), "hopper", "hopper"),
                                  ((1, 2, 1296, 36, 36), "hopper", "hopper"),
                                  ((2, 2, 1156, 34, 34), "hopper", "mma"),
                                  ((2, 3, 196, 14, 14), "mma", "mma")):
        *args, dout = _k6_inputs(gen, *shape)
        assert G.flash_attention_route(*args) == "tiled"
        assert G.flash_attention_bwd_route(*args) == "tiled"
        args, dout = _k6_bf16(args, dout)
        assert G.flash_attention_route(*args) == fwd_body
        for kernel in ("dq", "dkv"):
            assert G.flash_attention_bwd_route(*args, kernel=kernel) == body
        runs = [_k6_run(G.flash_attention_fwd, G.flash_attention_bwd_dq,
                        G.flash_attention_bwd_dkv, G.flash_attention_delta,
                        args, dout, 0.125) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    wide = _k6_bf16(_k6_inputs(gen, 1, 1, 400, 1, 400)[:6], dout)[0]
    for route in (G.flash_attention_route, G.flash_attention_bwd_route):
        with pytest.raises(RuntimeError, match="320 terms"):
            route(*wide)
    with pytest.raises(RuntimeError, match="320 terms"):
        G.flash_attention_fwd(*wide, scale=0.125)


def test_kv_len_kernels_at_a_padded_dinov2_shape(gen):
    """K2 and the three K5 kernels in kv_len mode, bf16, on the layout a
    DINOv2 layer gives them: 226 tokens (15x15 patches and the CLS token)
    padded to 256, the pads masked for both batch rows."""
    from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

    b, heads, d, s, n = 2, 4, 64, 256, 226
    dt = torch.bfloat16
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    kwargs = dict(num_heads=heads, scale=d ** -0.5)
    _assert_close(A.fused_global_attention(q, kv, None, None, kv_len,
                                           **kwargs),
                  A.fused_global_attention_plain(q, kv, None, None, kv_len,
                                                 **kwargs), dt, "global")
    out, lse = G.global_attention_fwd_lse(q, kv, None, None, kv_len,
                                          **kwargs)
    want_out, want_lse = G.global_attention_fwd_lse_plain(
        q, kv, None, None, kv_len, **kwargs)
    _assert_close(out, want_out, dt, "global")
    assert (lse - want_lse).abs().max().item() <= 1e-2
    dout = _rand(gen, b, s, heads * d, dtype=dt)
    args = (q, kv, None, None, kv_len, dout, lse,
            G.attention_delta(out, dout, heads))
    got = (G.global_attention_bwd_dq(*args, **kwargs)[0],
           G.global_attention_bwd_dkv(*args, **kwargs))
    want = (G.global_attention_bwd_dq_plain(*args, **kwargs)[0],
            G.global_attention_bwd_dkv_plain(*args, **kwargs))
    for g_, w_, name in zip(got, want, ("dq", "dkv")):
        _assert_grad_close(g_, w_, name, "global")
    assert not got[1][:, n:].any()


@pytest.mark.parametrize("width,heads", [(1024, 16), (1536, 24)])
def test_global_kv_len_at_dinov2_large_widths(gen, width, heads):
    """K2 in kv_len mode at DINOv2 ViT-L/14's and ViT-g/14's head counts
    (16 and 24 heads of 64: row strides of 2C and 3C elements in the
    Hopper body's tensor maps), 1536 padded tokens with 1370 valid, bf16:
    the Hopper body against its plain version."""
    b, s, n, dt = 2, 1536, 1370, torch.bfloat16
    q = _rand(gen, b, s, width, dtype=dt)
    kv = _rand(gen, b, s, 2 * width, dtype=dt)
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    kwargs = dict(num_heads=heads, scale=64 ** -0.5)
    assert A.fused_global_attention_route(q, kv, None, None, kv_len,
                                          **kwargs) == "hopper"
    A.reset_launch_counts()
    got = A.fused_global_attention(q, kv, None, None, kv_len, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_global_attention"] == 1
    _assert_close(got, A.fused_global_attention_plain(q, kv, None, None,
                                                      kv_len, **kwargs),
                  dt, "global")


@pytest.mark.parametrize("remat", ["block", "mlp"])
def test_parity_remat_on_the_card_matches_no_remat(gen, remat):
    """``parity`` fine-tuning of a small SAM-shaped model (64x64 global
    grid, 8x8 windows) through K6: remat recomputes the K6 forward inside
    the backward and must give the plain schedule's loss and gradients."""
    import dataclasses

    from vit_deep_radiomics_tpu_torch.core.precision import PARITY
    from vit_deep_radiomics_tpu_torch.engine.finetune import FineTuneModel
    from vit_deep_radiomics_tpu_torch.models.vit import SAM_VIT_B

    cfg = dataclasses.replace(
        SAM_VIT_B, image_size=64, patch_size=1, width=128, depth=2,
        num_heads=2, window_size=8, global_indexes=(1,), neck_channels=16)
    images = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    mask = torch.zeros(2, 64, 64, dtype=torch.bool, device="cuda")
    mask[:, 10:30, 20:40] = True
    runs = {}
    for mode in (False, remat):
        model = FineTuneModel(cfg, 2, PARITY, remat=mode).init_random(0)
        model = model.cuda()
        A.reset_launch_counts()
        with PARITY.backends():
            loss = model(images, mask).square().sum()
            loss.backward()
        torch.cuda.synchronize()
        runs[mode] = (loss.item(), dict(A.LAUNCHES),
                      {k: p.grad for k, p in model.named_parameters()})
    (loss0, counts0, g0), (loss1, counts1, g1) = runs[False], runs[remat]
    assert counts0["flash_attention_fwd"] == 2
    assert counts0["flash_attention_bwd_dkv"] == 2
    assert counts1["flash_attention_fwd"] == (4 if remat == "block" else 2)
    assert not counts0["window_attention_bwd"]
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, atol=1e-6, rtol=1e-5, msg=k)


# K3 (generic head-major flash attention) against its plain version, every
# mode, every head dim it builds; the same elementwise rule as K1/K2.
K3_ATOL = {torch.float32: 2e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mode", ["grid", "window", "kv_len"])
def test_flash_attention_kernel_matches_plain(gen, dtype, d, mode):
    heads = 3
    kw = {}
    if mode == "grid":      # a 10x13 grid padded to 16x16, 200 queries
        b, sq, sk = 2, 200, 256
        bh = _rand(gen, b, heads, sq, 16, dtype=dtype, scale=0.3)
        bw = _rand(gen, b, heads, sq, 16, dtype=dtype, scale=0.3)
        kw = dict(kv_grid=(10, 13))
    elif mode == "window":  # 6 windows of 8x8, 7x6 valid, 2 per block
        b, sq = 2, 6 * 64
        sk = sq
        bh = _rand(gen, b, heads, sq, 8, dtype=dtype, scale=0.3)
        bw = _rand(gen, b, heads, sq, 8, dtype=dtype, scale=0.3)
        kw = dict(kv_grid=(7, 6), window_tokens=64)
    else:                   # a row with no valid key averages V
        b, sq, sk = 3, 150, 192
        bh = bw = None
        kw = dict(kv_len=torch.tensor([0, 77, 192], device="cuda"))
    q = _rand(gen, b, heads, sq, d, dtype=dtype)
    k = _rand(gen, b, heads, sk, d, dtype=dtype)
    v = _rand(gen, b, heads, sk, d, dtype=dtype)
    A.reset_launch_counts()
    got = A.flash_attention(q, k, v, bh, bw, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention"] == 1
    want = A.flash_attention_plain(q, k, v, bh, bw, scale=d ** -0.5, **kw)
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - RTOL[dtype] * want.abs()).max().item()
    print(f"K3 {mode} D={d} {dtype}: gap {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= K3_ATOL[dtype], gap


# K3's Hopper body (bf16, D 64, no window mode): name -> (B, H, Sq, Kh, Kw,
# kv_grid, kv_len), Sk = Kh·Kw (or Kw without a bias). SAM @768's global
# layer cut to B 1, H 2 (the 2304 query rows its caller keeps against the
# 48 x 64 padded grid: 48-key tiles); a ragged Sq with 40 valid columns (a
# 48-key tile, columns 40-47 masked in bias_w); 64-key tiles on the valid
# rows of a grid and on a whole grid; no bias, ragged Sk; kv_len with a row
# that has no valid key (it averages V over all Sk keys).
K3_HOPPER_CASES = {"sam768_reduced": (1, 2, 2304, 48, 64, (48, 48), None),
                   "ragged_sq_cols_40": (2, 2, 200, 5, 64, (4, 40), None),
                   "grid_rows_64": (1, 3, 130, 6, 64, (4, 64), None),
                   "bias_no_grid": (2, 2, 100, 3, 64, None, None),
                   "no_bias_ragged_sk": (2, 2, 300, 0, 200, None, None),
                   "kv_len_zero_row": (3, 2, 150, 0, 192, None,
                                       (0, 77, 192))}


@pytest.mark.parametrize("case", sorted(K3_HOPPER_CASES))
def test_flash_hopper_matches_plain(gen, case):
    """bf16 K3 calls at D 64 outside window mode with no bias, or a bias on
    key-grid rows of 64 keys and no kv_len, take the Hopper kernel and hold
    to the plain version by the rule of the other K3 tests."""
    b, heads, sq, kh, kw, grid, kv_len = K3_HOPPER_CASES[case]
    dt, d = torch.bfloat16, 64
    sk = kh * kw if kh else kw
    q = _rand(gen, b, heads, sq, d, dtype=dt)
    k, v = (_rand(gen, b, heads, sk, d, dtype=dt) for _ in range(2))
    bh = bw = kl = None
    if kh:
        bh = _rand(gen, b, heads, sq, kh, dtype=dt, scale=0.3)
        bw = _rand(gen, b, heads, sq, kw, dtype=dt, scale=0.3)
    if kv_len:
        kl = torch.tensor(kv_len, device="cuda")
    # JAX's blocks divide the lengths (2304 queries: one block)
    kw_ = dict(kv_grid=grid, block_q=sq, block_k=sk)
    assert A.flash_attention_route(q, k, v, bh, bw, kl, **kw_) == "hopper"
    A.reset_launch_counts()
    got = A.flash_attention(q, k, v, bh, bw, kl, **kw_)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention"] == 1
    want = A.flash_attention_plain(q, k, v, bh, bw, kl, kv_grid=grid,
                                   scale=d ** -0.5)
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - RTOL[dt] * want.abs()).max().item()
    print(f"K3 hopper {case}: gap {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= K3_ATOL[dt], gap
    assert torch.equal(got, A.flash_attention(q, k, v, bh, bw, kl,
                                              **kw_).float())


@pytest.mark.parametrize("case,route", [
    ("bias_kv_len", "loops"), ("kw_32", "loops"), ("cols_20", "loops"),
    ("window", "hopper_window"), ("window_fp32", "tiled"),
    ("window_fp32_d_32", "loops"), ("window_fp32_d_128", "loops"),
    ("window_d_32", "loops"), ("window_d_128", "loops"),
    ("window_scale_0.1", "loops"), ("window_terms_48", "loops"),
    ("d_128", "loops"), ("fp32", "tiled")])
def test_flash_hopper_route_refuses(gen, case, route):
    """The calls the Hopper body does not take keep their earlier bodies: a
    bias with kv_len, key-grid rows of 32 keys, 20 valid columns (a
    32-key tile), D 128, fp32. Window mode takes the whole-window body in
    bf16 at D 64 and the tiled body in fp32 at D 64, and keeps the loops
    in both dtypes at D 32 and 128, in bf16 at a scale whose inverse is not
    a power of two and with Kh + Kw = 48 bias terms (2 x 46 windows; the
    body takes at most 47)."""
    b, heads, sq, d, kh, kw = 1, 2, 64, 64, 4, 64
    dt = torch.float32 if case in ("fp32", "window_fp32", "window_fp32_d_32",
                                   "window_fp32_d_128") else torch.bfloat16
    if case == "kw_32":
        kw = 32
    if case.endswith("d_128"):
        d = 128
    if case.endswith("d_32"):
        d = 32
    opts, kl = dict(kv_grid=(4, 20) if case == "cols_20" else None), None
    if case.startswith("window"):
        sq, kh, kw = 128, 8, 8
        opts = dict(kv_grid=(7, 6), window_tokens=64)
        if case == "window_scale_0.1":
            opts["scale"] = 0.1
        if case == "window_terms_48":
            sq, kh, kw = 184, 2, 46
            opts = dict(kv_grid=(2, 40), window_tokens=92)
    sk = sq if case.startswith("window") else kh * kw
    if case == "bias_kv_len":
        kl = torch.tensor([100], device="cuda")
    q = _rand(gen, b, heads, sq, d, dtype=dt)
    k = _rand(gen, b, heads, sk, d, dtype=dt)
    bh = _rand(gen, b, heads, sq, kh, dtype=dt)
    bw = _rand(gen, b, heads, sq, kw, dtype=dt)
    assert A.flash_attention_route(q, k, k, bh, bw, kl, **opts) == route


# K3's window mode in bf16 at D 64 on K1's whole-window body: name -> (B,
# H, windows a batch row, Kh, Kw, kv_grid). 256-token windows with 14 x 14
# of 16 x 16 valid (SAM's grouped layout: 224 key rows loaded), whole, and
# 10 x 13 valid; 64-token windows with 7 x 6 of 8 x 8 valid; unpadded
# 196-token windows with kv_grid (14, 14); an odd count of windows (141
# items: more than a block a streaming multiprocessor, some blocks take
# two).
K3_WINDOW_CASES = {"sam_16x16_14x14": (3, 12, 4, 16, 16, (14, 14)),
                   "whole_16x16": (2, 3, 3, 16, 16, (16, 16)),
                   "grid_10x13": (2, 3, 3, 16, 16, (10, 13)),
                   "win_8x8_7x6": (2, 3, 6, 8, 8, (7, 6)),
                   "unpadded_14x14": (2, 3, 3, 14, 14, (14, 14)),
                   "odd_windows": (1, 3, 47, 16, 16, (14, 14))}


@pytest.mark.parametrize("case", sorted(K3_WINDOW_CASES))
def test_flash_window_hopper_matches_plain(gen, case):
    """bf16 K3 calls at D 64 in window mode take the whole-window body and
    hold to the plain version by the rule of the other K3 tests, every
    query row of a window (its padding rows too); two runs give the same
    bits."""
    b, heads, nwin, kh, kw, grid = K3_WINDOW_CASES[case]
    dt, d, win = torch.bfloat16, 64, kh * kw
    s = nwin * win
    q, k, v = (_rand(gen, b, heads, s, d, dtype=dt) for _ in range(3))
    bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.3)
    bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.3)
    kw_ = dict(kv_grid=grid, window_tokens=win, block_q=s, block_k=s)
    assert A.flash_attention_route(q, k, v, bh, bw, **kw_) == "hopper_window"
    A.reset_launch_counts()
    got = A.flash_attention(q, k, v, bh, bw, **kw_)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention"] == 1
    want = A.flash_attention_plain(q, k, v, bh, bw, kv_grid=grid,
                                   window_tokens=win, scale=d ** -0.5)
    gap = ((got.float() - want.float()).abs()
           - RTOL[dt] * want.float().abs()).max().item()
    print(f"K3 window hopper {case}: gap {gap:.3e}")
    assert torch.isfinite(got.float()).all() and gap <= K3_ATOL[dt], gap
    assert torch.equal(got, A.flash_attention(q, k, v, bh, bw, **kw_))


# The register-tiled fp32 forward (csrc/f32_tiled_forward.cuh) that K2's
# and K3's fp32 calls take: name -> (B, S, Kh, Kw, kv_len). Ragged S (40,
# 200, the last 64-row block and 32-key tile cut short), key-grid rows of 14,
# 20 and 64 keys (a tile crosses grid rows at 14 and 20), no bias, and
# kv_len with a row that has no valid key (it averages V over all S keys).
K2_TILED_CASES = {"s40_kw20": (2, 40, 2, 20, None),
                  "s200_kw20": (2, 200, 10, 20, None),
                  "s196_kw14": (1, 196, 14, 14, None),
                  "s320_kw64": (1, 320, 5, 64, None),
                  "nobias_s200": (2, 200, 0, 0, None),
                  "kv_len_zero_row": (2, 200, 0, 0, (0, 150)),
                  "bias_kv_len": (2, 60, 3, 20, (0, 31))}


def _k2_tiled_inputs(gen, case, heads=4, d=64):
    b, s, kh, kw, kv_len = K2_TILED_CASES[case]
    dt = torch.float32
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = kl = None
    if kh:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.5)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.5)
    if kv_len:
        kl = torch.tensor(kv_len, device="cuda")
    return (q, kv, bh, bw, kl), dict(num_heads=heads, scale=d ** -0.5)


@pytest.mark.parametrize("case", sorted(K2_TILED_CASES))
def test_global_tiled_f32_matches_plain(gen, case):
    """K2's fp32 calls take the tiled body and hold to the plain version
    at 2e-5."""
    args, kwargs = _k2_tiled_inputs(gen, case)
    assert A.fused_global_attention_route(*args, **kwargs) == "tiled"
    A.reset_launch_counts()
    got = A.fused_global_attention(*args, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_global_attention"] == 1
    want = A.fused_global_attention_plain(*args, **kwargs)
    gap = (got - want).abs().max().item()
    print(f"K2 tiled {case}: {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= 2e-5, gap


# K3's fp32 calls at D 64: name -> (B, Sq, Kh, Kw, kv_grid, kv_len,
# window_tokens). A padded grid whose valid columns stop short of Kw
# (@768's 48 of 64, and 13 of 20 across tiles), Sq != Sk, kv_len with a
# row that has no valid key (it averages V over the Sk keys), and kv_grid
# with kv_len (29 ends in a grid row's masked columns); in window mode
# 16 x 16 windows with 14 x 14 valid (SAM's grouped layout) and whole, 8 x
# 8 windows with 7 x 6 valid, unpadded 14 x 14 windows (196 rows: a ragged
# last 64-row block) and an odd count of them.
K3_TILED_CASES = {"grid_3x64_48": (2, 192, 3, 64, (3, 48), None, None),
                  "grid_sq100": (1, 100, 3, 64, (2, 48), None, None),
                  "grid_5x20_13": (2, 70, 5, 20, (4, 13), None, None),
                  "kv_len_zero_row": (3, 150, 0, 192, None, (0, 77, 192),
                                      None),
                  "grid_kv_len": (2, 48, 6, 8, (4, 6), (0, 29), None),
                  "window_16x16_14x14": (2, 512, 16, 16, (14, 14), None,
                                         256),
                  "window_16x16_whole": (1, 768, 16, 16, (16, 16), None,
                                         256),
                  "window_8x8_7x6": (2, 192, 8, 8, (7, 6), None, 64),
                  "window_14x14": (1, 392, 14, 14, (14, 14), None, 196),
                  "window_14x14_odd": (2, 588, 14, 14, (13, 12), None, 196)}


def _k3_tiled_inputs(gen, case, heads=3, d=64):
    """The operands and the wrapper's keywords (window mode: JAX's blocks
    one a call, as they must divide by the window)."""
    b, sq, kh, kw, grid, kv_len, win = K3_TILED_CASES[case]
    sk = sq if win else kh * kw if kh else kw
    dt = torch.float32
    q = _rand(gen, b, heads, sq, d, dtype=dt)
    k = _rand(gen, b, heads, sk, d, dtype=dt)
    v = _rand(gen, b, heads, sk, d, dtype=dt)
    bh = bw = kl = None
    if kh:
        bh = _rand(gen, b, heads, sq, kh, dtype=dt, scale=0.5)
        bw = _rand(gen, b, heads, sq, kw, dtype=dt, scale=0.5)
    if kv_len:
        kl = torch.tensor(kv_len, device="cuda")
    if win:
        return (q, k, v, bh, bw, kl), dict(kv_grid=grid, window_tokens=win,
                                           block_q=sq, block_k=sq)
    return (q, k, v, bh, bw, kl), dict(kv_grid=grid)


@pytest.mark.parametrize("case", sorted(K3_TILED_CASES))
def test_flash_tiled_f32_matches_plain(gen, case):
    """K3's fp32 calls at D 64 take the tiled body (in window mode one
    (batch, window, head) a problem) and hold to the plain version at
    2e-5, every query row of a window stored."""
    args, kwargs = _k3_tiled_inputs(gen, case)
    assert A.flash_attention_route(*args, **kwargs) == "tiled"
    A.reset_launch_counts()
    got = A.flash_attention(*args, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention"] == 1
    want = A.flash_attention_plain(
        *args, scale=0.125, kv_grid=kwargs["kv_grid"],
        window_tokens=kwargs.get("window_tokens"))
    gap = (got - want).abs().max().item()
    print(f"K3 tiled {case}: {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= 2e-5, gap


# K1's fp32 calls on the tiled body: (B, windows a batch row, Kh, Kw, bias):
# SAM's 196-token windows (three 64-row blocks and one of 4 rows, 7 key
# tiles of 32, 28 slots absent), without a bias, and 7 x 7 windows
K1_TILED_CASES = {"sam_14x14": (2, 3, 14, 14, True),
                  "sam_14x14_no_bias": (1, 2, 14, 14, False),
                  "win_7x7": (2, 4, 7, 7, True)}


@pytest.mark.parametrize("case", sorted(K1_TILED_CASES))
def test_window_tiled_f32_matches_plain(gen, case):
    """K1's fp32 calls take the tiled body (one (window, head) a problem)
    and hold to the plain version at 2e-5; two launches give the same
    bits."""
    b, n_win, kh, kw, biased = K1_TILED_CASES[case]
    heads, d, dt = 2, 64, torch.float32
    win = kh * kw
    s = n_win * win
    q = _rand(gen, b, s, heads * d, dtype=dt)
    kv = _rand(gen, b, s, 2 * heads * d, dtype=dt)
    bh = bw = None
    if biased:
        bh = _rand(gen, b, heads, s, kh, dtype=dt, scale=0.5)
        bw = _rand(gen, b, heads, s, kw, dtype=dt, scale=0.5)
    kwargs = dict(num_heads=heads, window_tokens=win, scale=d ** -0.5)
    assert A.fused_window_attention_route(q, kv, bh, bw, **kwargs) == "tiled"
    A.reset_launch_counts()
    got = A.fused_window_attention(q, kv, bh, bw, **kwargs)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_window_attention"] == 1
    want = A.fused_window_attention_plain(q, kv, bh, bw, **kwargs)
    gap = (got - want).abs().max().item()
    print(f"K1 tiled {case}: {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= 2e-5, gap
    assert torch.equal(got, A.fused_window_attention(q, kv, bh, bw,
                                                     **kwargs))


def test_tiled_f32_forward_is_deterministic(gen):
    """No atomics: two launches of the tiled body give the same bits."""
    args, kwargs = _k2_tiled_inputs(gen, "s200_kw20")
    assert torch.equal(A.fused_global_attention(*args, **kwargs),
                       A.fused_global_attention(*args, **kwargs))
    for case in ("grid_3x64_48", "window_14x14_odd"):
        args, kwargs = _k3_tiled_inputs(gen, case)
        assert torch.equal(A.flash_attention(*args, **kwargs),
                           A.flash_attention(*args, **kwargs))


def test_tiled_f32_forward_builds_without_spill(gen, tmp_path, monkeypatch):
    """The tiled body's kernels (with and without bias in each of the four
    sources that carry it, and K3's window-mode instance) fit their
    registers: ptxas (-Xptxas -v, the build's flags) reports no spill bytes
    for them. K3's loops keep no fp32 instance at D 64."""
    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    instances = {"fused_window_attention": 2, "fused_global_attention": 2,
                 "flash_attention": 3, "flash_attention_fwd": 2}
    logs = cb.build_all(tuple(instances))
    for name, n in instances.items():
        tiled = {f: r for f, r in cb.ptxas_functions(logs[name]).items()
                 if "tiled_kernel" in f}
        print(name, tiled)
        assert len(tiled) == n and all(
            r["spill"] == 0 and r["registers"] > 0 for r in tiled.values()), \
            logs[name]
    loops = [f for f in cb.ptxas_functions(logs["flash_attention"])
             if "flash_f32_kernel" in f]
    assert len(loops) == 2 and not any("ILi64E" in f for f in loops), loops


# K7 (fused LayerNorm -> MLP -> residual): bf16 within one bf16 step
# (2^-7·|want|) plus K7_ATOL, fp32 within K7_ATOL alone. Measured on an
# H100 SXM: bf16 6.35e-3 (the branch output and the residual sum round
# twice; a flip of the first moves the second), fp32 6.3e-6; K3 bf16
# 3.5e-3, fp32 1.6e-6; the limits are about 1.5 times that.
K7_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype,c,hidden,rows", [
    (torch.bfloat16, 768, 3072, 100), (torch.bfloat16, 384, 1536, 37),
    (torch.float32, 768, 3072, 37), (torch.float32, 384, 1536, 20)])
@pytest.mark.parametrize("with_ls", [False, True])
def test_fused_mlp_kernel_matches_plain(gen, dtype, c, hidden, rows,
                                        with_ls):
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    x = _rand(gen, 2, rows, c, dtype=dtype)
    ln_s = 1.0 + 0.1 * _rand(gen, c, dtype=torch.float32)
    ln_b = 0.1 * _rand(gen, c, dtype=torch.float32)
    w1 = _rand(gen, hidden, c, dtype=torch.float32, scale=c ** -0.5).t()
    b1 = 0.02 * _rand(gen, hidden, dtype=torch.float32)
    w2 = _rand(gen, c, hidden, dtype=torch.float32,
               scale=hidden ** -0.5).t()
    b2 = 0.02 * _rand(gen, c, dtype=torch.float32)
    ls = 0.1 + 0.02 * _rand(gen, c, dtype=torch.float32) if with_ls else None
    args = (x, ln_s, ln_b, w1, b1, w2, b2, ls)
    A.reset_launch_counts()
    got = M.fused_ln_mlp_residual(*args).float()
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 1
    want = M.fused_ln_mlp_residual_plain(*args).float()
    gap = ((got - want).abs() - RTOL[dtype] * want.abs()).max().item()
    print(f"K7 C={c} {dtype} ls={with_ls}: gap {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= K7_ATOL[dtype], gap


# K7's Hopper body (bf16, C 768, hidden 3072: SAM ViT-B/16 and DINOv2
# ViT-B/14) at row counts around its 64-row tile and DINOv2's 4 x 1370
# rows (86 tiles, the last ragged), held to chip_smoke.py's K7_ATOL (the
# limit at the path's shapes: the more rows, the more double roundings
# that may flip, 1.49e-2 measured at 16384 rows on the first version)
K7_HOPPER_ATOL = 2.5e-2


def _k7_inputs(gen, rows, c, hidden, with_ls, dtype=torch.bfloat16):
    x = _rand(gen, rows, c, dtype=dtype)
    ln_s = 1.0 + 0.1 * _rand(gen, c, dtype=torch.float32)
    ln_b = 0.1 * _rand(gen, c, dtype=torch.float32)
    w1 = _rand(gen, hidden, c, dtype=dtype, scale=c ** -0.5).t()
    b1 = 0.02 * _rand(gen, hidden, dtype=torch.float32)
    w2 = _rand(gen, c, hidden, dtype=dtype, scale=hidden ** -0.5).t()
    b2 = 0.02 * _rand(gen, c, dtype=torch.float32)
    ls = 0.1 + 0.02 * _rand(gen, c, dtype=torch.float32) if with_ls else None
    return x, ln_s, ln_b, w1, b1, w2, b2, ls


@pytest.mark.parametrize("rows", [1, 63, 65, 100, 5480])
@pytest.mark.parametrize("with_ls", [False, True])
def test_fused_mlp_hopper_matches_plain(gen, rows, with_ls):
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    args = _k7_inputs(gen, rows, 768, 3072, with_ls)
    assert M.fused_ln_mlp_residual_route(*args) == "hopper"
    A.reset_launch_counts()
    got = M.fused_ln_mlp_residual(*args).float()
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 1
    want = M.fused_ln_mlp_residual_plain(*args).float()
    gap = ((got - want).abs() - RTOL[torch.bfloat16] * want.abs()).max()
    print(f"K7 hopper rows={rows} ls={with_ls}: gap {gap.item():.3e}")
    assert torch.isfinite(got).all() and gap.item() <= K7_HOPPER_ATOL, gap


@pytest.mark.parametrize("rows", [1, 31, 33, 63, 65, 129, 300, 1370, 5480])
@pytest.mark.parametrize("with_ls", [False, True])
def test_fused_mlp_c1536_matches_plain(gen, rows, with_ls):
    """K7 at DINOv2 ViT-g/14's width (C 1536, hidden 6144, bf16): the
    cluster body (four blocks a 128-row tile), at row counts that leave the
    row tile, the warpgroup's 64 rows, the cluster's tiles and the last
    round of persistent clusters ragged (1370 and 5480 are ViT-g/14's
    rows at batch 1 and 4), held to the K7 limit."""
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    args = _k7_inputs(gen, rows, 1536, 6144, with_ls)
    assert M.fused_ln_mlp_residual_route(*args) == "cluster"
    A.reset_launch_counts()
    got = M.fused_ln_mlp_residual(*args).float()
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 1
    want = M.fused_ln_mlp_residual_plain(*args).float()
    gap = ((got - want).abs() - RTOL[torch.bfloat16] * want.abs()).max()
    print(f"K7 C 1536 rows={rows} ls={with_ls}: gap {gap.item():.3e}")
    assert torch.isfinite(got).all() and gap.item() <= K7_HOPPER_ATOL, gap


# K7 fp32 at C 1536: sums of 6144 hidden units in another order than
# cuBLAS's; about 1.6 times the largest gap measured on an H100 SXM
# (1.22e-5, 300 rows without layerscale; PERF.md)
K7_F32_WIDE_ATOL = 2e-5


@pytest.mark.parametrize("rows", [1, 17, 300])
@pytest.mark.parametrize("with_ls", [False, True])
def test_fused_mlp_f32_c1536_matches_plain(gen, rows, with_ls):
    """K7 in fp32 at C 1536 (hidden 6144): the loops' instance of 16-row
    blocks and 8-unit hidden chunks, two threads a (row, unit) dot product,
    fp32 FMAs with no TF32, against the plain version in fp32 (TF32 off:
    torch's default for matmuls), within K7_F32_WIDE_ATOL."""
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    args = _k7_inputs(gen, rows, 1536, 6144, with_ls, torch.float32)
    assert M.fused_ln_mlp_residual_route(*args) == "loops"
    A.reset_launch_counts()
    got = M.fused_ln_mlp_residual(*args)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_ln_mlp_residual"] == 1
    want = M.fused_ln_mlp_residual_plain(*args)
    gap = (got - want).abs().max().item()
    print(f"K7 fp32 C 1536 rows={rows} ls={with_ls}: gap {gap:.3e}")
    assert torch.isfinite(got).all() and gap <= K7_F32_WIDE_ATOL, gap


@pytest.mark.parametrize("c,hidden,dtype,route", [
    (768, 3040, torch.bfloat16, "loops"), (384, 1536, torch.bfloat16, "loops"),
    (768, 3072, torch.float32, "loops"), (768, 3072, torch.bfloat16, "hopper"),
    (1536, 6144, torch.bfloat16, "cluster"),
    (1536, 6160, torch.bfloat16, "loops")])
def test_fused_mlp_route(gen, c, hidden, dtype, route):
    """The Hopper body takes bf16 at C 768 with a hidden width that is a
    multiple of its 128-unit chunk, the cluster body bf16 at C 1536 with a
    multiple of its 256-unit chunk; a bf16 width of 32-unit chunks (16 at
    C 1536), another C or fp32 keeps the loops, which still match the
    plain version."""
    from vit_deep_radiomics_tpu_torch.ops import mlp_fused as M

    args = _k7_inputs(gen, 70, c, hidden, False, dtype)
    assert M.fused_ln_mlp_residual_route(*args) == route
    got = M.fused_ln_mlp_residual(*args).float()
    want = M.fused_ln_mlp_residual_plain(*args).float()
    gap = ((got - want).abs() - RTOL[dtype] * want.abs()).max().item()
    assert torch.isfinite(got).all() and gap <= K7_ATOL[dtype], gap


def test_k7_k8_hopper_bodies_build_without_spill(gen, tmp_path, monkeypatch):
    """K7's Hopper kernels (the C 768 body and the C 1536 cluster body) and
    K8's fit their registers: ptxas reports no spill bytes and no wgmma
    serialisation (C75xx) for them."""
    from vit_deep_radiomics_tpu_torch.utils import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    logs = cb.build_all(("fused_ln_mlp_residual", "int8_matmul"))
    for name, count in (("fused_ln_mlp_residual", 2), ("int8_matmul", 1)):
        funcs = {f: r for f, r in cb.ptxas_functions(logs[name]).items()
                 if "hopper_kernel" in f}
        print(name, funcs)
        assert len(funcs) == count and all(
            r["spill"] == 0 for r in funcs.values()), logs[name]
        assert "C75" not in logs[name], logs[name]
    # the C 1536 loop instance (32-row blocks) keeps its 192 accumulators
    # in registers
    wide = {f: r for f, r in cb.ptxas_functions(
        logs["fused_ln_mlp_residual"]).items()
        if "mlp_bf16_kernel" in f and "1536" in f}
    print(wide)
    assert len(wide) == 1 and all(r["spill"] == 0 for r in wide.values())


# K8 at the backbone's five contractions (K, N) under `int8`
K8_SHAPES = {"q": (768, 768), "kv": (768, 1536), "proj": (768, 768),
             "lin1": (768, 3072), "lin2": (3072, 768)}


@pytest.mark.parametrize("label", sorted(K8_SHAPES))
@pytest.mark.parametrize("m", [128, 384, 19712])
def test_int8_matmul_backbone_shapes_are_exact(gen, m, label):
    from vit_deep_radiomics_tpu_torch.ops import quant as Q

    k, n = K8_SHAPES[label]
    x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = Q.int8_matmul_nk(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, Q.int8_matmul_plain(x, w.t().contiguous()))


def test_int8_matmul_ragged_tile_queue_is_exact(gen):
    """133 row blocks x 3 column tiles: 399 tiles, which the 132 persistent
    blocks of an H100 SXM share unevenly (3 or 4 each)."""
    from vit_deep_radiomics_tpu_torch.ops import quant as Q

    x = torch.randint(-127, 128, (133 * 128, 256), generator=gen,
                      device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (384, 256), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = Q.int8_matmul_nk(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, Q.int8_matmul_plain(x, w.t().contiguous()))


@pytest.mark.parametrize("m,k,n", [(256, 384, 256), (384, 768, 1536),
                                   (128, 3072, 768)])
def test_int8_matmul_kernel_is_exact(gen, m, k, n):
    """K8 equals the exact product (float64 on the card) bit for bit, in
    both layouts."""
    from vit_deep_radiomics_tpu_torch.ops import quant as Q

    x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    A.reset_launch_counts()
    got = Q.int8_matmul(x, w)
    got_nk = Q.int8_matmul_nk(x, w.t().contiguous())
    torch.cuda.synchronize()
    assert A.LAUNCHES["int8_matmul"] == 2 and got.dtype == torch.int32
    want = Q.int8_matmul_plain(x, w)
    assert torch.equal(got, want) and torch.equal(got_nk, want)
    with pytest.raises(ValueError, match="128-multiple"):
        Q.int8_matmul(x[:100], w)


def test_int8_dot_pads_rows_for_the_kernel(gen):
    """int8_dot_prequant on the card (K8 over rows padded to 128) equals the
    same computation on the CPU (exact int64 product) bit for bit."""
    from vit_deep_radiomics_tpu_torch.ops import quant as Q

    x = _rand(gen, 2, 98, 768, dtype=torch.bfloat16)
    w = _rand(gen, 1536, 768, dtype=torch.bfloat16, scale=0.05)
    A.reset_launch_counts()
    got = Q.int8_dot(x, w.t())
    torch.cuda.synchronize()
    assert A.LAUNCHES["int8_matmul"] == 1
    want = Q.int8_dot(x.cpu(), w.cpu().t())
    assert torch.equal(got.cpu(), want)

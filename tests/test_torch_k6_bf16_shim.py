"""K6's bf16 bodies (``csrc/flash_trainable_bf16.cuh``: the forward with
the lse residual, dq with both bias gradients, dk/dv) run on the CPU against
the port's plain versions.

The bodies use CUDA-core arithmetic, shuffles, barriers and the warp's
``mma.sync.m16n8k16`` only, with control flow uniform over the block around
each mma and shuffle. So they also compile with g++ under a stand-in for
``flash_attention_core.cuh`` and the CUDA types: a block runs as 128
``std::thread``s, ``__syncthreads`` is a ``std::barrier``, a shuffle and an
mma go through block-wide arrays between two barriers (the mma reads the
bf16 A and B fragments of its warp's 32 lanes as the PTX ISA lays them out
and sums the 16 exact products in fp32), and bf16 rounding is to nearest
even. That checks the bodies' indexing, fragment layouts, masks, the bias
table and key table (a 48-wide key grid, whose 64-key tiles span two grid
rows; a 7-wide one, ragged everywhere), the kv_len rules (a row with no
valid key, a valid count inside a tile) and the fixed-order bias sums,
without the card, through the stand-in of ``tests/k6_bf16_shim.py``. The
same build holds the routes (``k6b::bwd_route``, and ``k6b::fwd_route``,
which ``ops/attention_grad.py::flash_attention_route`` reads through the
forward's C entry) and the Hopper bodies' tiling (``k6b::hopper_*``) to
their closed forms. The card's own checks are in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` phase 10.

Both sides are given the same bf16 inputs and, for the backward, the same
lse and delta (the plain forward's). The outputs are bf16 on both sides
after fp32 sums in other orders, so a rounding may flip: |kernel - plain|
<= RTOL·|plain| + ATOL with RTOL one bf16 step (2^-7) and ATOL 1.5e-3,
about 1.5 times the largest gap measured here beyond RTOL (9.6e-4, out);
the fp32 lse within 2e-6 (measured 9.5e-7) and the fp32 bias gradients
within 1e-3 (measured 4.9e-4: where a sum order flips the bf16 rounding of
one dS term).
"""

import numpy as np
import pytest
import torch

from k6_bf16_shim import SCALE, D, backward, build, forward
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G

RTOL, ATOL = 2.0 ** -7, 1.5e-3
LSE_ATOL, DBIAS_ATOL = 2e-6, 1e-3

# (B, H, S, Kh, Kw, kv_len): a 48-wide key grid over three key tiles (each
# spanning two grid rows), a 7 x 7 grid (one ragged block and tile), kv_len
# with a row that has no valid key over a ragged S, and a bias with a
# valid count inside a tile
CASES = {"grid_4x48": (1, 2, 192, 4, 48, None),
         "grid_7x7": (2, 1, 49, 7, 7, None),
         "kv_len_zero_row": (2, 1, 130, 0, 0, (0, 70)),
         "grid_10x10_kv_len": (2, 1, 100, 10, 10, (37, 100))}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    try:
        return build(tmp_path_factory.mktemp("k6_bf16_shim"))
    except FileNotFoundError as exc:
        pytest.skip(str(exc))


@pytest.fixture(scope="module")
def route_lib(tmp_path_factory):
    """The bf16 shape predicates (``k6b::bwd_route``, ``k6b::fwd_route``)
    and the Hopper bodies' tiling (``k6b::hopper_*``) built alone under the
    same stand-in."""
    try:
        return build(tmp_path_factory.mktemp("k6_bf16_route"), "route")
    except FileNotFoundError as exc:
        pytest.skip(str(exc))


# (has_bias, Kh, Kw) -> the code of the body the bf16 backward and forward
# run: 2 the Hopper bodies (TMA + wgmma), 1 the mma.sync bodies, -2
# refused; (backward, forward) where the two differ (Kw 2 mod 4: the
# backward's Hopper bodies, the forward's mma.sync one)
ROUTES = {"sam768": ((1, 48, 48), 2),
          "kw48_kh5": ((1, 5, 48), 2),
          "kw48_kh128": ((1, 128, 48), 2),
          "no_bias": ((0, 0, 0), 2),
          "kw16": ((1, 16, 16), 2),
          "kw18": ((1, 18, 18), (2, 1)),
          "kw20": ((1, 20, 20), 2),
          "sam544_kw34": ((1, 34, 34), (2, 1)),
          "sam576_kw36": ((1, 36, 36), 2),
          "sam608_kw38": ((1, 38, 38), (2, 1)),
          "sam640_kw40": ((1, 40, 40), 2),
          "sam704_kw44": ((1, 44, 44), 2),
          "sam832_kw52": ((1, 52, 52), 2),
          "sam896_kw56": ((1, 56, 56), 2),
          "kw58": ((1, 58, 58), (2, 1)),
          "sam960_kw60": ((1, 60, 60), 2),
          "sam1152_kw72": ((1, 72, 72), 2),
          "sam1280_kw80": ((1, 80, 80), 2),
          "sam1536_kw96": ((1, 96, 96), 2),
          "kw98": ((1, 98, 98), (2, 1)),
          "kw64": ((1, 64, 64), 2),
          "kw124": ((1, 124, 124), 2),
          "kw126": ((1, 126, 126), (2, 1)),
          "kw128": ((1, 128, 128), 2),
          "kw48_kh129": ((1, 129, 48), 1),
          "kw40_kh129": ((1, 129, 40), 1),
          "kh129_kw34": ((1, 129, 34), 1),
          "kw7": ((1, 7, 7), 1),
          "kw8": ((1, 8, 8), 1),
          "kw14": ((1, 14, 14), 1),
          "kw37": ((1, 37, 37), 1),
          "kw12": ((1, 12, 12), 1),
          "kw132": ((1, 4, 132), 1),
          "kw49": ((1, 48, 49), 1),
          "kw136": ((1, 8, 136), 1),
          "kw48_kh272": ((1, 272, 48), 1),
          "over_320_terms": ((1, 273, 48), -2),
          "kw400": ((1, 1, 400), -2)}


def _codes(case):
    """(args, backward's code, forward's code) of a ``ROUTES`` case."""
    args, want = ROUTES[case]
    bwd, fwd = want if isinstance(want, tuple) else (want, want)
    return args, bwd, fwd


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_bwd_route_takes_the_hopper_bodies_at_kw48(route_lib, case):
    """Calls with no bias and every key grid of an even width from 16 to
    128 (SAM ViT-B/16's global grids at 544 to 1536 px: Kw 34-96; 48 at
    768 px; the widths 4 mod 8 among them at 576, 704, 832 and 960 px, 2
    mod 4 at 544 and 608 px) with at most 128 grid rows go to the Hopper
    bodies; other widths (14 x 14 windows, Kw 37 at 592 px, Kw 7, 8, 12,
    49, 132, 136) and grids past 128 rows, whose bias_h table would not fit
    dq's shared memory, to the mma.sync bodies; grids of more than 320
    terms are refused."""
    args, bwd, _ = _codes(case)
    assert route_lib.route(*args) == bwd


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_fwd_route_is_the_bwd_route(route_lib, case):
    """The forward takes its Hopper body where the backward takes its
    Hopper bodies at a width that is a multiple of 4 (its instances), its
    mma.sync body at Kw 2 mod 4, where the backward takes its Hopper
    bodies (they rebuild the scores against the lse that body gives), and
    elsewhere the backward's choice: the mma.sync bodies where they take
    theirs, and refuses what they refuse."""
    args, bwd, fwd = _codes(case)
    assert route_lib.fwd(*args) == fwd
    if args[0] and args[2] % 4 == 2 and 16 <= args[2] <= 128 and \
            args[1] <= 128:
        assert (bwd, fwd) == (2, 1)
    else:
        assert fwd == bwd == route_lib.route(*args)


class _FwdSource:
    """A stand-in for the forward's library (``csrc/flash_attention_fwd.cu``)
    whose route entry ``vdr_flash_attention_route`` answers as the C one:
    -1 for a head dim other than 64, 0 for fp32, else ``k6b::fwd_route``
    from the g++ build."""

    def __init__(self, route_lib):
        self.route_lib = route_lib

    def vdr_flash_attention_route(self, dtype, d, has_bias, kh, kw):
        if d != 64:
            return -1
        return 0 if dtype == 0 else self.route_lib.fwd(has_bias, kh, kw)

    @staticmethod
    def vdr_error_string(rc):
        return b"bias grid of more than 320 terms (Kh + Kw) in bf16"

    def load(self, name, argtypes, entry=None):
        assert name == "flash_attention_fwd"
        return self, getattr(self, entry)


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_flash_attention_route_names_the_fwd_body(route_lib, case,
                                                   monkeypatch):
    """``flash_attention_route`` names the body the forward's C entry
    reports for bf16 operands on the card: "hopper" for code 2, "mma" for
    code 1, and raises for a refused grid; fp32 operands name "tiled".
    Meta tensors stand in for CUDA ones, the g++ build of
    ``k6b::fwd_route`` for the entry."""
    (has_bias, kh, kw), _, want = _codes(case)
    monkeypatch.setattr(G, "_load", _FwdSource(route_lib).load)
    s = kh * kw if has_bias else 256

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device="meta", dtype=dtype)

    q = meta(1, 1, s, D)
    bias = ((meta(1, 1, s, kh, dtype=torch.float32),
             meta(1, 1, s, kw, dtype=torch.float32)) if has_bias
            else (None, None))
    if want < 0:
        with pytest.raises(RuntimeError, match="320 terms"):
            G.flash_attention_route(q, q, q, *bias)
    else:
        assert G.flash_attention_route(q, q, q, *bias) == \
            {2: "hopper", 1: "mma"}[want]
    q32 = q.float()
    assert G.flash_attention_route(q32, q32, q32, *bias) == "tiled"


# the widths of the forward's Hopper instances, and of dq's and dkv's
HOPPER_KWS = range(16, 129, 4)
BWD_KWS = range(16, 129, 2)


def _term_bytes(kw):
    """dkv's bf16 bias_w terms a stage: key-major at Kw 2 mod 4 (Kw rows of
    64 queries, 72 apart), else [query][ld] with each term once (ld Kw, or
    Kw + 8 where Kw / 8 is even) or twice (Kw 4 mod 8: 2 Kw)."""
    if kw % 4 == 2:
        return kw * 72 * 2
    ld = 2 * kw if kw % 8 else kw if (kw // 8) % 2 else kw + 8
    return 64 * ld * 2


def _dkv_stages(kw):
    """The most stages (4 at most, 2 at least) of dkv's query-tile ring
    that fit in 227 KB beside the K and V tiles: a stage holds q, dO and
    Q^ (8 KB each), the tile's fp32 bias_w rows (256 Kw bytes), its bf16
    terms (``_term_bytes``), and lse, D and the bias_h terms of the block's
    grid rows (256 bytes each), rounded up to 1 KB."""
    stage = 3 * 8192 + 256 * kw + _term_bytes(kw) + 256 * (2 + 127 // kw + 2)
    stage = -(-stage // 1024) * 1024
    n = 4
    while n > 2 and 1024 + 4 * 8192 + n * stage > 232448 - 256:
        n -= 1
    return n


@pytest.mark.parametrize("kw", BWD_KWS)
def test_hopper_tiling_holds_its_closed_form(route_lib, kw):
    """dq takes a grid row in one pass up to Kw 56, else in ceil(Kw / 48)
    passes, each a key tile of the row's share rounded up to a k16 step and
    every pass but the last whole (so no pass holds more than 56 live
    columns, a tile of several passes at most 48 keys, no masked pass comes
    before a whole one, and the passes cover the row), each pass ending on
    a column pair; dkv's block of 128 aligned keys spans floor(127 / Kw) +
    2 grid rows at most; every 8-key block of a warp reads its 8
    consecutive keys' terms from an aligned place: at Kw 0 mod 8 one
    16-byte chunk of a query's row that holds each term once (column key %
    Kw), at Kw 4 mod 8 of one that holds them twice (column key % (2 Kw),
    also where the block wraps a grid row), rows an odd number of chunks
    apart; at Kw 2 mod 4 eight key-major rows (key % Kw each), 16-byte
    aligned, 9 chunks apart; there the fp32 bias_w rows of a query tile
    come by bulk copy, whose source offset and size are multiples of 16
    bytes for every Kh up to 128, head and tile, the last partial one
    too; its ring has the most stages that fit in 227 KB (Kw 0 mod 8: 4
    up to 56, 3 up to 96, 2 beyond; Kw 4 mod 8: 4 up to 44, 3 up to 76, 2
    beyond; Kw 2 mod 4: 4 up to 54, 3 up to 98, 2 beyond); dq's shared
    memory at Kh 128 fits too."""
    n = 1 if kw <= 56 else -(-kw // 48)
    tile = -(-(-(-kw // n)) // 16) * 16
    assert route_lib.passes(kw) == n and route_lib.tile(kw) == tile
    assert (n - 1) * tile < kw <= n * tile
    assert min(tile, kw) <= 56 and (n == 1 or tile <= 48)
    assert (kw - (n - 1) * tile) % 2 == 0
    assert route_lib.hrows(kw) == 127 // kw + 2
    rows = {(k0 + j) // kw for k0 in range(0, 128 * kw, 128)
            for j in (0, 127)}
    spans = [(k0 + 127) // kw - k0 // kw + 1 for k0 in range(0, 128 * kw,
                                                           128)]
    assert max(spans) <= route_lib.hrows(kw) and rows
    ld = route_lib.term_ld(kw)
    assert ld % 8 == 0 and (ld // 8) % 2 == 1
    assert route_lib.term_bytes(kw) == _term_bytes(kw)
    if kw % 4 == 2:
        # key-major: the lane of key block row r of query block qb reads
        # row (kb + r) % Kw at query 8 qb, 16-byte aligned
        assert route_lib.term_key_major(kw) and ld == 72
        for kb in range(0, 4 * kw * 8, 8):
            for r in range(8):
                for qb in range(8):
                    addr = (((kb + r) % kw) * ld + 8 * qb) * 2
                    assert addr % 16 == 0 and \
                        addr + 16 <= route_lib.term_bytes(kw)
        # the bulk copy of a query tile's fp32 rows (S = Kh Kw)
        for kh in range(1, 129):
            s = kh * kw
            for head in range(3):
                for j in {0, (s - 1) // 64}:
                    rows_j = min(64, s - 64 * j)
                    assert 4 * kw * (head * s + 64 * j) % 16 == 0
                    assert rows_j * kw * 4 % 16 == 0 and rows_j > 0
    else:
        period = route_lib.term_period(kw)
        assert not route_lib.term_key_major(kw) and ld >= period
        assert period == (kw if kw % 8 == 0 else 2 * kw)
        # every block of 8 keys (a multiple of 8 apart) reads 8 consecutive
        # keys' terms from one aligned 16-byte chunk of the doubled or
        # single row, whose column x holds the term of grid column x % Kw
        for kb in range(0, 4 * kw * 8, 8):
            col = kb % period
            assert col % 8 == 0 and col + 8 <= ld
            assert [(col + i) % kw for i in range(8)] == \
                [(kb + i) % kw for i in range(8)]
    stages = route_lib.stages(kw)
    assert stages == _dkv_stages(kw)
    if kw % 8 == 0:
        assert stages == (4 if kw <= 56 else 3 if kw <= 96 else 2)
    elif kw % 4 == 0:
        assert stages == (4 if kw <= 44 else 3 if kw <= 76 else 2)
    else:
        assert stages == (4 if kw <= 54 else 3 if kw <= 98 else 2)
    limit = 232448
    assert route_lib.dkv_smem(kw) <= limit
    assert route_lib.dq_smem(kw, 128) <= limit


@pytest.mark.parametrize("kw", HOPPER_KWS)
def test_hopper_fwd_tiling_is_dqs(route_lib, kw):
    """The forward's Hopper body walks dq's key tiles (a grid row in the
    same passes of the same tile), except at Kw 60 and 64, where it takes
    the row in one pass of 64 keys (dq two of 32: with no dP and no dq
    accumulator 64 live columns fit); its shared memory (the q tiles, a
    ring of 6 K/V stages of the tile, the bias_h table of 128 grid rows)
    fits in 227 KB at every width and with no bias."""
    if kw in (60, 64):
        assert (route_lib.fwd_passes(kw), route_lib.fwd_tile(kw)) == (1, 64)
    else:
        assert route_lib.fwd_passes(kw) == route_lib.passes(kw)
        assert route_lib.fwd_tile(kw) == route_lib.tile(kw)
    tile = route_lib.fwd_tile(kw)
    want = 1024 + 2 * 8192 + 2 * 6 * tile * 128 + 128 * 129 * 4
    assert route_lib.fwd_smem(kw, 128) == want <= 232448
    assert route_lib.fwd_smem(0, 0) == 1024 + 2 * 8192 + 2 * 6 * 64 * 128


def _inputs(case):
    b, h, s, kh, kw, kv_len = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dtype)

    q, k, v, dout = (t(b, h, s, D) for _ in range(4))
    bh = t(b, h, s, kh, scale=0.5, dtype=torch.float32) if kh else None
    bw = t(b, h, s, kw, scale=0.5, dtype=torch.float32) if kh else None
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    return (q, k, v, bh, bw, kl), dout


def _close(got, want, name, rtol=RTOL, atol=ATOL):
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - rtol * want.abs()).max().item()
    assert torch.isfinite(got).all() and gap <= atol, (name, gap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_plain(shim, case):
    args, _ = _inputs(case)
    kl = args[5]
    out, lse = forward(shim, *args, scale=SCALE)
    want_out, want_lse = G.flash_attention_fwd_plain(*args, scale=SCALE)
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse", rtol=0.0, atol=LSE_ATOL)
    if kl is not None and int(kl[0]) == 0:
        assert (lse[0] == -1e30).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_plain(shim, case):
    args, dout = _inputs(case)
    kl = args[5]
    out, lse = G.flash_attention_fwd_plain(*args, scale=SCALE)
    rest = (dout, lse, G.flash_attention_delta(out, dout))
    dq, dbh, dbw, dk, dv = backward(shim, *args, *rest, scale=SCALE)
    want_dq, want_dbh, want_dbw = G.flash_attention_bwd_dq_plain(
        *args, *rest, scale=SCALE)
    want_dk, want_dv = G.flash_attention_bwd_dkv_plain(*args, *rest,
                                                       scale=SCALE)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        _close(got, want, name)
    if args[3] is not None:
        _close(dbh, want_dbh, "dbias_h", rtol=0.0, atol=DBIAS_ATOL)
        _close(dbw, want_dbw, "dbias_w", rtol=0.0, atol=DBIAS_ATOL)
    if kl is not None:
        # keys past a non-zero kv_len get no gradient; a kv_len 0 row's
        # keys all take P = 1
        n = int(kl[1])
        assert not dk[1, :, n:].float().any() and \
            not dv[1, :, n:].float().any()
        if int(kl[0]) == 0:
            assert dv[0].float().abs().max() > 0

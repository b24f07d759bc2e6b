"""Probes of K2 (``csrc/fused_global_attention.cu``) on the GPU.

Two measurements that ``chip_smoke.py`` does not make::

    python -m vit_deep_radiomics_tpu_torch.utils.k2_probe variants
    python -m vit_deep_radiomics_tpu_torch.utils.k2_probe pair PARENT CHANGE

``variants`` builds copies of the source with one constant or one step
changed (the ring depth, the number of consumer warpgroups; the softmax
or the products removed: timing ablations whose output is wrong by
design), calls each through ``ctypes`` at the extraction shape (q (4,
4096, 768), Kh = Kw = 64) and DINOv2's kv_len shape (4 x 1536, 1370
valid), and prints its gap to the plain version and its time beside
SDPA's. ``pair`` runs two
checkouts in turns (parent, change, change, parent), each in a fresh
process: 10 `fast` SAM ViT-B/16 @1024 forwards at B=4 on the host clock,
then ``chip_smoke.py``'s extraction phase. Nothing is built or run at
import.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

__all__ = ["VARIANTS", "variant_source", "main"]

_SOFTMAX = ("probs(0);", "probs(j);")
_PRODUCTS = ("qk_tile(s, qa, k_addr);", "qk_tile(s, qa, k_addr + cur * kTile);",
             "pv_tile(o, pa, v_addr + prev * kTile);",
             "pv_tile(o, pa, v_addr + last * kTile);")
# name: (substitutions of `constexpr` values, calls removed)
VARIANTS = {
    "as_built": ({}, ()),
    "stages_4": ({"kStages": 4}, ()),
    "consumers_2": ({"kConsumers": 2}, ()),
    "no_softmax": ({}, _SOFTMAX),
    "no_products": ({}, _PRODUCTS),
}


def variant_source(text: str, consts: dict, removed=()) -> str:
    """The K2 source with `constexpr int` values replaced and, for the
    ablations, the listed calls (a tile's softmax, or its products) taken
    out."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"no single constexpr {name} in the source")
    for call in removed:
        if text.count(call) != 1:
            raise ValueError(f"no single {call} in the source")
        text = text.replace(call, ";")
    return text


def _ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _variants(out_dir: Path) -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import attention as A
    from . import cuda_build as cb

    out_dir.mkdir(parents=True, exist_ok=True)
    text = (cb.CSRC_DIR / "fused_global_attention.cu").read_text()
    jobs = {}
    for name, (consts, removed) in VARIANTS.items():
        cu = out_dir / f"k2_{name}.cu"
        cu.write_text(variant_source(text, consts, removed))
        cmd = [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o",
               str(out_dir / f"k2_{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        notes = [ln.strip() for ln in log.splitlines()
                 if "spill" in ln or "C75" in ln or "error" in ln]
        print(f"build {name}: rc {proc.returncode}; " + " | ".join(notes))
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"k2_{name}.so")) \
            .vdr_fused_global_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, d = 12, 64
    c = heads * d

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    for b, s, kh, kw, n_valid in ((4, 4096, 64, 64, None),
                                  (4, 1536, 0, 0, 1370)):
        q, kv = rand(b, s, c), rand(b, s, 2 * c)
        bh = bw = kl = None
        if kh:
            bh = rand(b, heads, s, kh, scale=0.3)
            bw = rand(b, heads, s, kw, scale=0.3)
        else:
            kl = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
        ref = A.fused_global_attention_plain(
            q, kv, bh, bw, kl, num_heads=heads, scale=d ** -0.5).float()
        print(f"shape q ({b}, {s}, {c}), Kw {kw}, kv_len {n_valid}:")
        for name, fn in fns.items():
            out = torch.empty_like(q)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

            def run(fn=fn, out=out, stream=stream):
                rc = fn(ptr(q), ptr(kv), ptr(bh), ptr(bw), ptr(kl), ptr(out),
                        b, s, heads, d, kh, kw, d ** -0.5, 1, stream)
                if rc:
                    raise RuntimeError(f"variant launch failed: {rc}")

            run()
            torch.cuda.synchronize()
            gap = ((out.float() - ref).abs() - 2 ** -7 * ref.abs()).max()
            print(f"  {name}: gap {gap.item():.3e} ms {_ms(torch, run):.4f}")
        heads_of = [t.reshape(b, s, heads, d).transpose(1, 2)
                    for t in (q, kv[..., :c], kv[..., c:])]
        if kh:
            mask = (bh.float()[..., :, None] + bw.float()[..., None, :]
                    ).reshape(b, heads, s, s).to(torch.bfloat16)
        else:
            key = torch.arange(s, device="cuda")
            mask = torch.zeros(b, heads, s, s, device="cuda",
                               dtype=torch.bfloat16).masked_fill(
                key >= n_valid, float("-inf"))
        lib = _ms(torch, lambda: F.scaled_dot_product_attention(
            *heads_of, attn_mask=mask), 10)
        print(f"  sdpa: ms {lib:.4f}")
        del mask, ref
        torch.cuda.empty_cache()


_PAIR_CHILD = r'''
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from vit_deep_radiomics_tpu_torch.core import precision
from vit_deep_radiomics_tpu_torch.data import synthetic as syn
from vit_deep_radiomics_tpu_torch.engine import extract as tex
from vit_deep_radiomics_tpu_torch.models import vit
from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.utils import cuda_build
cuda_build.build_all(("fused_window_attention", "fused_global_attention"))
m = vit.ViTDense(vit.SAM_VIT_B, policy=precision.FAST).init_random(0)
m = m.cuda().eval()
x = torch.rand(4, 1024, 1024, 3, device="cuda")
with torch.no_grad():
    for _ in range(3):
        m(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        m(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 10
print(f"forward fast B=4, mean of 10: {dt * 1e3:.3f} ms = {4 / dt:.2f} img/s",
      flush=True)
state = m.state_dict()
del m
torch.cuda.empty_cache()
cs.extraction_phase(torch, A, tex, syn, state)
'''


def _pair(parent: Path, change: Path) -> None:
    for tag, tree in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", _PAIR_CHILD], cwd=tree,
                             capture_output=True, text=True)
        print(f"{tag} ({tree}): rc {res.returncode}")
        for line in (res.stdout + res.stderr).splitlines():
            if line.startswith(("forward", "extraction", "Traceback")) or \
                    "Error" in line:
                print("  " + line[:240])
        if res.returncode:
            raise RuntimeError(f"{tag} run failed")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("variants", help="K2 variants at the path shapes")
    v.add_argument("--out", type=Path,
                   default=Path(__file__).resolve().parents[1] / "_build"
                   / "k2_variants")
    pr = sub.add_parser("pair", help="parent vs change, end to end")
    pr.add_argument("parent", type=Path)
    pr.add_argument("change", type=Path)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.cmd == "variants":
        _variants(args.out)
    else:
        _pair(args.parent.resolve(), args.change.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device-time profile of the backbone's forward or fine-tuning step on the GPU.

Counterpart of ``vit_deep_radiomics_tpu/utils/profiling.py`` for the
port: :func:`device_sync` is the fence for host-clock timing;
:func:`device_memory_stats` and :func:`memory_summary_gib` read the card's
allocator for report lines (the serve CLI's);
:func:`profile_forward` traces steady-state SAM ViT-B/16 forwards (any
policy, any image size; ``VDR_FUSED_MLP=1`` in the environment takes the
K7 path as the model does) and
:func:`profile_finetune_step` steady-state fine-tuning steps (SAM or a
DINOv2 config, ``fast`` or ``parity``, any image size) with
``torch.profiler``, and both
report device time by kernel, the wall time per forward or step and the
device's idle share. Run on the card::

    python -m vit_deep_radiomics_tpu_torch.utils.profiling --batch 4
    python -m vit_deep_radiomics_tpu_torch.utils.profiling --batch 4 \
        --precision int8 [--image-size 768]
    python -m vit_deep_radiomics_tpu_torch.utils.profiling --finetune \
        --batch 2 [--precision parity] [--backbone dinov2_vitb14]
    python -m vit_deep_radiomics_tpu_torch.utils.profiling --finetune \
        --batch 1 --image-size 2048
"""

from __future__ import annotations

import argparse
import json
import time

import torch

__all__ = ["device_sync", "device_memory_stats", "memory_summary_gib",
           "trace_runs", "profile_forward", "profile_finetune_step"]


def device_sync() -> None:
    """Wait for the device: host-clock timings end here."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_memory_stats(device=None) -> dict:
    """The allocator's counters for one CUDA device: ``bytes_in_use``,
    ``peak_bytes_in_use`` (since the last ``reset_peak_memory_stats``),
    ``bytes_reserved`` and the card's ``bytes_limit``; {} for the CPU or
    when no card is visible."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_reserved": torch.cuda.memory_reserved(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def memory_summary_gib(device=None) -> dict:
    """:func:`device_memory_stats` as the GiB numbers a report line
    carries: ``{hbm_peak_gib, hbm_limit_gib}``, {} on the CPU."""
    stats = device_memory_stats(device)
    if not stats:
        return {}
    return {"hbm_peak_gib": round(stats["peak_bytes_in_use"] / 2 ** 30, 3),
            "hbm_limit_gib": round(stats["bytes_limit"] / 2 ** 30, 3)}


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_kernel(evt) -> bool:
    """A device event that is a kernel, copy or memset: the optimizer's
    ``record_function`` ranges (``Optimizer.step#AdamW.step``) are mirrored
    on the device timeline and would count their kernels twice."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(evt) > 0
            and not getattr(evt, "is_user_annotation", False)
            and not evt.key.startswith("Optimizer."))


def trace_runs(run, steps: int, rows: int, **head) -> dict:
    """Two warm-up runs, then ``steps`` runs on the host clock without the
    profiler (the wall time), then ``steps`` traced runs (device time by
    kernel). The idle share compares the two, so the profiler's own host
    cost does not count as idle device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    run()
    device_sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    device_sync()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        device_sync()
    events = [e for e in prof.key_averages() if _is_kernel(e)]
    device_total = sum(_device_us(e) for e in events) / steps / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:rows]
    return {
        **head,
        "wall_ms": wall * 1e3,
        "device_ms": device_total,
        "idle_share": max(0.0, 1.0 - device_total / (wall * 1e3)),
        "top": [{"name": e.key[:90], "calls": e.count / steps,
                 "ms": _device_us(e) / steps / 1e3} for e in top],
    }


def profile_forward(batch: int = 4, precision: str = "fast",
                    steps: int = 3, rows: int = 25, seed: int = 0,
                    image_size: int = 1024) -> dict:
    """Full-width SAM ViT-B/16 forwards at ``image_size``: wall and device
    time per forward, the idle share and the top ``rows`` device ops."""
    import dataclasses
    import os

    from .. import default_device
    from ..core.precision import get_policy
    from ..models.vit import SAM_VIT_B, ViTDense

    dev = default_device()
    cfg = dataclasses.replace(SAM_VIT_B, image_size=image_size)
    model = ViTDense(cfg, policy=get_policy(precision)) \
        .init_random(seed).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    images = torch.rand(batch, image_size, image_size, 3, generator=gen,
                        device=dev)
    with torch.no_grad():
        return trace_runs(lambda: model(images), steps, rows,
                          what="forward", batch=batch, precision=precision,
                          image_size=image_size,
                          fused_mlp=os.environ.get("VDR_FUSED_MLP",
                                                   "0") == "1")


def profile_finetune_step(batch: int = 2, steps: int = 3, rows: int = 25,
                          seed: int = 0, precision: str = "fast",
                          backbone: str = "medsam",
                          image_size: int | None = None) -> dict:
    """Full-width fine-tuning steps (SAM ViT-B/16 or a DINOv2 config, at
    its own image size unless ``image_size`` is given; no remat): wall and
    device time per step, the idle share, the top ``rows`` device ops and
    the peak device memory. SAM at 2048 px runs its global layers' K5
    kernels on a key grid 128 keys wide."""
    import dataclasses

    from ..engine.finetune import FineTuneConfig, FineTuner

    config = FineTuneConfig(precision=precision, backbone=backbone)
    if image_size is not None:
        config = dataclasses.replace(config, backbone_cfg=dataclasses.replace(
            config.resolve_backbone(), image_size=image_size))
    tuner = FineTuner(config)
    state = tuner.init(seed=seed)
    dev = tuner.device
    size, grid = tuner.backbone_cfg.image_size, tuner.backbone_cfg.grid
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    images = torch.rand(batch, size, size, 3, generator=gen, device=dev)
    mask = torch.zeros(batch, grid, grid, dtype=torch.bool, device=dev)
    mask[:, grid * 3 // 8:grid * 5 // 8, grid * 3 // 8:grid * 5 // 8] = True
    labels = torch.eye(2, device=dev)[torch.arange(batch, device=dev) % 2]
    torch.cuda.reset_peak_memory_stats(dev)
    res = trace_runs(lambda: tuner.step(state, images, mask, labels),
                     steps, rows, what=f"finetune step {backbone}",
                     batch=batch, precision=precision, image_size=size)
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--precision", default="fast",
                   help="fast, parity, inference or int8 (the last two "
                        "forward only)")
    p.add_argument("--image-size", type=int, default=None,
                   help="the input size: SAM forwards 1024 unless given "
                        "(768 takes K3), fine-tuning the backbone's own "
                        "unless given (SAM at 2048 takes K5 on a key grid "
                        "128 keys wide)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rows", type=int, default=25)
    p.add_argument("--finetune", action="store_true",
                   help="profile fine-tuning steps instead of forwards")
    p.add_argument("--backbone", default="medsam",
                   help="with --finetune: medsam or a dinov2_* config")
    args = p.parse_args(argv)
    if args.finetune:
        res = profile_finetune_step(args.batch, args.steps, args.rows,
                                    precision=args.precision,
                                    backbone=args.backbone,
                                    image_size=args.image_size)
    else:
        res = profile_forward(args.batch, args.precision, args.steps,
                              args.rows, image_size=args.image_size or 1024)
    print(f"{res['what']} {res['precision']} B={res['batch']}: wall "
          f"{res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, idle "
          f"share {res['idle_share']:.3f}")
    for row in res["top"]:
        print(f"{row['ms']:9.3f} ms  {row['calls']:6.1f}x  {row['name']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

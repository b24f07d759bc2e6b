"""CLI: serving-artifact export, batched inference and the HTTP server.

Counterpart of ``vit_deep_radiomics_tpu/cli/serve.py`` with its
subcommands and flags. A model exports once to a ``.vdr`` artifact (its
config and baked weights, ``engine/serve.py``) and any later process runs
it on the card::

    # export (random weights from a seed when --model-path is absent)
    python -m vit_deep_radiomics_tpu_torch.cli.serve export \\
        --model-name medsam --model-path medsam_vit_b.pth \\
        --out models/serving/medsam_b4.vdr --batch 4

    python -m vit_deep_radiomics_tpu_torch.cli.serve info \\
        models/serving/medsam_b4.vdr

    # batched inference: (N, H, W, 3) float32 images -> features
    python -m vit_deep_radiomics_tpu_torch.cli.serve run \\
        models/serving/medsam_b4.vdr --input slices.npy \\
        --output features.npy

    # a fold checkpoint (model_epoch_NNNN.pt) as a classifier artifact
    python -m vit_deep_radiomics_tpu_torch.cli.serve export-clf \\
        models/petct/.../ct/kfold_0/model_epoch_0007.pt \\
        -a transformer -m ct --out ct_clf.vdr --batch 8 --max-tokens 512

    # raw scanner volumes -> logits in one artifact, served over HTTP
    python -m vit_deep_radiomics_tpu_torch.cli.serve export-pipeline \\
        model_epoch_0007.pt -m petct --input-mode raw-hu \\
        --pet-native-size 128 --out petct.vdr
    python -m vit_deep_radiomics_tpu_torch.cli.serve server petct.vdr

Every command runs on the card unless ``--device cpu`` asks for the plain
path; ``export-clf`` and ``info`` run no model. ``main`` runs one process
on one device (JAX's multi-process launch claim belongs to the
multi-device port, which does not exist yet).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_PRECISIONS = ["fast", "parity", "bf16", "fp32", "inference", "int8"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export / run serving artifacts (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(parser):
        parser.add_argument("--device", default="cuda",
                            help="cuda (default) or cpu")

    ex = sub.add_parser("export", help="write a dense model's .vdr file")
    ex.add_argument("-mn", "--model-name", default="medsam",
                    help="medsam or dinov2_vit{s,b,l,g}14")
    ex.add_argument("-mp", "--model-path", default=None,
                    help=".pth checkpoint (random weights if absent)")
    ex.add_argument("-o", "--out", required=True, help="output .vdr path")
    ex.add_argument("-b", "--batch", type=int, default=4,
                    help="static serving batch size (one artifact per "
                         "batch size)")
    ex.add_argument("--precision", default="fast", choices=_PRECISIONS)
    ex.add_argument("--image-size", type=int, default=None)
    ex.add_argument("--no-flash", action="store_true")
    ex.add_argument("--platforms", nargs="+", default=None,
                    help="device types the artifact may be loaded on "
                         "(cuda, cpu; default both)")
    ex.add_argument("--dinov2-mode", default="full",
                    choices=["patch_embed", "full"],
                    help="dinov2 backbones: patch-embed-only tokens "
                         "(reference parity) or full dense tokens")
    device(ex)

    exc = sub.add_parser(
        "export-clf",
        help="write a trained downstream classifier's .vdr file")
    exc.add_argument("checkpoint",
                     help="fold checkpoint (model_epoch_NNNN.pt)")
    exc.add_argument("-a", "--arch", default="transformer",
                     choices=["transformer", "conv"])
    exc.add_argument("-m", "--modality", default="ct",
                     help="ct/pet/chest/petct/petchest")
    exc.add_argument("-o", "--out", required=True, help="output .vdr path")
    exc.add_argument("-b", "--batch", type=_batch_size_or_poly, default="8",
                     help="static serving batch size, or 'poly' for a free "
                          "batch dimension (one artifact serves any batch, "
                          "no padding)")
    exc.add_argument("--max-tokens", type=int, default=512,
                     help="static token-axis length (transformer archs)")
    exc.add_argument("--conv-shape", type=int, nargs=3,
                     default=(13, 12, 12), metavar=("S", "H", "W"),
                     help="static volume shape (conv arch)")
    exc.add_argument("--num-classes", type=int, default=2)
    exc.add_argument("--platforms", nargs="+", default=None,
                     help="device types the artifact may be loaded on "
                          "(cuda, cpu; default both)")
    exc.add_argument("--precision", default="fast", choices=_PRECISIONS)

    exp = sub.add_parser(
        "export-pipeline",
        help="one artifact: images -> dense descriptors -> masked tokens "
             "-> classifier logits")
    exp.add_argument("checkpoint",
                     help="trained classifier fold checkpoint "
                          "(model_epoch_NNNN.pt)")
    exp.add_argument("-mn", "--model-name", default="medsam",
                     help="backbone: medsam or dinov2_vit{s,b,l,g}14 (the "
                          "whole transformer)")
    exp.add_argument("-mp", "--model-path", default=None,
                     help="backbone .pth (random weights if absent)")
    exp.add_argument("-a", "--arch", default="transformer",
                     choices=["transformer", "conv"])
    exp.add_argument("-m", "--modality", default="ct",
                     help="ct, pet, chest, or petct/petchest for the "
                          "bimodal cross-attention pipeline (two image "
                          "stacks in one artifact)")
    exp.add_argument("-o", "--out", required=True, help="output .vdr path")
    exp.add_argument("-b", "--batch", type=int, default=1,
                     help="patients per call (each a slices-deep volume)")
    exp.add_argument("--slices", type=int, default=13,
                     help="static slice count per volume (the trainer's "
                          "window: 13 CT / 2 PET); bimodal: the CT stack's")
    exp.add_argument("--pet-slices", type=int, default=2,
                     help="bimodal only: PET stack slice count")
    exp.add_argument("--max-tokens", type=int, default=512,
                     help="static masked-token budget (transformer arch)")
    exp.add_argument("--image-size", type=int, default=None)
    exp.add_argument("--precision", default="fast",
                     choices=["fast", "parity", "bf16", "fp32",
                              "inference"])
    exp.add_argument("--no-flash", action="store_true")
    exp.add_argument("--num-classes", type=int, default=2)
    exp.add_argument("--platforms", nargs="+", default=None)
    exp.add_argument("--input-mode", default="rgb",
                     choices=["rgb", "raw-hu"],
                     help="rgb: pre-resized (B,S,size,size,3) f32 inputs. "
                          "raw-hu: native-resolution scanner output (int16 "
                          "HU for CT, f32 for PET), normalised and resized "
                          "on the device")
    exp.add_argument("--native-size", type=int, default=512,
                     help="raw-hu input resolution (512 for CT)")
    exp.add_argument("--pet-native-size", type=int, default=None,
                     help="bimodal raw-hu: PET native resolution "
                          "(default: --native-size)")
    device(exp)

    info = sub.add_parser("info", help="print a .vdr artifact's header")
    info.add_argument("artifact")

    run = sub.add_parser("run", help="batched inference from an artifact")
    run.add_argument("artifact")
    run.add_argument("-i", "--input", required=True,
                     help="dense artifact: .npy/.npz of (N, H, W, 3) "
                          "float32 images (for .npz pass --key). "
                          "classifier/pipeline artifact: .npz with one "
                          "array per in_spec entry (masks may be omitted: "
                          "all-valid assumed)")
    run.add_argument("--key", default=None,
                     help="array name inside an .npz input")
    run.add_argument("--overlap", action="store_true",
                     help="copy batch j+1 to the card from pinned memory "
                          "on a side stream while batch j computes "
                          "(throughput mode)")
    run.add_argument("--poly-chunk", type=int, default=1024,
                     help="poly-batch artifacts: items per call (0 = the "
                          "whole input in one call)")
    run.add_argument("--labels", default=None,
                     help="classifier artifacts: optional .npy of (N,) "
                          "{0,1} labels; adds AUC/accuracy/F1")
    run.add_argument("-o", "--output", required=True,
                     help="dense: output .npy of features; classifier: "
                          "output .npz with one array per out_name")
    device(run)

    srv = sub.add_parser(
        "server",
        help="HTTP inference endpoint around a .vdr artifact: POST /infer "
             "with an .npz body -> .npz response; GET /health")
    srv.add_argument("artifact")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8400)
    srv.add_argument("--max-body-mb", type=int, default=512)
    srv.add_argument("--poly-chunk", type=int, default=1024)
    device(srv)
    return p


def _platforms(args):
    return tuple(args.platforms) if args.platforms else None


def _extractor(args, dinov2_mode: str):
    """The backbone by reference model name, as extraction builds it
    (name → config, ``.pth`` conversion, seeded random weights)."""
    from ..engine.extract import DenseExtractor, ExtractionConfig

    return DenseExtractor(ExtractionConfig(
        model_name=args.model_name, model_path=args.model_path,
        image_size=args.image_size, precision=args.precision,
        use_flash=not args.no_flash, dinov2_mode=dinov2_mode),
        device=args.device)


def _export(args) -> int:
    from ..engine.serve import export_dense_model

    if args.precision == "int8":
        # the guard against an int8 path slower than bf16 (cli/extract.py)
        from ..ops.quant import warn_if_int8_emulated

        ratio = warn_if_int8_emulated(device=args.device)
        print(f"int8/bf16 measured matmul rate ratio: {ratio:.2f}")
    ext = _extractor(args, args.dinov2_mode)
    path = export_dense_model(
        ext.model.state_dict(), ext.backbone_cfg, args.out,
        batch=args.batch, policy=args.precision,
        use_flash=not args.no_flash,
        patch_embed_only=ext.model.patch_embed_only,
        platforms=_platforms(args))
    print(path)
    return 0


def _load_checkpoint(path: str) -> dict:
    """The classifier weights of a fold checkpoint (``engine/
    checkpoint.py``'s ``{"params": state_dict, …}``) or a bare state
    dict."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["params"] if "params" in state else state


def _export_clf(args) -> int:
    from ..engine.serve import export_classifier
    from ..utils import config

    path = export_classifier(
        _load_checkpoint(args.checkpoint), config.load_conf(), args.arch,
        args.modality, args.out, batch=args.batch,
        max_tokens=args.max_tokens, conv_shape=tuple(args.conv_shape),
        policy=args.precision, num_classes=args.num_classes,
        platforms=_platforms(args))
    print(path)
    return 0


def _export_pipeline(args) -> int:
    from ..engine.serve import export_pipeline
    from ..utils import config

    # the pipeline runs the whole backbone, so a DINOv2 name takes its
    # `full` mode
    ext = _extractor(args, "full")
    path = export_pipeline(
        ext.model.state_dict(), ext.backbone_cfg,
        _load_checkpoint(args.checkpoint), config.load_conf(), args.arch,
        args.modality, args.out, slices=args.slices,
        max_tokens=args.max_tokens, batch=args.batch,
        policy=args.precision, use_flash=not args.no_flash,
        num_classes=args.num_classes, platforms=_platforms(args),
        input_mode=args.input_mode.replace("-", "_"),
        native_size=args.native_size, pet_slices=args.pet_slices,
        pet_native_size=args.pet_native_size)
    print(path)
    return 0


def _info(args) -> int:
    from ..engine.serve import read_header

    print(json.dumps(read_header(args.artifact), indent=2))
    return 0


def _batch_size_or_poly(text: str):
    """argparse type for --batch: a positive int, or the literal 'poly'."""
    if text == "poly":
        return text
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a positive integer or 'poly', got {text!r}")
    if value < 1:
        raise argparse.ArgumentTypeError(
            f"batch size must be >= 1, got {value}")
    return value


def _load_images(path: str, key: str | None):
    import numpy as np

    if path.endswith(".npz"):
        with np.load(path) as z:
            names = list(z.files)
            if key is None:
                if len(names) != 1:
                    raise SystemExit(
                        f"{path} holds {names}; pick one with --key")
                key = names[0]
            return np.asarray(z[key], dtype=np.float32)
    return np.asarray(np.load(path), dtype=np.float32)


def _host(t):
    """A call's output on the host (the copy waits for the card)."""
    return t.detach().cpu().numpy()


def _named_inputs(model, given: dict) -> tuple[list, int]:
    """A classifier or pipeline request's host arrays in ``in_spec``
    order, and its item count.

    Arrays must match the artifact's ``in_spec`` names; omitted masks
    default to all-valid. Shorter token/volume axes than the static spec
    are zero-padded with the mask cleared over the padding.
    """
    import numpy as np

    in_spec = model.meta["in_spec"]
    unknown = set(given) - set(in_spec)
    if unknown:
        raise SystemExit(f"unknown input arrays {sorted(unknown)}; "
                         f"this artifact takes {list(in_spec)}")

    # batch size from the first provided data array
    data_names = [k for k in in_spec if not k.endswith("mask")]
    try:
        n = next(given[k].shape[0] for k in data_names if k in given)
    except StopIteration:
        raise SystemExit(f"missing data arrays; need {data_names}")

    inputs = []
    for name, (shape, dtype) in in_spec.items():
        is_mask = name.endswith("mask")
        if name in given:
            arr = given[name]
        elif is_mask:
            # valid over the matching data array's provided extent, False
            # over the padding added below (mask dims mirror the data
            # array's non-feature dims)
            data_name = name.replace("mask", "tokens").replace(
                "valid_tokens", "volume")
            arr = np.zeros((n,) + tuple(shape[1:]), bool)
            if data_name in given:
                ext = given[data_name].shape[:arr.ndim]
                arr[tuple(slice(0, e) for e in ext)] = True
            else:
                arr[:] = True
        else:
            raise SystemExit(f"missing required input '{name}'")
        if arr.shape[0] != n:
            raise SystemExit(
                f"'{name}' batch {arr.shape[0]} != {n} of the data arrays")
        if arr.ndim != len(shape):
            raise SystemExit(
                f"'{name}' must have {len(shape)} dims {shape}; "
                f"got {list(arr.shape)}")
        # zero-pad the non-batch axes up to the static spec, except the
        # feature axis of data arrays, which must match exactly
        if not is_mask and arr.shape[-1] != shape[-1]:
            raise SystemExit(
                f"'{name}' feature dim {arr.shape[-1]} != the artifact's "
                f"{shape[-1]}")
        pads = [(0, 0)]
        for have, want_ in zip(arr.shape[1:], shape[1:]):
            if have > want_:
                raise SystemExit(
                    f"'{name}' axis size {have} exceeds the artifact's "
                    f"static {want_}")
            pads.append((0, want_ - have))
        if any(p != (0, 0) for p in pads):
            arr = np.pad(arr, pads)
        inputs.append(
            arr.astype(bool if dtype == "bool" else np.dtype(dtype),
                       copy=False))

    if n == 0:
        raise SystemExit("input holds 0 items; nothing to run")
    return inputs, n


def _infer_named(model, given: dict, *, poly_chunk: int | None = None,
                 overlap: bool = False):
    """Classifier or pipeline inference over named host arrays
    (:func:`_named_inputs`). The batch axis pads to the static serving
    batch; a ``"poly"`` artifact takes ``poly_chunk`` items a call.
    ``overlap`` copies the next batch to the card from pinned memory on a
    side stream while the current one computes; the call waits on an
    event before it reads the copy.

    Returns (outputs by ``out_names`` on the host, the batch, per-batch
    latencies, seconds).
    """
    import numpy as np
    import torch

    inputs, n = _named_inputs(model, given)
    batch = model.meta["batch"]
    poly = batch == "poly"
    if poly:
        # a free batch axis: poly_chunk items per call, no padding
        batch = min(n, max(1, poly_chunk or n))
    else:
        batch = int(batch)
    pad = 0 if poly else (-n) % batch
    side = torch.cuda.Stream(model.device) \
        if overlap and model.device.type == "cuda" else None

    def _chunk(i):
        """Batch i's arrays, or with overlap on the card its tensors in
        flight on the side stream and the event that marks them there."""
        chunk = []
        for arr in inputs:
            part = arr[i:i + batch]
            if part.shape[0] < batch and not poly:
                part = np.pad(
                    part, [(0, batch - part.shape[0])]
                    + [(0, 0)] * (part.ndim - 1))
            chunk.append(part)
        if side is None:
            return chunk, None
        with torch.cuda.stream(side):
            chunk = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     .to(model.device, non_blocking=True) for a in chunk]
        copied = torch.cuda.Event()
        copied.record(side)
        return chunk, copied

    def _ready(chunk, copied):
        if copied is not None:
            stream = torch.cuda.current_stream(model.device)
            stream.wait_event(copied)
            for t in chunk:          # allocated on the side stream
                t.record_stream(stream)
        return chunk

    starts = list(range(0, n + pad, batch))
    outs = None
    lat = []
    t0 = time.time()
    cur = _chunk(starts[0])
    for j in range(len(starts)):
        tb = time.time()
        got = model(*_ready(*cur))
        got = got if isinstance(got, (tuple, list)) else (got,)
        # the next batch's copy rides under this batch's compute
        cur = _chunk(starts[j + 1]) if j + 1 < len(starts) else None
        got = [_host(g) for g in got]
        lat.append(time.time() - tb)
        if outs is None:
            outs = [[] for _ in got]
        for acc, g in zip(outs, got):
            acc.append(g)
    dt = time.time() - t0
    named = {name: np.concatenate(acc)[:n]
             for name, acc in zip(model.meta["out_names"], outs)}
    return named, batch, lat, dt


def _run_classifier(args, model) -> int:
    """``serve run`` for classifier and pipeline artifacts: an .npz of
    named inputs through :func:`_infer_named`, the outputs to an .npz."""
    import numpy as np

    if not args.input.endswith(".npz"):
        raise SystemExit(
            "classifier artifacts take an .npz input with one array per "
            f"in_spec entry {list(model.meta['in_spec'])}")
    with np.load(args.input) as z:
        given = {k: np.asarray(z[k]) for k in z.files}
    named, batch, lat, dt = _infer_named(
        model, given, poly_chunk=args.poly_chunk, overlap=args.overlap)
    n = len(next(iter(named.values())))
    np.savez(args.output, **named)
    from ..utils.profiling import memory_summary_gib

    extra = memory_summary_gib(model.device)
    if args.labels:
        extra["eval"] = _eval_logits(named, np.load(args.labels), n)
    print(json.dumps({
        "items": n, "batch": batch, "seconds": round(dt, 3),
        "items_per_s": round(n / dt, 2) if dt > 0 else None,
        **({"overlap": True} if args.overlap else {}),
        **_latency_stats(lat),
        **getattr(args, "_warm_stats", {}),
        "outputs": {k: list(v.shape) for k, v in named.items()},
        "output": args.output,
        **extra,
    }))
    return 0


def _eval_logits(named: dict, labels, n: int) -> dict:
    """AUC/accuracy/macro-F1 of each logits output against (N,) {0,1}
    labels, by ``ops/metrics.py`` (the trainer's per-epoch math)."""
    import numpy as np
    import torch

    from ..ops.metrics import binary_report_metrics, roc_auc

    labels = np.asarray(labels)
    if labels.ndim != 1:
        raise SystemExit(
            "--labels must be a flat (N,) array of 0/1 labels; got "
            f"shape {list(labels.shape)} (one-hot arrays: argmax first)")
    if labels.shape[0] != n:
        raise SystemExit(
            f"--labels has {labels.shape[0]} entries for {n} inputs")
    y = torch.from_numpy(labels.astype(np.float32))
    out = {}
    for name, lg in named.items():
        if not name.startswith("logits") or lg.ndim != 2:
            continue
        if lg.shape[1] != 2:
            raise SystemExit(
                "--labels evaluation supports binary heads only; output "
                f"'{name}' has {lg.shape[1]} classes")
        lg = lg - lg.max(axis=-1, keepdims=True)
        e = np.exp(lg)
        score = (e / e.sum(axis=-1, keepdims=True))[:, 1]
        pred = (score >= 0.5).astype(np.float32)
        rep = binary_report_metrics(y, torch.from_numpy(pred))
        out[name] = {
            "auc": float(roc_auc(y, torch.from_numpy(score))),
            "accuracy": float(rep["accuracy"]),
            "macro_f1": float(rep["macro_f1"]),
        }
    return out


def _latency_stats(lat: list) -> dict:
    """Per-batch wall latencies → p50/p90/p99 (ms). The first batch is
    reported apart."""
    if not lat:
        return {}
    import numpy as np

    steady = lat[1:] or lat
    return {
        "first_batch_ms": round(lat[0] * 1e3, 2),
        "latency_p50_ms": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "latency_p90_ms": round(float(np.percentile(steady, 90)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(steady, 99)) * 1e3, 2),
    }


def _load_warm(args):
    """The artifact on the requested device, warmed; (model, its warm
    report)."""
    from ..engine.serve import load_exported

    model = load_exported(args.artifact, device=args.device)
    t0 = time.time()
    model.warm()
    return model, {"warm_s": round(time.time() - t0, 2),
                   "exec_cache": model.cache_status, **model.warm_stats}


def _infer_dense(model, images):
    """A dense artifact over (N, size, size, 3) float32 host images, the
    last batch zero-padded; (features on the host, per-batch latencies,
    seconds)."""
    import numpy as np

    batch = int(model.meta["batch"])
    size = int(model.meta["image_size"])
    if images.ndim != 4 or images.shape[1:] != (size, size, 3):
        raise SystemExit(
            f"input must be (N, {size}, {size}, 3) float32 for this "
            f"artifact; got {images.shape}")
    n = images.shape[0]
    if n == 0:
        raise SystemExit("input holds 0 images; nothing to run")
    pad = (-n) % batch
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    t0 = time.time()
    outs = []
    lat = []
    for i in range(0, images.shape[0], batch):
        tb = time.time()
        outs.append(_host(model(images[i:i + batch])))
        lat.append(time.time() - tb)
    return np.concatenate(outs)[:n], lat, time.time() - t0


def _run(args) -> int:
    import numpy as np

    model, warm_stats = _load_warm(args)
    print(json.dumps(warm_stats), file=sys.stderr)
    args._warm_stats = warm_stats
    if model.meta.get("kind") in ("classifier", "pipeline"):
        # both are named-in_spec artifacts: one padding/latency/eval path
        return _run_classifier(args, model)
    if getattr(args, "labels", None):
        raise SystemExit(
            "--labels applies to classifier artifacts; this artifact "
            "serves dense feature maps (no logits to evaluate)")
    feats, lat, dt = _infer_dense(model,
                                  _load_images(args.input, args.key))
    n, batch = feats.shape[0], int(model.meta["batch"])
    np.save(args.output, feats)
    print(json.dumps({
        "images": n, "batch": batch, "seconds": round(dt, 3),
        "img_per_s": round(n / dt, 2) if dt > 0 else None,
        **_latency_stats(lat),
        **getattr(args, "_warm_stats", {}),
        "out_shape": list(feats.shape), "output": args.output,
    }))
    return 0


def make_server(model, *, poly_chunk: int = 1024,
                max_body_mb: int = 512):
    """HTTP request handler class around a warm ``ExportedModel``.

    * ``GET /health`` → JSON: artifact meta and the warm status.
    * ``POST /infer`` with an ``.npz`` body → ``.npz`` response. Dense
      artifacts take one array (any name) of (N, size, size, 3) images and
      answer ``{"features": ...}``; classifier/pipeline artifacts take one
      array per ``in_spec`` name (masks optional) with ``serve run``'s
      padding (:func:`_infer_named`).

    Inference is serialised with a lock (one device). Each request runs on
    its own server thread; the model enters ``torch.inference_mode()`` in
    every call, so no thread builds an autograd graph.
    """
    import io
    import threading
    from http.server import BaseHTTPRequestHandler

    import numpy as np

    lock = threading.Lock()
    kind = model.meta.get("kind", "dense")

    def infer_npz(body: bytes) -> bytes:
        with np.load(io.BytesIO(body)) as z:
            given = {k: np.asarray(z[k]) for k in z.files}
        buf = io.BytesIO()
        if kind == "dense":
            if len(given) != 1:
                raise ValueError(
                    "dense artifacts take exactly one image array")
            images = np.asarray(next(iter(given.values())), np.float32)
            np.savez(buf, features=_infer_dense(model, images)[0])
        else:
            np.savez(buf, **_infer_named(model, given,
                                         poly_chunk=poly_chunk)[0])
        return buf.getvalue()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *fa):  # stderr, not stdout
            print("# " + fmt % fa, file=sys.stderr)

        def _reply(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, message: str):
            self._reply(code, json.dumps({"error": message}).encode(),
                        "application/json")

        def do_GET(self):
            if self.path != "/health":
                self._error(404, "unknown path")
                return
            self._reply(200, json.dumps({
                "status": "ok", "kind": kind,
                "exec_cache": model.cache_status,
                "device": str(model.device),
                "meta": {k: v for k, v in model.meta.items()
                         if k != "in_spec"},
                "in_spec": model.meta.get("in_spec"),
            }).encode(), "application/json")

        def do_POST(self):
            if self.path != "/infer":
                self._error(404, "unknown path")
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body_mb << 20:
                self._error(413, f"body over {max_body_mb} MiB")
                return
            body = self.rfile.read(length)
            try:
                with lock:
                    out = infer_npz(body)
            except SystemExit as exc:      # the CLI's validation paths
                self._error(400, str(exc))
                return
            except Exception as exc:  # noqa: BLE001 — surfaced to the caller
                self._error(400, repr(exc)[:500])
                return
            self._reply(200, out, "application/octet-stream")

    return Handler


def _server(args) -> int:
    from http.server import ThreadingHTTPServer

    model, warm_stats = _load_warm(args)
    print(json.dumps({"serving": args.artifact, "host": args.host,
                      "port": args.port, **warm_stats}), flush=True)
    handler = make_server(model, poly_chunk=args.poly_chunk,
                          max_body_mb=args.max_body_mb)
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    """One process on one device: the subcommand's function."""
    args = build_parser().parse_args(argv)
    return {"export": _export, "export-clf": _export_clf,
            "export-pipeline": _export_pipeline, "info": _info,
            "run": _run, "server": _server}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

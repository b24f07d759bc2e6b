"""The port stands alone: no JAX, no import of the JAX package (in the
package and in ``chip_smoke.py``), GPU by default, and the policies it
does not run yet refuse loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vit_deep_radiomics_tpu_torch as port
from vit_deep_radiomics_tpu_torch.core import precision

PKG = Path(port.__file__).resolve().parent
MODULES = sorted(
    "vit_deep_radiomics_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_deep_radiomics_tpu")


def test_new_modules_are_covered():
    """The modules of the int8, fused-MLP and generic-attention paths, the
    tfds source, the classifier-training path (the fold-parallel trainer
    too) and the k-fold aggregation are among those the isolation checks
    import and parse."""
    for mod in ("ops.quant", "ops.mlp_fused", "ops.attention",
                "ops._kernels", "core.precision", "utils.cuda_build",
                "data.ingest", "ops.posenc", "ops.metrics",
                "models.classifiers", "models.losses", "models.convert",
                "utils.config", "utils.native", "data.datasets",
                "data.splits", "data.feature_store", "engine.checkpoint",
                "engine.train", "engine.evaluate", "analysis.reports",
                "cli.train", "cli.evaluate", "cli.merge", "cli.split",
                "cli.sweep", "cli.convert", "engine.serve", "cli.serve",
                "ops.preprocess", "utils.profiling", "engine.foldpar",
                "analysis.aggregate", "cli.aggregate"):
        assert f"vit_deep_radiomics_tpu_torch.{mod}" in MODULES


def test_chip_smoke_imports_no_jax():
    """The card's script imports neither JAX nor the JAX package."""
    tree = ast.parse((PKG.parent / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN[:3], name
            assert name.split(".")[0] != "vit_deep_radiomics_tpu", name


def test_serving_imports_without_host_libraries():
    """The card's machine has no pandas, h5py, sklearn or yaml: the
    serving modules (and the CLI's parser) import without them."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'h5py', 'sklearn', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "from vit_deep_radiomics_tpu_torch.engine import serve\n"
        "from vit_deep_radiomics_tpu_torch.cli import serve as cli\n"
        "assert serve.load_exported and cli.make_server\n"
        "cli.build_parser().parse_args(['info', 'x.vdr'])\n")
    root = str(PKG.parent)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]


def test_every_kernel_source_has_one_launch_counter():
    """Each ops module registers the counters of its own kernels in the
    shared table: once the model is imported, the table names exactly the
    sources ``build_all()`` builds, and beside them the bf16 builds of
    K6's three sources, which count apart from their fp32 builds, and the
    Hopper bodies of K6's bf16 backward, which count apart from its
    mma.sync bodies."""
    from vit_deep_radiomics_tpu_torch.models import vit  # noqa: F401
    from vit_deep_radiomics_tpu_torch.ops import _kernels, attention
    from vit_deep_radiomics_tpu_torch.utils import cuda_build

    k6_bf16 = [f"flash_attention_{k}_bf16"
               for k in ("fwd", "bwd_dq", "bwd_dkv")]
    k6_hopper = [f"flash_attention_{k}_hopper" for k in ("bwd_dq", "bwd_dkv")]
    assert attention.LAUNCHES is _kernels.LAUNCHES
    assert sorted(_kernels.LAUNCHES) == sorted(
        [*cuda_build.KERNEL_SOURCES, *k6_bf16, *k6_hopper])


def test_importing_every_module_leaves_jax_out():
    """In a fresh interpreter (tests/conftest.py imports jax into this
    one): import every port module, then check sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    root = str(PKG.parent)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


class TestDevice:
    def test_no_gpu_raises_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.default_device()
        with pytest.raises(RuntimeError):
            port.default_device("cuda")
        assert port.default_device("cpu") == torch.device("cpu")

    def test_dense_extractor_default_raises_without_gpu(self, monkeypatch):
        from vit_deep_radiomics_tpu_torch.engine.extract import (
            DenseExtractor,
        )

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DenseExtractor()

    def test_cuda_wrapper_raises_instead_of_falling_back(self):
        """A non-CPU tensor never takes the plain path: the wrapper checks
        and launches or raises (here: a dtype the kernels do not take)."""
        from vit_deep_radiomics_tpu_torch.ops import attention

        q = torch.zeros(1, 16, 128, dtype=torch.float16, device="meta")
        kv = torch.zeros(1, 16, 256, dtype=torch.float16, device="meta")
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            attention.fused_window_attention(
                q, kv, num_heads=2, window_tokens=16, scale=0.125)
        assert attention.LAUNCHES["fused_window_attention"] == 0


class TestPolicy:
    def test_parity_turns_tf32_off(self, monkeypatch):
        """Off inside the policy's scope, restored after it; ``fast``
        leaves the flags alone."""
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        with precision.get_policy("parity").backends():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with precision.get_policy("fast").backends():
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32

    @pytest.mark.parametrize("name", ["inference", "int8"])
    def test_not_ported_policies_raise(self, name):
        """The two policies that raised before K7/K8 were ported now
        resolve to JAX's definitions (bf16 parameters; ``int8``
        quantized); a name JAX does not know still raises."""
        policy = precision.get_policy(name)
        assert policy.param_dtype == policy.compute_dtype == torch.bfloat16
        assert policy.quantized == (name == "int8")
        with pytest.raises(ValueError, match="unknown"):
            precision.get_policy(name + "4")

    def test_dtypes(self):
        assert precision.get_policy("fast").compute_dtype == torch.bfloat16
        assert precision.get_policy("fp32") is precision.PARITY
        with pytest.raises(ValueError, match="unknown"):
            precision.get_policy("fp8")


class TestCli:
    def test_parser_defaults(self):
        from vit_deep_radiomics_tpu_torch.cli.extract import build_parser

        args = build_parser().parse_args(["-h5", "a", "-df", "b"])
        assert (args.device, args.precision, args.model_name,
                args.source) == ("cuda", "fast", "medsam", "isotropic")

    def test_tfds_source_raises(self, monkeypatch):
        """The tfds source is ported; without tensorflow_datasets it
        raises, naming the package."""
        from vit_deep_radiomics_tpu_torch.cli.extract import main
        from vit_deep_radiomics_tpu_torch.data import ingest

        monkeypatch.setattr(ingest, "HAS_TFDS", False)
        with pytest.raises(ImportError, match="tensorflow_datasets"):
            main(["--source", "tfds", "-mn", "dinov2_vits14",
                  "--image-size", "28", "--device", "cpu"])

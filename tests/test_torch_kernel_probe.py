"""The kernel probe's source variants are built from the committed kernels:
each named constant and each call it removes is found exactly once. The
build's ptxas spill report (``cuda_build.spill_bytes``) is read from a
sample log. Each ``pair`` child is whole Python source."""

import re

import pytest

from vit_deep_radiomics_tpu_torch.utils import cuda_build, kernel_probe

CASES = [(k, name) for k in sorted(kernel_probe.VARIANTS)
         for name in sorted(kernel_probe.VARIANTS[k])]


def _source(kernel):
    return (cuda_build.CSRC_DIR / kernel_probe.SOURCES[kernel]).read_text()


@pytest.mark.parametrize("kernel,name", CASES)
def test_variant_source_changes_what_it_names(kernel, name):
    """Each constant is replaced in the kernel's source, or where the
    source does not define it in the one header that does (K6's bf16
    backward keeps its constants in flash_trainable_hopper.cuh), and each
    removal is made in the one file (the source or a header it may change)
    that holds it once; the other files stay as they are."""
    files = kernel_probe.variant_files(kernel, name)
    src = kernel_probe.SOURCES[kernel]
    originals = {f: (cuda_build.CSRC_DIR / f).read_text() for f in files}
    assert set(files) == {src, *kernel_probe.HEADERS.get(kernel, ())}
    consts, removed = kernel_probe.VARIANTS[kernel][name]
    changed = set()
    for const, value in consts.items():
        defines = [f for f, text in originals.items()
                   if f"constexpr int {const} = " in text]
        where = src if src in defines else defines[0]
        assert src in defines or len(defines) == 1, (const, defines)
        assert f"constexpr int {const} = {value};" in files[where]
        changed.add(where)
    for call in removed:
        call, repl = call if isinstance(call, tuple) else (call, ";")
        hits = [f for f, text in originals.items() if call in text]
        assert len(hits) == 1 and originals[hits[0]].count(call) == 1
        assert call not in files[hits[0]] and repl in files[hits[0]]
        changed.add(hits[0])
    for f in set(files) - changed:
        assert files[f] == originals[f]


def test_variant_source_refuses_an_unknown_constant():
    with pytest.raises(ValueError, match="kNoSuch"):
        kernel_probe.variant_source(_source("k2"), {"kNoSuch": 1})


def test_spill_bytes_sums_every_kernel_of_a_ptxas_log():
    log = ("ptxas info    : Function properties for _Z3fooPf\n"
           "    80 bytes stack frame, 76 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers\n"
           "ptxas info    : Function properties for _Z3barPf\n"
           "    0 bytes stack frame, 0 bytes spill stores, 4 bytes spill "
           "loads\n")
    assert cuda_build.spill_bytes(log) == 92
    assert cuda_build.spill_bytes("ptxas info    : Used 40 registers") == 0


def test_ptxas_functions_reads_each_kernel():
    """Registers and spill bytes per kernel, so that a check can hold one
    body of a source (its tiled kernels) to no spill."""
    log = ("ptxas info    : Compiling entry function '_Z9k2_tiledv' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z9k2_tiledv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 126 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z6hopperv' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z6hopperv\n"
           "    8 bytes stack frame, 56 bytes spill stores, 56 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers\n")
    assert cuda_build.ptxas_functions(log) == {
        "_Z9k2_tiledv": {"registers": 126, "spill": 0},
        "_Z6hopperv": {"registers": 168, "spill": 112}}
    assert cuda_build.spill_bytes(log) == 112


@pytest.mark.parametrize("path", sorted(kernel_probe._CHILDREN))
def test_pair_child_is_whole_python(path):
    """Each ``pair --path`` child is complete Python source (every
    placeholder of a templated child filled in), so a chip call does not
    fail on it after the parent's turn."""
    child = kernel_probe._CHILDREN[path]
    assert not re.search(r"@[A-Z_]+@", child), path
    compile(child, f"<pair {path}>", "exec")


def test_sass_functions_splits_a_listing_by_kernel(monkeypatch, tmp_path):
    """``sass`` compares kernels one by one: each ``Function :`` block of a
    ``cuobjdump -sass`` listing up to the row of dots that ends it, so
    what follows a kernel (the next ELF section's header) is not part of
    it."""
    listing = """
	code for sm_90a
		Function : _Z3twoPf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
		..........

		Function : _Z3onePf
        /*0000*/                   EXIT ;
		..........
Fatbin elf code:
identifier = a.cu
"""

    class Done:
        stdout = listing

    monkeypatch.setattr(kernel_probe.subprocess, "run",
                        lambda *a, **k: Done())
    funcs = kernel_probe._sass_functions(tmp_path / "x.so")
    assert sorted(funcs) == ["_Z3onePf", "_Z3twoPf"]
    assert funcs["_Z3onePf"] == "/*0000*/                   EXIT ;"
    assert funcs["_Z3twoPf"].count("\n") == 2 and "EXIT" in funcs["_Z3twoPf"]

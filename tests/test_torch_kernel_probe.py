"""The kernel probe's source variants are built from the committed kernels:
each named constant and each call it removes is found exactly once. The
build's ptxas spill report (``cuda_build.spill_bytes``) is read from a
sample log."""

import pytest

from vit_deep_radiomics_tpu_torch.utils import cuda_build, kernel_probe

CASES = [(k, name) for k in sorted(kernel_probe.VARIANTS)
         for name in sorted(kernel_probe.VARIANTS[k])]


def _source(kernel):
    return (cuda_build.CSRC_DIR / kernel_probe.SOURCES[kernel]).read_text()


@pytest.mark.parametrize("kernel,name", CASES)
def test_variant_source_changes_what_it_names(kernel, name):
    source = _source(kernel)
    consts, removed = kernel_probe.VARIANTS[kernel][name]
    text = kernel_probe.variant_source(source, consts, removed)
    for const, value in consts.items():
        assert f"constexpr int {const} = {value};" in text
    for call in removed:
        call, repl = call if isinstance(call, tuple) else (call, ";")
        assert source.count(call) == 1 and call not in text and repl in text
    if not consts and not removed:
        assert text == source


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

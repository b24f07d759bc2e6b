"""The K2 probe's source variants are built from the committed kernel: each
named constant and each call it removes is found exactly once."""

import pytest

from vit_deep_radiomics_tpu_torch.utils import cuda_build, k2_probe

SOURCE = (cuda_build.CSRC_DIR / "fused_global_attention.cu").read_text()


@pytest.mark.parametrize("name", sorted(k2_probe.VARIANTS))
def test_variant_source_changes_what_it_names(name):
    consts, removed = k2_probe.VARIANTS[name]
    text = k2_probe.variant_source(SOURCE, consts, removed)
    for const, value in consts.items():
        assert f"constexpr int {const} = {value};" in text
    for call in removed:
        assert call in SOURCE and call not in text
    if not consts and not removed:
        assert text == SOURCE


def test_variant_source_refuses_an_unknown_constant():
    with pytest.raises(ValueError, match="kNoSuch"):
        k2_probe.variant_source(SOURCE, {"kNoSuch": 1})

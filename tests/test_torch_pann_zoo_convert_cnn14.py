"""``convert_pann`` for every Cnn14 variant (frontends, embedding widths,
training-time variants, the decision-level max/avg heads) and
``build_pann_model`` for the decision-level heads, against conette_tpu's,
as ``test_torch_pann_zoo_convert.py`` holds the zoo's architectures."""

import pytest

from test_torch_pann_zoo_convert import GENERATORS, check_conversion, check_structure

HEADS = ["cnn14_decisionlevelavg", "cnn14_decisionlevelmax"]


@pytest.mark.parametrize("name", HEADS)
def test_build_pann_model_gives_jax_s_structure(name):
    check_structure(name)


@pytest.mark.parametrize("arch", sorted(n for n in GENERATORS if n.startswith("cnn14")))
def test_convert_pann_matches_jax(arch):
    check_conversion(arch)

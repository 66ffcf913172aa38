"""``build_pann_model``, ``convert_pann`` and ``load_registry_pann`` for
the zoo's waveform models (Wavegram_Cnn14, Wavegram_Logmel_Cnn14 and its
128-mel variant, LeeNet11/24, DaiNet19, Res1dNet31/51) against
conette_tpu's, as ``test_torch_pann_zoo_convert.py`` holds the others."""

import pytest

from test_torch_pann_zoo_convert import check_conversion, check_registry, check_structure

ARCHS = ["dainet19", "leenet11", "leenet24", "res1dnet31", "res1dnet51", "wavegram_cnn14",
         "wavegram_logmel128_cnn14", "wavegram_logmel_cnn14"]


@pytest.mark.parametrize("name", ARCHS)
def test_build_pann_model_gives_jax_s_structure(name):
    check_structure(name)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_pann_matches_jax(arch):
    check_conversion(arch)


@pytest.mark.parametrize("name", ["Wavegram_Cnn14", "Wavegram_Logmel_Cnn14"])
def test_load_registry_pann_loads_the_zoo_entries(tmp_path, monkeypatch, name):
    check_registry(name, tmp_path, monkeypatch)

"""The tests of tests/test_torch_zoo_models.py on GELAN-T (`cfg.dicts.GELAN_T`), as a file of its own."""

from tests.test_torch_zoo_models import (  # noqa: F401  (fixtures and tests, collected here for MODEL)
    _one_torch_thread,
    name,
    pair,
    test_forward_matches_jax,
    test_init_matches_jax,
    test_int8_refused_as_the_jax_package_fails,
    test_npz_round_trips,
    test_predict_bf16_detect_maps_match_jax,
    test_predict_matches_jax,
    test_pt_loads_match_jax_mapping,
    test_val_matches_jax,
)

MODEL = "gelan-t"

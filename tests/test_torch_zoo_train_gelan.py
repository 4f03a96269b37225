"""The tests of tests/test_torch_zoo_train.py on GELAN-T (`cfg.dicts.GELAN_T`), as a file of its own."""

from tests.test_torch_zoo_train import (  # noqa: F401  (fixtures and tests, collected here for MODEL)
    _one_torch_thread,
    dataset,
    step_pair,
    test_jax_resumes_a_port_checkpoint,
    test_port_resumes_a_jax_checkpoint,
    test_train_step_matches_jax,
)

MODEL = "gelan-t"

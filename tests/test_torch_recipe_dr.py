"""The README recipe's tests (tests/test_torch_recipe.py) on the two shipped
experiments with domain randomization on: `BlindGraspingDR` and
`BoxStackingDR`, whose DR merge and fused DR rows hold values other than
ones."""

import pytest

from tests.test_torch_recipe import (  # noqa: F401  (collected here, on this file's cases)
    build_case,
    test_dr_merge_matches_jax,
    test_experiment_shape,
    test_fused_layout_matches_jax,
    test_plain_fused_step_equals_unfused_step,
    test_reset_obs_matches_jax,
    test_step_fn_matches_jax,
)


@pytest.fixture(scope="module", params=("BlindGraspingDR", "BoxStackingDR"))
def case(request):
    return build_case(request.param)

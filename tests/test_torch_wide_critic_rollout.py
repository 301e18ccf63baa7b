"""A rollout (E = 2, T = 4) of dandelion at ``hidden_dim=1024`` on the CPU
against the JAX trainer's, on
the default critic path (the tail kernels on the card): the checks and
tolerances of ``tests/torch_wide_trainer.py`` (the update is in
``test_torch_wide_critic_update.py``; the files are apart so that
the test workers take them side by side).
"""

import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_wide_trainer import FIELDS, check_rollout_field, pair, rollouts


@pytest.fixture(scope="module")
def both():
    return rollouts(*pair(fused=False))


@pytest.mark.parametrize("field,atol", FIELDS)
def test_rollout_at_hidden_1024_matches_jax(both, field, atol):
    check_rollout_field(both, field, atol)

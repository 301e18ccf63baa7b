"""One minibatch update of dandelion at ``hidden_dim=1024`` on the CPU
against the JAX trainer, on
the default critic path (the tail kernels on the card): the checks and
tolerances of ``tests/torch_wide_trainer.py`` (the rollout is in
``test_torch_wide_critic_rollout.py``).
"""

from torch_threads import one_torch_thread  # noqa: F401
from torch_wide_trainer import check_minibatch_update, pair


def test_minibatch_update_at_hidden_1024_matches_jax():
    check_minibatch_update(*pair(fused=False))

"""The plain versions of the fused attention's wide route (K5f and K5b at
widths the tuned kernels refuse) against the JAX package's Pallas
``fused_cf_attention`` in interpret mode, on the CPU, at B = 2 and
(N, H, h) = (20, 4, 1024) and (33, 8, 136): ``cf_reference`` and
``cf_forward_reference`` at rtol 2e-5, atol 2e-5; the autograd of
``cf_reference`` and ``cf_backward_reference`` at rtol 2e-4, atol 2e-5
(``test_torch_wide_critic.py`` sets out the rest, and holds (7, 3, 6)).
"""

import pytest

from test_torch_wide_critic import test_cf_plain_matches_the_pallas_forward_and_backward as _held
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("N,H,h", [(20, 4, 1024), (33, 8, 136)])
def test_cf_plain_matches_the_pallas_forward_and_backward_wide(N, H, h):
    _held(N, H, h)

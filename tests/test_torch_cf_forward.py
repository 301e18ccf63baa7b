"""The staged plain version of the fused attention's forward (K5f) on the CPU.

On the card K5f runs as two kernels joined by scratch in device memory: the
softmax terms and base products of each (group, head), stage 0 of the
backward as it stands, then the rows of each (group, counterfactuals),
which rebuild fc from the base products, take its LayerNorm and pool it.
``cf_forward_reference`` computes the same stages in plain PyTorch;
``chip_smoke.py`` holds the kernels to it on the card. Here it is held,
from inputs made with numpy from a seed:

- to the JAX package's ``fused_cf_attention`` in interpret mode, which runs
  the Pallas forward body ``_fwd_kernel``, and to the JAX ``cf_reference``,
  at rtol 2e-5, atol 2e-5 (the JAX kernel test's own tolerance), at
  (B, N, H, h) = (4, 6, 2, 64), (3, 5, 4, 32) and (2, 20, 4, 512), the last
  the main path's width, with scores at a trained-like scale (×3);
- with saturated scores (×12), both it and the Pallas forward to a float64
  plain run: its error at most 4 times the Pallas kernel's own, or 4 ulp of
  the output's largest element. Both compute the partition of row (n, I) as
  Z_b − E_aa[n, I] + E_as[n, I] and the numerator from the shared base
  product, which cancel when E_aa[n, I] dominates its row; the fresh
  softmax of ``cf_reference`` does not, so ×12 is not held at rtol 2e-5;
- its scratch: exactly stage 0's (``cf_backward_base``) on the same inputs.

The kernels' wrapper refuses CPU tensors (no silent plain path) and shapes
the tuned kernels do not take, before any launch; ``route`` sends those
shapes to the wide kernels, whose wrapper takes them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.ops import cf_attention as jcf

from swarmacb_torch.ops import _cuda, cf_attention

from test_torch_cf_backward import SHAPES, _inputs, _torch


@functools.lru_cache(maxsize=None)
def _pallas_forward(d):
    """The Pallas kernel's pooled rows, compiled once per shape."""
    return jax.jit(lambda arrays: jcf.fused_cf_attention(*arrays, d, True))


def _staged(B, N, H, h, score_scale, stages=None):
    arrays, _, d = _inputs(B, N, H, h, seed=7 * B + N + h, score_scale=score_scale)
    got = cf_attention.cf_forward_reference(_torch(arrays), d, stages=stages)
    assert tuple(got.shape) == (B, N, h)
    return arrays, d, got.numpy()


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_staged_forward_matches_the_pallas_forward(B, N, H, h):
    arrays, d, got = _staged(B, N, H, h, 3.0)
    want = np.asarray(_pallas_forward(d)(tuple(map(jnp.asarray, arrays))))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_staged_forward_matches_the_jax_cf_reference(B, N, H, h):
    arrays, d, got = _staged(B, N, H, h, 3.0)
    want = np.asarray(jcf.cf_reference(*map(jnp.asarray, arrays), d))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_saturated_scores_as_accurate_as_the_pallas_forward(B, N, H, h):
    arrays, d, got = _staged(B, N, H, h, 12.0)
    pallas = np.asarray(_pallas_forward(d)(tuple(map(jnp.asarray, arrays))))
    truth = cf_attention.cf_reference(*[torch.from_numpy(a).double() for a in arrays],
                                      d).numpy()
    err_staged, err_pallas = np.abs(got - truth).max(), np.abs(pallas - truth).max()
    floor = 4 * float(np.spacing(np.float32(np.abs(truth).max())))
    assert err_staged <= max(4 * err_pallas, floor), (
        f"error {err_staged:.3e} against float64, the Pallas forward's {err_pallas:.3e}")


@pytest.mark.parametrize("B,N,H,h", SHAPES)
def test_scratch_is_stage_0s(B, N, H, h):
    stages = {}
    arrays, d, _ = _staged(B, N, H, h, 3.0, stages=stages)
    terms, base = cf_attention.cf_backward_base(*_torch(arrays)[:5], d)
    assert stages.keys() == {"terms", "base"}
    assert torch.equal(stages["terms"], terms) and tuple(terms.shape) == (B, H, 5, N, N)
    assert torch.equal(stages["base"], base) and tuple(base.shape) == (B, H, 2, N, h)


def test_forward_kernel_refuses_cpu_tensors():
    arrays, _, d = _inputs(2, 5, 2, 32, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cf_attention.forward_kernel(_torch(arrays), d)
    # the CPU forward is the plain version, and launches nothing
    before = _cuda.launches["fused_cf_attention"]
    got = cf_attention.fused_cf_attention(*_torch(arrays), d)
    assert _cuda.launches["fused_cf_attention"] == before
    torch.testing.assert_close(got, cf_attention.cf_reference(*_torch(arrays), d),
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,N,H,h", [(2, 33, 4, 32), (2, 5, 5, 32), (2, 5, 4, 516),
                                     (2, 5, 4, 30)])
def test_forward_kernel_refuses_shapes_it_does_not_take(B, N, H, h):
    """N > 32, H > 4, h > 512 and h % 4 != 0 raise in the tuned kernels'
    wrapper before any launch (the meta device: no data, and no kernel can
    run on it); ``route`` sends them to the wide kernels, whose wrapper
    refuses only the device."""
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    args = (meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, 1),
            meta(B, H, N, h), meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h))
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match=r"h <= 512, N <= 32 and H <= 4"):
        cf_attention.forward_kernel(args, h // H)
    assert cf_attention.route(N, H, h) == "wide"
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        cf_attention.forward_kernel(args, h // H, wide=True)
    assert _cuda.launches == before

"""The staged plain version of the critic tail's backward (K3b) on the CPU.

On the card K3b runs as three kernels joined by d_fc = ∂⟨dout, pooled⟩/∂fc
(B, N², h): the rows of each (b, I), then the batched products
attn_lhsᵀ·d_fc and d_fc·waᵀ. ``tail_backward_reference`` computes the same
stages in plain PyTorch; ``chip_smoke.py`` holds the kernels to it on the
card. Here it is held, from inputs made with numpy from a seed:

- to ``jax.vjp`` of the JAX package's ``fused_tail`` in interpret mode,
  which runs the Pallas backward body ``_bwd_kernel``: all seven cotangents
  at rtol 1e-5, atol 2e-5, as ``tests/test_baseline_tail.py`` holds the
  JAX kernel to its own reference; at (B, N, h) = (6, 5, 32), (3, 4, 64)
  and (2, 20, 512), the last the main path's width;
- its d_fc to autograd's gradient at an explicit fc tensor, at 1e-6: the
  same float32 LayerNorm backward, in another order;
- its cotangents to plain autograd through ``tail_reference``, the CPU
  trainer's path, at rtol 1e-5, atol 2e-5.

The kernels' wrapper refuses CPU tensors (no silent plain path), and the
three stages' C entry points are registered with their argument counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.ops import baseline_tail as jbt

from swarmacb_torch.ops import _cuda, baseline_tail

NAMES = ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")
SHAPES = [(6, 5, 32), (3, 4, 64), (2, 20, 512)]
H = 4


def _inputs(B, N, h, seed):
    """The seven tail inputs and dout: attention rows that sum to one per
    head (attn_mI is the column m = I of the same rows), W_out-folded
    values and residual entities at the critic's scale."""
    rng = np.random.default_rng(seed)
    HM = H * N
    attn = rng.uniform(size=(B, N, H, N, N))
    attn /= attn.sum(-1, keepdims=True)                        # (B, I, H, n, m)
    arrays = [attn.transpose(0, 1, 3, 2, 4).reshape(B, N * N, HM),
              np.einsum("bIhnI->bhIn", attn),
              rng.normal(size=(B, HM, h)) * 0.3, rng.normal(size=(B, H, N, h)) * 0.2,
              rng.normal(size=(B, N, h)), rng.normal(size=(B, N, h)) * 0.5,
              rng.normal(size=(h,)) * 0.1]
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    return arrays, rng.normal(size=(B, N, h)).astype(np.float32)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,N,h", SHAPES)
def test_staged_reference_matches_the_pallas_backward(B, N, h):
    arrays, dout = _inputs(B, N, h, seed=B * N + h)
    _, vjp = jax.vjp(lambda *a: jbt.fused_tail(*a, N, True), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))
    d_fc, got = baseline_tail.tail_backward_reference(_torch(arrays), torch.from_numpy(dout), N)
    assert tuple(d_fc.shape) == (B, N * N, h)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


@pytest.mark.parametrize("B,N,h", SHAPES)
def test_d_fc_is_the_gradient_at_fc(B, N, h):
    arrays, dout = _inputs(B, N, h, seed=B + N + h)
    args, dout = _torch(arrays), torch.from_numpy(dout)
    fc = baseline_tail._fc(*args, N).detach().requires_grad_()
    want, = torch.autograd.grad(baseline_tail.pool_layernorm(fc, N), fc, dout)
    d_fc, _ = baseline_tail.tail_backward_reference(args, dout, N)
    np.testing.assert_allclose(d_fc.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,N,h", SHAPES)
def test_staged_reference_matches_autograd_of_tail_reference(B, N, h):
    arrays, dout = _inputs(B, N, h, seed=3 * B + h)
    args = [t.requires_grad_() for t in _torch(arrays)]
    dout = torch.from_numpy(dout)
    want = torch.autograd.grad(baseline_tail.tail_reference(*args, N), args, dout)
    _, got = baseline_tail.tail_backward_reference([a.detach() for a in args], dout, N)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


def test_backward_kernel_refuses_cpu_tensors():
    arrays, dout = _inputs(2, 5, 32, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        baseline_tail.backward_kernel(_torch(arrays), torch.from_numpy(dout), 5)
    # the CPU gradient is plain autograd of the plain version
    args = [t.requires_grad_() for t in _torch(arrays)]
    before = _cuda.launches["fused_tail_bwd"]
    torch.autograd.grad(baseline_tail.fused_tail(*args, 5), args, torch.from_numpy(dout))
    assert _cuda.launches["fused_tail_bwd"] == before


def test_stage_entry_points_are_registered():
    """Stage 1 takes the seven inputs, dout and its four outputs; stage 2
    attn_lhs, d_fc, d_wa, d_xa, d_bias and the partial; stage 3 d_fc, wa and
    d_attn_lhs; each then (B, N, H, h) and the stream. The forward (K3f)
    has a source of its own, ``tail_forward.cu``."""
    entries = _cuda.SIGNATURES["baseline_tail"]
    ptr, num = _cuda._P, _cuda._I
    tail = [num] * 4 + [ptr]
    assert entries == {
        "tail_bwd_rows_launch": [ptr] * 12 + tail,
        "tail_bwd_wa_launch": [ptr] * 6 + tail,
        "tail_bwd_attn_launch": [ptr] * 3 + tail,
    }

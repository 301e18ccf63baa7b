"""The plain version of the critic tail's forward kernel (K3f) on the CPU.

On the card K3f takes the product attn_lhs·wa on the tensor cores in
3×TF32: each operand is split into a TF32 high part and a TF32 remainder
(``split_tf32``, the kernel's ``cvt.rna.tf32.f32``), and the product is
lo·hi + hi·lo + hi·hi. ``tail_reference_3xtf32`` is that arithmetic in plain
PyTorch; ``chip_smoke.py`` holds the kernel to ``tail_reference`` on the
card. Here, from inputs made with numpy from a seed:

- the split's high part has its 13 low mantissa bits zero, ties round away
  from zero, and |x − hi − lo| ≤ 2⁻²²·|x| wherever x and its remainder are
  normal floats;
- ``tail_reference_3xtf32`` agrees with the JAX package's ``fused_tail`` in
  interpret mode (the Pallas body ``_fwd_kernel``) within
  1e-5 + 1e-5·|ref|, the tolerance ``chip_smoke.py`` holds K3f to, at
  (B, N, h) = (6, 5, 32), (3, 4, 64) and (2, 20, 512), the last the main
  path's width; a single TF32 product misses that tolerance at the main
  width, so the tolerance tells the two routes apart;
- the tuned kernels' wrapper refuses the shapes outside their limits
  before a launch, and ``route`` sends exactly those shapes to the wide
  kernels, whose wrapper takes them; the new source is registered with its
  entry point.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from swarmacb_tpu.ops import baseline_tail as jbt

from swarmacb_torch.ops import _cuda, baseline_tail

SHAPES = [(6, 5, 32), (3, 4, 64), (2, 20, 512)]
H = 4
ATOL = RTOL = 1e-5          # chip_smoke.py phase 2b


def _inputs(B, N, h, seed):
    """The seven tail inputs: attention rows that sum to one per head
    (attn_mI is the column m = I of the same rows), W_out-folded values and
    residual entities at the critic's scale."""
    rng = np.random.default_rng(seed)
    HM = H * N
    attn = rng.uniform(size=(B, N, H, N, N))
    attn /= attn.sum(-1, keepdims=True)                        # (B, I, H, n, m)
    arrays = [attn.transpose(0, 1, 3, 2, 4).reshape(B, N * N, HM),
              np.einsum("bIhnI->bhIn", attn),
              rng.normal(size=(B, HM, h)) * 0.3, rng.normal(size=(B, H, N, h)) * 0.2,
              rng.normal(size=(B, N, h)), rng.normal(size=(B, N, h)) * 0.5,
              rng.normal(size=(h,)) * 0.1]
    return [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]


def _pallas(arrays, N):
    return np.asarray(jbt.fused_tail(*map(jnp.asarray, arrays), N, True))


def _bits(x):
    return x.view(torch.int32)


def test_split_high_part_has_its_13_low_mantissa_bits_zero():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100_000).astype(np.float32))
    x = torch.cat([x, x * 1e-30, x * 1e30])
    hi, lo = baseline_tail.split_tf32(x)
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -11, 1 + 2 ** -10),                  # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),               # a tie above an odd last bit
    (1 + 2 ** -11 - 2 ** -23, 1.0),                # just below the tie: down
    (2 - 2 ** -12, 2.0),                           # rounds up into the next binade
])
def test_split_rounds_to_nearest_with_ties_away_from_zero(x, want):
    hi, lo = baseline_tail.split_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(hi) == want
    assert float(hi) + float(lo) == pytest.approx(x, rel=2 ** -22, abs=0)


def test_split_passes_non_finite_values_through():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, lo = baseline_tail.split_tf32(x)
    assert torch.equal(hi[:2], x[:2]) and bool(hi[2].isnan())
    assert torch.equal(lo, torch.zeros(3))


# |x| in [2^-100, 2^126): the remainder x − hi, as small as 2^-23·|x|, stays a
# normal float, and hi cannot round up to infinity.
_NORMAL = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 126, width=32,
                    allow_nan=False, allow_infinity=False)


@settings(max_examples=400, deadline=None, database=None)
@given(st.lists(_NORMAL, min_size=1, max_size=64), st.lists(st.booleans(), min_size=64,
                                                             max_size=64))
@example([1 + 2 ** -11, 1 + 3 * 2 ** -11, 2 - 2 ** -12, 3 * 2 ** -25, 2.0 ** -100,
          np.float32(2.0 ** 126) * np.float32(1.9)], [False, True] * 32)
def test_split_error_is_at_most_2_to_the_minus_22(values, signs):
    x = torch.tensor([-v if s else v for v, s in zip(values, signs)], dtype=torch.float32)
    hi, lo = baseline_tail.split_tf32(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("B,N,h", SHAPES)
def test_3xtf32_reference_matches_the_pallas_forward(B, N, h):
    arrays = _inputs(B, N, h, seed=7 * B + N + h)
    want = _pallas(arrays, N)
    got = baseline_tail.tail_reference_3xtf32(*map(torch.from_numpy, arrays), N).numpy()
    assert got.shape == (B, N, h)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_one_tf32_product_misses_the_tolerance_at_the_main_width():
    """hi·hi alone (plain TF32) is what the tolerance must refuse."""
    B, N, h = SHAPES[-1]
    arrays = _inputs(B, N, h, seed=7 * B + N + h)
    want = _pallas(arrays, N)
    args = list(map(torch.from_numpy, arrays))

    def one_product(a, b):
        return torch.matmul(baseline_tail.split_tf32(a)[0], baseline_tail.split_tf32(b)[0])

    fc = baseline_tail._fc(*args, N, product=one_product)
    got = baseline_tail.pool_layernorm(fc, N).numpy()
    assert not np.all(np.abs(got - want) <= ATOL + RTOL * np.abs(want))


def _meta_args(B, N, H_, h):
    shapes = [(B, N * N, H_ * N), (B, H_, N, N), (B, H_ * N, h), (B, H_, N, h),
              (B, N, h), (B, N, h), (h,)]
    return [torch.empty(s, device="meta") for s in shapes]


@pytest.mark.parametrize("N,H_,h", [(20, 4, 516), (20, 4, 1024), (20, 4, 130),
                                    (33, 4, 64), (5, 3, 32), (20, 4, 4096)])
def test_check_refuses_shapes_outside_the_kernels_limits(N, H_, h):
    """The tuned kernels still refuse these shapes; ``route`` now sends them
    to the wide kernels, whose check takes them (only the meta device, not
    CUDA, is refused)."""
    with pytest.raises(ValueError, match=r"h <= 512, N <= 32 and H\*N % 4 == 0"):
        baseline_tail._check(_meta_args(2, N, H_, h), N)
    assert baseline_tail.route(N, H_, h) == "wide"
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        baseline_tail._check(_meta_args(2, N, H_, h), N, wide=True)


@pytest.mark.parametrize("N,H_,h", [(20, 4, 512), (20, 4, 128), (5, 4, 32), (32, 4, 36),
                                    (1, 4, 4)])
def test_check_takes_shapes_inside_the_limits(N, H_, h):
    # the shape passes; only the device (meta, not CUDA) is refused
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        baseline_tail._check(_meta_args(2, N, H_, h), N)
    assert baseline_tail.route(N, H_, h) == "tuned"
    with pytest.raises(ValueError, match="the wide kernels take the widths the tuned"):
        baseline_tail._check(_meta_args(2, N, H_, h), N, wide=True)


def test_forward_source_is_registered_without_a_register_cap():
    assert _cuda.SIGNATURES["tail_forward"] == {
        "tail_forward_launch": [_cuda._P] * 8 + [_cuda._I] * 4 + [_cuda._P]}
    assert not any("maxrregcount" in f for f in _cuda.SOURCES["tail_forward"])
    source = (_cuda.CSRC / "tail_forward.cu").read_text(encoding="utf-8")
    # with the primitives it shares with the wide route (tc_common.cuh)
    included = re.findall(r'^#include "([^"]+)"', source, re.M)
    assert included == ["tc_common.cuh"]
    code = source + "".join((_cuda.CSRC / f).read_text(encoding="utf-8") for f in included)
    assert "__launch_bounds__" in source and "wgmma.mma_async" in code
    assert "cvt.rna.tf32.f32" in code
    assert "fused_tail_fwd" not in (_cuda.CSRC / "baseline_tail.cu").read_text(
        encoding="utf-8")

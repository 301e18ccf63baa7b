"""The critic kernels' wide route (K3f, K3b, K5f and K5b at the widths the
tuned kernels refuse) on the CPU, where every op takes its plain version.

On the card ``ops.fused_tail`` and ``ops.fused_cf_attention`` send every
shape past the tuned kernels' limits (h > 512, h % 4 != 0, N > 32, and
H·N % 4 != 0 or H > 4) to ``tail_wide.cu`` and ``cf_attention_wide.cu``,
which ``chip_smoke.py`` (phase 2h) holds to the plain versions. Here the
plain versions are held, from inputs made with numpy from a seed, at B = 2:

- to the JAX package's Pallas functions in interpret mode, as its own tests
  run them: ``tail_reference``, its autograd and
  ``tail_backward_reference`` to ``fused_tail`` and its ``jax.vjp``
  (forward 1e-5 + 1e-5·|ref|, cotangents rtol 1e-5, atol 2e-5, the
  tolerances of ``tests/test_torch_tail_forward.py`` and
  ``test_torch_tail_backward.py``) at (N, H, h) = (20, 4, 1024) and
  (33, 3, 130); ``cf_reference``, ``cf_forward_reference``, the autograd of
  ``cf_reference`` and ``cf_backward_reference`` to ``fused_cf_attention``
  (forward rtol 2e-5, atol 2e-5; cotangents rtol 2e-4, atol 2e-5, the
  tolerances of ``tests/test_torch_cf_forward.py`` and
  ``test_torch_cf_backward.py``) at (7, 3, 6) here, and at (20, 4, 1024)
  and (33, 8, 136) in ``test_torch_wide_critic_cf.py``;
- the wide route's LayerNorm statistics, summed over column tiles of 512
  (``layernorm_tiled``), to the whole-row ones at 1e-6;
- ``route`` through the wrappers on meta tensors: which forward each shape
  reaches.

A rollout and a minibatch update at ``hidden_dim=1024`` against the JAX
trainer are in ``test_torch_wide_critic_rollout.py`` and
``test_torch_wide_critic_update.py`` (the default critic path) and their
``_fused_`` counterparts. The files are apart so that the test workers take
them side by side: the JAX compiles and the Pallas interpret runs at these
widths take seconds each.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.ops import baseline_tail as jbt
from swarmacb_tpu.ops import cf_attention as jcf

from swarmacb_torch import ops
from swarmacb_torch.ops import baseline_tail, cf_attention
from torch_threads import one_torch_thread  # noqa: F401

B = 2
TAIL_SHAPES = [(20, 4, 1024), (33, 3, 130)]
CF_SHAPES = [(7, 3, 6)]     # (20, 4, 1024) and (33, 8, 136): test_torch_wide_critic_cf.py
TAIL_NAMES = ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _tail_inputs(N, H, h, seed):
    """The seven tail inputs and dout: attention rows that sum to one per
    head (attn_mI is the column m = I of the same rows), folded values and
    residual entities at the critic's scale."""
    rng = np.random.default_rng(seed)
    attn = rng.uniform(size=(B, N, H, N, N))
    attn /= attn.sum(-1, keepdims=True)                        # (B, I, H, n, m)
    arrays = [attn.transpose(0, 1, 3, 2, 4).reshape(B, N * N, H * N),
              np.einsum("bIhnI->bhIn", attn),
              rng.normal(size=(B, H * N, h)) * 0.3, rng.normal(size=(B, H, N, h)) * 0.2,
              rng.normal(size=(B, N, h)), rng.normal(size=(B, N, h)) * 0.5,
              rng.normal(size=(h,)) * 0.1]
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    return arrays, rng.normal(size=(B, N, h)).astype(np.float32)


def _cf_inputs(N, H, h, seed):
    """Raw scores at a trained-like scale (×3), folded values, residual
    entities, bias and dout, as tests/test_cf_attention.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = [f(B, H, N, N) * 3, f(B, H, N, N) * 3, f(B, H, N, N) * 3, f(B, H, N, 1) * 3,
              f(B, H, N, h), f(B, H, N, h), f(B, N, h), f(B, N, h), f(h)]
    return [a.astype(np.float32) for a in arrays], f(B, N, h), max(1, h // H)


# ── the plain versions against the Pallas functions ───────────────────────

@pytest.mark.parametrize("N,H,h", TAIL_SHAPES)
def test_tail_plain_matches_the_pallas_forward(N, H, h):
    arrays, _ = _tail_inputs(N, H, h, seed=N + h)
    want = np.asarray(jbt.fused_tail(*map(jnp.asarray, arrays), N, True))
    got = baseline_tail.tail_reference(*_t(arrays), N).numpy()
    assert got.shape == (B, N, h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,H,h", TAIL_SHAPES)
def test_tail_plain_matches_the_pallas_backward(N, H, h):
    arrays, dout = _tail_inputs(N, H, h, seed=2 * N + h)
    _, vjp = jax.vjp(lambda *a: jbt.fused_tail(*a, N, True), *map(jnp.asarray, arrays))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout))]
    d_fc, staged = baseline_tail.tail_backward_reference(_t(arrays), torch.from_numpy(dout), N)
    assert tuple(d_fc.shape) == (B, N * N, h)
    args = [a.requires_grad_() for a in _t(arrays)]
    autograd = torch.autograd.grad(baseline_tail.tail_reference(*args, N), args,
                                   torch.from_numpy(dout))
    for name, s, a, w in zip(TAIL_NAMES, staged, autograd, want):
        for what, g in (("staged", s), ("autograd", a)):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-5,
                                       err_msg=f"{what} cotangent of {name}")


@functools.lru_cache(maxsize=None)
def _pallas_cf(d):
    """The Pallas kernel's pooled rows and cotangents, compiled once a d."""
    def run(arrays, dout):
        out, vjp = jax.vjp(lambda *a: jcf.fused_cf_attention(*a, d, True), *arrays)
        return out, vjp(dout)
    return jax.jit(run)


@pytest.mark.parametrize("N,H,h", CF_SHAPES)
def test_cf_plain_matches_the_pallas_forward_and_backward(N, H, h):
    arrays, dout, d = _cf_inputs(N, H, h, seed=N * H + h)
    out, cot = _pallas_cf(d)(tuple(map(jnp.asarray, arrays)), jnp.asarray(dout))
    for what, got in (("cf_reference", cf_attention.cf_reference(*_t(arrays), d)),
                      ("cf_forward_reference", cf_attention.cf_forward_reference(_t(arrays), d))):
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2e-5, atol=2e-5,
                                   err_msg=what)
    _, staged = cf_attention.cf_backward_reference(_t(arrays), torch.from_numpy(dout), d)
    args = [a.requires_grad_() for a in _t(arrays)]
    autograd = torch.autograd.grad(cf_attention.cf_reference(*args, d), args,
                                   torch.from_numpy(dout))
    for name, s, a, w in zip(cf_attention.NAMES, staged, autograd, cot):
        for what, g in (("staged", s), ("autograd", a)):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{what} cotangent of {name}")


def test_cf_staged_plain_at_a_small_shape_as_accurate_as_the_pallas_backward():
    """At (7, 3, 6) the staged plain version, the arithmetic of both K5b
    routes, is within 4 times the Pallas backward's own error against a
    float64 plain run (or 4 ulp of the cotangent's largest element), the
    rule of ``test_torch_cf_backward.py`` for saturated scores. There the
    Pallas kernel itself misses the rule ``chip_smoke.py`` phase 2e holds
    K5b to at B = 1024 (at most 2 times the float32 plain version's error,
    2.5 for wa): both build the partition of row (n, I) as
    Z_b − E_aa + E_as, which cancels where E_aa[n, I] dominates its row, so
    phase 2h holds the wide K5b to that rule at the full width only."""
    arrays, dout, d = _cf_inputs(7, 3, 6, seed=76)
    _, pallas = _pallas_cf(d)(tuple(map(jnp.asarray, arrays)), jnp.asarray(dout))
    _, staged = cf_attention.cf_backward_reference(_t(arrays), torch.from_numpy(dout), d)
    args = [a.requires_grad_() for a in _t(arrays)]
    plain = torch.autograd.grad(cf_attention.cf_reference(*args, d), args,
                                torch.from_numpy(dout))
    args64 = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    truth = torch.autograd.grad(cf_attention.cf_reference(*args64, d), args64,
                                torch.from_numpy(dout).double())
    past_rule = []
    for name, s, p, w, t in zip(cf_attention.NAMES, staged, pallas, plain, truth):
        t = t.numpy()
        err = {k: float(np.abs(np.asarray(v, np.float64) - t).max())
               for k, v in (("staged", s.numpy()), ("pallas", p), ("plain", w.numpy()))}
        floor = 4 * float(np.spacing(np.float32(np.abs(t).max())))
        assert err["staged"] <= max(4 * err["pallas"], floor), (name, err)
        if err["pallas"] > max((2.5 if name == "wa" else 2.0) * err["plain"], floor):
            past_rule.append(name)
    assert past_rule, "the Pallas backward met phase 2e's rule at this shape"


@pytest.mark.parametrize("h", [1024, 1500, 130, 6])
def test_tiled_layernorm_matches_the_whole_row(h):
    rng = np.random.default_rng(h)
    fc = torch.from_numpy((rng.normal(size=(3, 40, h)) * 2 + 0.7).astype(np.float32))
    y, rstd = baseline_tail.layernorm_tiled(fc)
    want_y, want_rstd = baseline_tail._layernorm(fc)
    np.testing.assert_allclose(rstd.numpy(), want_rstd.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-6, atol=1e-6)


# ── the route ─────────────────────────────────────────────────────────────

@pytest.mark.parametrize("N,H,h,tail,cf", [
    (20, 4, 512, "tuned", "tuned"), (20, 4, 128, "tuned", "tuned"),
    (20, 4, 1024, "wide", "wide"), (33, 3, 130, "wide", "wide"),
    (33, 8, 136, "wide", "wide"), (7, 3, 6, "wide", "wide"),
    (20, 8, 512, "tuned", "wide"), (7, 3, 128, "wide", "tuned"), (1, 1, 1, "wide", "wide"),
])
def test_route_on_meta_tensors(monkeypatch, N, H, h, tail, cf):
    """The wrappers reach the forward of the route ``route`` names, by
    shape alone (meta tensors: no data, and no kernel can run on them)."""
    assert (baseline_tail.route(N, H, h), cf_attention.route(N, H, h)) == (tail, cf)
    reached = []

    def record(args, _, wide=False):
        reached.append("wide" if wide else "tuned")
        return torch.empty((B, N, h), device="meta")

    monkeypatch.setattr(baseline_tail, "_forward_kernel", record)
    monkeypatch.setattr(cf_attention, "forward_kernel", record)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    tail_args = (meta(B, N * N, H * N), meta(B, H, N, N), meta(B, H * N, h),
                 meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h))
    cf_args = (meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, 1),
               meta(B, H, N, h), meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h))
    before = dict(ops.launches)
    baseline_tail.fused_tail(*tail_args, N)
    cf_attention.fused_cf_attention(*cf_args, max(1, h // H))
    assert reached == [tail, cf] and ops.launches == before
    # each route's check refuses the shapes of the other
    with pytest.raises(ValueError, match=r"route\(\) sends these"):
        baseline_tail._check(tail_args, N, wide=tail == "tuned")
    with pytest.raises(ValueError, match=r"route\(\) sends these"):
        cf_attention._check(cf_args, wide=cf == "tuned")


def test_wide_sources_are_registered():
    """``tail_wide.cu``: the forward (the seven inputs, the rows scratch or
    null, the output, the shape and the plan's counterfactuals a block), the
    backward rows (the tuned K3b's arguments, then the plan's counterfactuals
    a block and whether the rows stay in shared memory) and the two
    products, which take the tuned K3b's arguments; ``cf_attention_wide.cu``:
    stage 0 as the tuned K5b's with the coefficients after the terms, the
    forward rows (coef, base, wa, dws, x_a, delta, bias, the rows scratch or
    null, the statistics scratch or null, pooled, the shape and the plan's
    counterfactuals a block), the backward rows (the tuned K5b's with coef
    after the terms and the dots and statistics scratch after d_fc, then the
    plan: counterfactuals a block, whether the rows and dout / N stay in
    shared memory), and the sums and products as the tuned K5b's. No register cap, and the shared device code in
    ``wide_common.cuh``; ``tail_wide.cu``'s products on the tensor cores
    (``tc_gemm``, which ``wide_common.cuh`` builds on ``tc_common.cuh``,
    shared with ``tail_forward.cu``)."""
    from swarmacb_torch.ops import _cuda

    ptr, num, real = _cuda._P, _cuda._I, _cuda._F
    shape = [num] * 4
    tuned_rows = _cuda.SIGNATURES["baseline_tail"]["tail_bwd_rows_launch"]
    assert _cuda.SIGNATURES["tail_wide"] == {
        "tail_wide_forward_launch": [ptr] * 9 + shape + [num, ptr],
        "tail_wide_bwd_rows_launch": tuned_rows[:-1] + [num, num, ptr],
        "tail_wide_bwd_wa_launch": _cuda.SIGNATURES["baseline_tail"]["tail_bwd_wa_launch"],
        "tail_wide_bwd_attn_launch": _cuda.SIGNATURES["baseline_tail"]["tail_bwd_attn_launch"],
    }
    tail_wide = (_cuda.CSRC / "tail_wide.cu").read_text(encoding="utf-8")
    assert "tc_gemm(" in tail_wide and " gemm(" not in tail_wide
    assert '#include "tc_common.cuh"' in (_cuda.CSRC / "wide_common.cuh").read_text(
        encoding="utf-8")
    assert '#include "tc_common.cuh"' in (_cuda.CSRC / "tail_forward.cu").read_text(
        encoding="utf-8")
    tuned = _cuda.SIGNATURES["cf_attention"]
    assert _cuda.SIGNATURES["cf_attention_wide"] == {
        "cf_wide_base_launch": [ptr] + tuned["cf_bwd_base_launch"],
        "cf_wide_fwd_rows_launch": [ptr] * 10 + shape + [num, ptr],
        "cf_wide_bwd_rows_launch": [ptr] * 3 + tuned["cf_bwd_rows_launch"][:-2]
        + [num] * 3 + [real, ptr],
        "cf_wide_bwd_sums_launch": tuned["cf_bwd_sums_launch"],
        "cf_wide_bwd_products_launch": tuned["cf_bwd_products_launch"],
    }
    for name in ("tail_wide", "cf_attention_wide"):
        assert _cuda.SOURCES[name] == ()
        source = (_cuda.CSRC / f"{name}.cu").read_text(encoding="utf-8")
        assert '#include "wide_common.cuh"' in source and "atomicAdd" not in source
    assert {"fused_tail_wide", "fused_tail_wide_bwd", "fused_cf_attention_wide",
            "fused_cf_attention_wide_bwd"} <= set(_cuda.launches)

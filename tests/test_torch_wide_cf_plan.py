"""The plan and the wiring of the fused attention's wide route (K5f-wide,
K5b-wide), on the CPU.

On the card ``cf_attention_wide.cu``'s rows kernels take one or two
counterfactuals a block (P) and keep their fc rows in shared memory where
they fit, as ``cf_attention.cf_wide_plan`` says; ``chip_smoke.py`` (phase
2h) holds the kernels to the staged plain versions at each edge of that
plan. The kernels run the arithmetic of ``cf_forward_reference`` and
``cf_backward_reference``, which ``tests/test_torch_wide_critic.py`` and
``test_torch_wide_critic_cf.py`` hold to the JAX package's Pallas functions.
Here, with no card:

- ``cf_wide_plan`` gives a plan within the card's 232,448 bytes of shared
  memory for every shape the route takes, the most counterfactuals a block
  that fit, and mirrors the constants of ``cf_attention_wide.cu``;
- the wrapper's stages hand each C entry point of the source as many
  arguments as it declares (the ctypes signatures count them too), with
  the scratch the plan asks for, on meta tensors (no data, no launch);
- the wrapper takes every N, and the products take their tiles in shared
  memory up to N = 880 and read their rows from device memory past it.
"""

import re

import pytest
import torch

from swarmacb_torch.ops import _cuda, cf_attention
from swarmacb_torch.ops.baseline_tail import SMEM_BYTES
from torch_threads import one_torch_thread  # noqa: F401

SOURCE = (_cuda.CSRC / "cf_attention_wide.cu").read_text(encoding="utf-8")
COMMON = (_cuda.CSRC / "wide_common.cuh").read_text(encoding="utf-8")


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def test_plan_mirrors_the_kernel_source():
    assert _constant(SOURCE, "kRowThreads") == cf_attention.WIDE_THREADS
    assert _constant(SOURCE, "kMaxPer") == cf_attention.WIDE_MAX_PER_BLOCK
    assert _constant(SOURCE, "kCoef") == 3
    assert _constant(SOURCE, "kRedRows") == cf_attention.WIDE_RED_ROWS
    assert _constant(COMMON, "kMaxSmem") == SMEM_BYTES
    # the shared memory before the rows: the warps' sums, the statistics,
    # the coefficients, dout / N, as cf_wide_plan counts them
    head = re.search(r"rows_head_floats\(int N, int H, int h, int P, bool stats_in_smem,"
                     r"\s*bool coef_in_smem, bool dy_in_smem\) \{(.*?)\n\}", SOURCE,
                     re.S).group(1)
    assert "size_t f = 2 * kRedRows * kRowThreads;" in head
    assert "if (stats_in_smem) f += round4(3 * P * N + P);" in head
    assert "if (coef_in_smem) f += static_cast<size_t>(P) * N * kCoef * round4(H);" in head
    assert "if (dy_in_smem) f += static_cast<size_t>(P) * round4(h);" in head
    # the coefficients stay on chip wherever they fit beside the rest
    assert ("return rows_head_floats(N, H, h, P, stats_in_smem, true, false) * sizeof(float) "
            "<= kMaxSmem;") in SOURCE
    # the statistics live where the rows do; in device memory a block's
    # 3·P·N + P floats of the stats scratch at blockIdx.x times that
    assert "constexpr bool stats_in_smem = kRowsSmem;" in SOURCE
    assert "n_stats = 3 * P * N + P;" in SOURCE
    assert "stats + static_cast<size_t>(blockIdx.x) * n_stats" in SOURCE


# (P, rows, coefficients, dout / N on chip; bytes of shared memory)
@pytest.mark.parametrize("N,H,h,plan", [
    (20, 4, 1024, (2, True, True, True, 199_024, 207_216)),  # the full width: two counterfactuals
    (20, 4, 2048, (1, True, True, True, None, None)),      # one counterfactual's rows, 160 KB
    (20, 3, 3000, (2, False, True, True, 34_688, 58_688)),  # the rows and statistics in device memory
    (2, 1, 30000, (2, False, True, False, None, None)),    # dout / N in device memory too
    (7, 3, 6, (2, True, True, True, None, None)),
    (33, 8, 136, (2, True, True, True, None, None)),
    (130, 1, 8, (2, True, True, True, None, None)),
    (900, 1, 8, (2, True, True, True, 198_384, 198_448)),  # past the products' tiles
    (1000, 16, 8, (2, False, False, True, None, None)),    # coefficients in device memory
    (8400, 1, 4, (2, False, False, True, 32_768, 32_800)),
    (20000, 1, 60000, (2, False, False, False, 32_768, 32_768)),
    (1, 1, 1, (1, True, True, True, None, None)),
])
def test_plan_at_the_route_s_edges(N, H, h, plan):
    got = cf_attention.cf_wide_plan(N, H, h)
    assert (got.per_block, got.rows_in_smem, got.coef_in_smem, got.dy_in_smem) == plan[:4]
    assert plan[4] is None or (got.fwd_smem_bytes, got.bwd_smem_bytes) == plan[4:]


@pytest.mark.parametrize("H", [1, 2, 3, 4, 8, 16])
def test_plan_for_every_shape_the_route_takes(H):
    """Every (N, h) gets a plan within the card's shared memory: one or two
    counterfactuals a block, the rows in shared memory with the most that
    fit (and with them the statistics, the coefficients and dout / N), else
    two (or N = 1) with the rows and their statistics in device memory; the
    coefficients, then dout / N, stay on chip wherever they fit."""
    head = cf_attention._wide_head_floats
    for N in [*range(1, 42), 47, 64, 80, 81, 100, 128, 130, 256, 880, 881, 1000, 8400, 40000]:
        for h in (1, 2, 3, 6, 130, 512, 516, 1000, 1024, 2048, 3000, 4096, 8192, 30000, 60000):
            got = cf_attention.cf_wide_plan(N, H, h)
            P, most = got.per_block, min(N, 2)
            assert 1 <= P <= most, (N, H, h)
            assert max(got.fwd_smem_bytes, got.bwd_smem_bytes) <= SMEM_BYTES, (N, H, h)
            assert got.fwd_smem_bytes <= got.bwd_smem_bytes, (N, H, h)
            rows = P * N * h if got.rows_in_smem else 0
            stats = got.rows_in_smem  # the statistics live where the rows do
            assert got.bwd_smem_bytes == 4 * (head(N, H, h, P, stats, got.coef_in_smem,
                                                   got.dy_in_smem) + rows), (N, H, h)
            assert got.coef_in_smem == (4 * head(N, H, h, P, stats, True, False) <= SMEM_BYTES)
            if got.rows_in_smem:
                assert got.coef_in_smem and got.dy_in_smem
                if P < most:
                    assert 4 * (head(N, H, h, P + 1, True, True, True)
                                + (P + 1) * N * h) > SMEM_BYTES
            else:
                assert P == most
                assert 4 * (head(N, H, h, 1, True, True, True) + N * h) > SMEM_BYTES
                assert got.dy_in_smem == (4 * head(N, H, h, P, stats, got.coef_in_smem, True)
                                          <= SMEM_BYTES)


def _entry_arity(name):
    """The parameter count of an extern "C" entry point of the source."""
    params = re.search(rf"\nint {name}\((.*?)\) \{{", SOURCE, re.S).group(1)
    return len(params.split(","))


def test_signatures_match_the_source():
    for name, argtypes in _cuda.SIGNATURES["cf_attention_wide"].items():
        assert _entry_arity(name) == len(argtypes), name


def _meta_args(B, N, H, h):
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    return [meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, 1),
            meta(B, H, N, h), meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h)]


@pytest.mark.parametrize("B,N,H,h", [(1024, 20, 4, 1024), (3, 20, 4, 2048),
                                     (2, 20, 3, 3000), (1, 2, 1, 30000), (5, 7, 3, 6),
                                     (1, 900, 1, 8)])
def test_stages_pass_each_entry_its_arguments(monkeypatch, B, N, H, h):
    """Each stage of both directions calls its entry point with as many
    arguments as the source declares (the stream last), with the plan's
    integers; the scratch has the shapes the kernels index."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(cf_attention, "_library", lambda wide: Lib())
    monkeypatch.setattr(_cuda, "launch",
                        lambda t, what, entry, *args: calls.append((entry, args)))
    args, dout = _meta_args(B, N, H, h), torch.empty((B, N, h), device="meta")
    plan = cf_attention.cf_wide_plan(N, H, h)
    scratch_f, pooled, forward = cf_attention._forward_stage_calls(args, 1, B, N, H, h,
                                                                   wide=True)
    scratch_b, grads, backward = cf_attention._stage_calls(args, dout, 1.0, B, N, H, h,
                                                           wide=True)
    for launch in (*forward, *backward):
        launch()
    assert [c[0] for c in calls] == [
        "cf_wide_base_launch", "cf_wide_fwd_rows_launch", "cf_wide_base_launch",
        "cf_wide_bwd_rows_launch", "cf_wide_bwd_sums_launch", "cf_wide_bwd_products_launch"]
    for entry, passed in calls:
        assert len(passed) + 1 == _entry_arity(entry), entry
    assert calls[1][1][-1] == plan.per_block
    assert calls[3][1][-4:-1] == (plan.per_block, int(plan.rows_in_smem), int(plan.dy_in_smem))
    hp = -(-H // 4) * 4
    for scratch in (scratch_f, scratch_b):
        assert scratch["coef"].shape == (B, N, N, 3, hp)
        assert scratch["base"].shape == (B, H, 2, N, h)
    assert ("rows" in scratch_f) == (not plan.rows_in_smem)
    assert "rows" not in scratch_f or scratch_f["rows"].shape == (B, N * N, h)
    # the statistics' scratch, passed in place of the null after the rows'
    # (forward) and after the dots (backward)
    P, blocks = plan.per_block, B * -(-N // plan.per_block)
    for scratch in (scratch_f, scratch_b):
        assert ("stats" in scratch) == (not plan.rows_in_smem)
        assert "stats" not in scratch or scratch["stats"].shape == (blocks * (3 * P * N + P),)
    assert (calls[1][1][8] is None) == plan.rows_in_smem
    assert (calls[3][1][11] is None) == plan.rows_in_smem
    assert scratch_b["dots"].shape == (B, N, N, 3, H) and "dU2" not in scratch_b
    assert pooled.shape == (B, N, h) and [g.shape for g in grads] == [a.shape for a in args]


def _products_fit(N, h, source=SOURCE, common=COMMON):
    """``products_plan`` of cf_attention_wide.cu: whether some tile of the
    products' two buffers of 4·N rows fits (a multiple of 32 columns within
    kProductSmem, first with E_aa and E_sa staged, then without; else a
    multiple of 4 within the card's shared memory)."""
    def round4(x):
        return -(-x // 4) * 4

    threads, max_smem = _constant(common, "kThreads"), _constant(common, "kMaxSmem")
    tile = _constant(source, "kProductTile")
    product_smem = 120 * 1024
    assert "constexpr int kProductSmem = 120 * 1024;" in source
    blocks = (N + 1) // 2 * ((N + 3) // 4)
    groups = threads // blocks if blocks < threads else 1
    for step, staged, limit in ((32, True, min(product_smem, max_smem)),
                                (32, False, min(product_smem, max_smem)), (4, False, max_smem)):
        head = 2 * round4(N) + (2 * N * round4(N) if staged else 0) + (
            groups * blocks * 16 if groups > 1 else 0)
        if head >= limit // 4 or (limit // 4 - head) // (8 * N) < 8:
            continue
        if min(tile, round4(h), ((limit // 4 - head) // (8 * N) - 4) // step * step) >= 4:
            return True
    return False


def test_the_route_takes_every_n():
    """The products' tiles fit shared memory up to N = 880, and past it the
    launch reads their rows from device memory instead of refusing; the
    wrapper's checks refuse no N (on meta tensors only for the device)."""
    assert _products_fit(880, 1)
    assert not _products_fit(881, 1)
    assert all(_products_fit(N, h) for N in (1, 7, 20, 33, 130, 512) for h in (1, 6, 1024))
    launch = re.search(r"\nint cf_wide_bwd_products_launch\((.*?)\n\}", SOURCE, re.S).group(1)
    assert "if (T < 4) {" in launch
    assert "cf_wide_products_dwa_kernel<<<" in launch and "cf_wide_products_ds_kernel<<<" in launch
    assert not hasattr(cf_attention, "WIDE_MAX_N")
    for N in (880, 881, 900, 8400, 40000):
        with pytest.raises(ValueError, match="the kernels take CUDA tensors"):
            cf_attention._check(_meta_args(1, N, 1, 8), wide=True)

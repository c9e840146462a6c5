"""P2-P4, the no-max attention of the attention probes (imagharmony_tpu_torch/
kernels/probe_attention.py), P5-P6, the softmax recipes of the softmax
probes on the same kernel (kernels/probe_softmax.py), and the port's
attention and softmax probe tools (imagharmony_tpu_torch/probes/
probe_attn_kblock.py, probe_attn_lanegroup.py, probe_softmax_nomax.py,
probe_softmax_tricks.py).

On the CPU: the plain versions ``nomax_attn_plain`` and
``softmax_recipe_plain``, through each entry point, against the TPU kernels
run unchanged in Pallas TPU interpret mode (``kblock_attn`` and
``batchpack_attn`` of tools/probe_attn_kblock.py, ``nhd_with_g`` of
tools/probe_attn_lanegroup.py, ``run_variant`` of
tools/probe_softmax_nomax.py and of tools/probe_softmax_tricks.py), clamped
cases where they keep the TPU kernels' saturation and not the exact
softmax, the entry points' checks, and the four probe tools with
``--device cpu``.

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): the kernel
against its plain versions under the three schedules and the eight
recipes, the schedules bit for bit against each other, the clamp and the
overflow kept. The machine with the card has no JAX, so this module
imports JAX only inside the tests that compare with it; run the card's
tests there with

    python -m pytest tests/test_torch_probe_attention.py -m cuda --noconftest -p no:cacheprovider
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import probe_attention as pa
from imagharmony_tpu_torch.kernels import probe_softmax as ps
from torch_port_util import TOL, close, cuda, randn, t  # noqa: F401  (cuda is a fixture)

TOOLS = Path(__file__).resolve().parent.parent / "tools"

# the probes at a small size: (B, S, H*D), four heads of 64
B, S, HD, D = 2, 256, 256, 64
SCALE = D ** -0.5
KV_LEN = 200


def _probe(name):
    """tools/<name>.py as a module (the directory is not a package)."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv():
    return randn(0, B, S, HD), randn(1, B, S, HD), randn(2, B, S, HD)


# case -> (the TPU kernel's call on jnp arrays, the port's call on CPU tensors)
CASES = {
    "kblock_bq128_kb128": (
        lambda m, q, k, v: m["probe_attn_kblock"].kblock_attn(q, k, v, SCALE, D, 128, 128),
        lambda q, k, v: pa.kblock_attn(q, k, v, SCALE, D, 128, 128)),
    "kblock_bq64_kb64": (
        lambda m, q, k, v: m["probe_attn_kblock"].kblock_attn(q, k, v, SCALE, D, 64, 64),
        lambda q, k, v: pa.kblock_attn(q, k, v, SCALE, D, 64, 64)),
    "batchpack": (
        lambda m, q, k, v: m["probe_attn_kblock"].batchpack_attn(q, k, v, SCALE, D),
        lambda q, k, v: pa.batchpack_attn(q, k, v, SCALE, D)),
    "nhd_g128_kv200": (
        lambda m, q, k, v: m["probe_attn_lanegroup"].nhd_with_g(q, k, v, SCALE, D, KV_LEN, 128),
        lambda q, k, v: pa.nhd_with_g(q, k, v, SCALE, D, KV_LEN, 128)),
    "nhd_g256_kv200": (
        lambda m, q, k, v: m["probe_attn_lanegroup"].nhd_with_g(q, k, v, SCALE, D, KV_LEN, 256),
        lambda q, k, v: pa.nhd_with_g(q, k, v, SCALE, D, KV_LEN, 256)),
}


def _run_probe(case, q, k, v):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    mods = {name: _probe(name) for name in ("probe_attn_kblock", "probe_attn_lanegroup")}
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(CASES[case][0](mods, *(jnp.asarray(a) for a in (q, k, v))), np.float32)


def test_plain_keeps_probe_function():
    """Each entry point on CPU tensors (the plain version) against its TPU
    kernel run as it is in Pallas TPU interpret mode, fp32 seeded inputs:
    P2 at two (bq, kb) pairs, P3, P4 at g = 128 and 256 (two heads of 64,
    then four, a grid step) with keys past kv_len = 200 < S = 256 masked.
    Tolerance 2e-5 absolute and relative: the logits, exp2 and sums are
    fp32 on both sides, only the order of the key blocks' sums differs. No
    launch is counted.

    Then the clamp: with q times 30 the scaled logits pass 115 on many keys
    of every row, and the TPU kernel saturates them all to 2^115, which
    weighs them equally. The plain version agrees with it (within 4e-5)
    and lies far (more than 1) from the exact softmax, which keeps only the
    largest key of each row. And the overflow: 4096 keys at the clamp sum
    to 2^127 (finite), so v = 1 gives exactly 1, while v = 2 puts 2^128 in
    the PV sum, which overflows fp32 to inf, as the TPU kernel's does (the
    exact softmax would give 2).

    Then P5 and P6 (``_softmax_recipes_keep_probe_functions``, below).

    The cases are one test, not several: the suite's collected count
    decides how its xdist workers share the JAX pipeline tests (see
    ROADMAP C)."""
    q, k, v = _qkv()
    before = dict(pa.launches)
    for case in CASES:
        ref = _run_probe(case, q, k, v)
        out = CASES[case][1](t(q), t(k), t(v))
        assert out.shape == (B, S, HD) and out.dtype == torch.float32, case
        close(out, ref, **TOL)
    assert pa.launches == before

    q30 = q * 30.0
    ref = _run_probe("kblock_bq128_kb128", q30, k, v)
    got = pa.kblock_attn(t(q30), t(k), t(v), SCALE, D, 128, 128)
    close(got, ref, rtol=0, atol=4e-5)
    exact = fa.flash_attention_nhd_plain(t(q30), t(k), t(v), scale=SCALE, head_dim=D)
    assert float((exact - got).abs().max()) > 1.0

    qc = torch.full((1, 4096, D), 4.0)  # logits 64 * 16 * scale * log2(e) = 184.7 > 115
    ones = torch.ones((1, 4096, D))
    assert torch.equal(pa.nomax_attn_plain(qc, qc, ones, SCALE, D, kb=128), ones)
    assert torch.isinf(pa.nomax_attn_plain(qc, qc, 2 * ones, SCALE, D, kb=128)).all()

    _softmax_recipes_keep_probe_functions(q, k, v)


def test_schedule_and_layout_checks(monkeypatch):
    """A tile, head dim, g or kv_len the kernel is not built for raises on
    either device, before any library loads (here on CPU tensors, whose
    plain version would compute any of them). The CUDA path's operand
    checks (``flash_attention._check_layout`` at P2-P4's head dims, naming
    the entry point that was called) refuse another dtype, a width that is
    not a whole number of heads and rows that break the TMA's 16-byte rule,
    and take row-strided column views of one packed qkv tensor. Then P5's
    and P6's entry points (``_softmax_checks``, below)."""
    def no_library(name):
        raise AssertionError(f"a library was loaded: {name}")

    monkeypatch.setattr(pa.build, "load", no_library)
    q = torch.zeros((B, S, HD))
    for case, call in {
        "bq_256": lambda: pa.kblock_attn(q, q, q, SCALE, D, 256, 128),
        "kb_256": lambda: pa.kblock_attn(q, q, q, SCALE, D, 128, 256),
        "kb_128_at_d128": lambda: pa.kblock_attn(q, q, q, SCALE, 128, 128, 128),
        "head_dim_40": lambda: pa.kblock_attn(q[..., :240], q[..., :240], q[..., :240],
                                              SCALE, 40, 128, 64),
        "g_not_multiple_of_head_dim": lambda: pa.nhd_with_g(q, q, q, SCALE, D, S, 96),
        "g_not_dividing_width": lambda: pa.nhd_with_g(q, q, q, SCALE, D, S, 192),
        "kv_len_0": lambda: pa.nhd_with_g(q, q, q, SCALE, D, 0, 128),
        "kv_len_past_keys": lambda: pa.nhd_with_g(q, q, q, SCALE, D, S + 1, 128),
    }.items():
        with pytest.raises(ValueError):
            call()

    bf = torch.bfloat16
    qb, kb, vb = torch.zeros((B, S, 3 * HD), dtype=bf).chunk(3, dim=-1)
    fa._check_layout(qb, kb, vb, D, pa.HEAD_DIMS, "kblock_attn")
    with pytest.raises(TypeError, match="batchpack_attn: the CUDA kernel takes bf16"):
        fa._check_layout(qb.float(), kb.float(), vb.float(), D, pa.HEAD_DIMS, "batchpack_attn")
    with pytest.raises(ValueError, match="nhd_with_g: width 96 is not a multiple of 64"):
        fa._check_layout(qb[..., :96], kb[..., :96], vb[..., :96], D, pa.HEAD_DIMS, "nhd_with_g")
    odd = torch.zeros((B, S, HD + 4), dtype=bf)[..., :HD]
    with pytest.raises(ValueError, match="kblock_attn: q rows must be 16-byte aligned"):
        fa._check_layout(odd, kb, vb, D, pa.HEAD_DIMS, "kblock_attn")

    _softmax_checks()


def test_probe_tools_run_plain_on_cpu(capsys, monkeypatch):
    """The port's attention probes with ``--device cpu``, their SDXL shapes
    cut to 1/16 of the sequence: K1's plain version as "current", then
    every (bq, kb) tile of P2 and P3 (k-block tool) and every g of P4
    (lane-group tool), the plain versions, untimed; the no-max results lie
    within bf16 rounding of the exact softmax on these unit normal inputs,
    and the g sweep gives one result. Then the two softmax probes
    (``_softmax_tools_on_cpu``, below)."""
    from imagharmony_tpu_torch.probes import _attn, probe_attn_kblock, probe_attn_lanegroup

    small = [(b, s // 16, hd, label) for b, s, hd, label in _attn.KBLOCK_SHAPES]
    monkeypatch.setattr(_attn, "KBLOCK_SHAPES", small)
    monkeypatch.setattr(_attn, "LANEGROUP_SHAPES", small[::-1])
    results = probe_attn_kblock.main(["--device", "cpu"])
    assert len(results) == 2 * (len(pa.BQS) * len(pa.kbs(D)) + 1)
    lanes = probe_attn_lanegroup.main(["--device", "cpu"])
    assert len(lanes) == 4 + 2
    text = capsys.readouterr().out
    assert text.count("the plain versions, not timed") == 2 and "current (K1)" in text
    assert "maxdiff vs first=0.0e+00" in text
    assert all(r["time"] is None and r["maxdiff"] < 2e-2 for r in results + lanes)

    _softmax_tools_on_cpu(capsys)


# --- P5-P6 on the CPU: the softmax recipes, as parts of the tests above ---------


def _xla_cpu_exp2(x):
    """XLA:CPU's exp2 of a bf16 argument: exp(bf16(x * bf16(ln 2))), which
    reproduces ``jnp.exp2`` of bf16 values there on every one of 10^5
    arguments in [-30, 8]; bf16(ln 2) = 0.69140625."""
    ln2 = torch.tensor(0.69140625, dtype=torch.bfloat16)
    return torch.exp((x.to(torch.bfloat16) * ln2).float())


def _softmax_recipes_keep_probe_functions(q, k, v):
    """Each (no_max, mxu_sum) of P5 and each variant of P6 through the
    port's entry points on CPU tensors (the plain version) against its TPU
    kernel run as it is in Pallas TPU interpret mode, on ``_qkv``'s fp32
    seeded inputs.

    Tolerances. The recipes with an fp32 exp argument (P5 no_max "fp32",
    with and without the ones column) within 2e-5 absolute and relative:
    the logits, exp2 and sums are fp32 on both sides. The recipes with a
    bf16 argument cannot be held that tightly on the CPU, for two reasons.
    A bf16 argument turns a one-ulp difference in the fp32 logits (another
    order of the products' sums) into a one-ulp difference of the argument,
    up to a few percent in e. And XLA:CPU's bf16 ``exp2`` is not correctly
    rounded: it computes exp(bf16(x * bf16(ln 2))), off the correctly
    rounded exp2 on 83% of arguments in [-30, 8], by up to 12%. So the
    bf16-argument recipes lie within 2e-2 of the output's largest magnitude
    with the plain version as it is (exp2 correctly rounded, as the card
    computes it; 1.75% seen at most), and within 1e-2 of it with XLA:CPU's
    exp2 put in the plain version's place, which leaves only the first
    cause (0.5% seen at most, P6 v0, whose bf16(1 / sum) can flip for a
    whole row). XLA:CPU's bf16 ``exp`` is torch's, bit for bit, so P6 v0
    and v1 need no such replacement.

    P5's base recipe and P6 v2 are one function: the two Pallas kernels
    give the same bits, and so do the port's two entry points.

    Then the clamp at 80 log2(e), as P2's at 115: logits of 185 on 4096
    keys saturate, so e = 2^115.5 (bf16 argument) or 2^115.416 (fp32) on
    every key; their sum, under 2^128, stays finite, so v = 1 gives exactly
    1 and v = 2 overflows the PV sum to inf; the max-subtract recipes give
    2. No launch is counted."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    nomax, tricks = _probe("probe_softmax_nomax"), _probe("probe_softmax_tricks")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = t(q), t(k), t(v)
    before = dict(ps.launches)
    cases = [(recipe, lambda no_max=no_max, mxu_sum=mxu_sum: nomax.run_variant(
                  jq, jk, jv, SCALE, D, no_max=no_max, mxu_sum=mxu_sum),
              lambda no_max=no_max, mxu_sum=mxu_sum: ps.softmax_nomax(
                  tq, tk, tv, SCALE, D, no_max=no_max, mxu_sum=mxu_sum))
             for (no_max, mxu_sum), recipe in ps.NOMAX.items()]
    cases += [(recipe, lambda variant=variant: tricks.run_variant(jq, jk, jv, SCALE, D, variant),
               lambda variant=variant: ps.softmax_tricks(tq, tk, tv, SCALE, D, variant))
              for variant, recipe in ps.TRICKS.items()]
    refs, outs = [], []
    for recipe, pallas, port in cases:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(pallas(), np.float32)
        out = port()
        assert out.shape == (B, S, HD) and out.dtype == torch.float32, recipe
        refs.append(ref)
        outs.append(out)
        if recipe.startswith("clamp_fp32"):
            close(out, ref, **TOL)
            continue
        top = float(np.abs(ref).max())
        if recipe not in ("max_exp", "norm_first"):  # the exp2 recipes
            assert np.abs(out.numpy() - ref).max() <= 2e-2 * top, recipe
            with pytest.MonkeyPatch.context() as m:
                m.setattr(torch, "exp2", _xla_cpu_exp2)
                out = port()
        assert np.abs(out.numpy() - ref).max() <= 1e-2 * top, recipe

    base, v2 = list(ps.NOMAX.values()).index("max_exp2"), len(ps.NOMAX) + 2
    assert np.array_equal(refs[base], refs[v2]) and torch.equal(outs[base], outs[v2])
    assert ps.launches == before

    # bf16, as on the card: logits 64 * 4 * bf16(4 * scale * log2(e)) = 185
    qc = torch.full((1, 4096, D), 4.0, dtype=torch.bfloat16)
    ones = torch.ones_like(qc)
    for no_max in (True, "fp32"):
        for mxu_sum in (False, True):
            assert torch.equal(ps.softmax_nomax(qc, qc, ones, SCALE, D, no_max=no_max,
                                                mxu_sum=mxu_sum), ones)
            assert torch.isinf(ps.softmax_nomax(qc, qc, 2 * ones, SCALE, D, no_max=no_max,
                                                mxu_sum=mxu_sum)).all()
    assert torch.equal(ps.softmax_nomax(qc, qc, 2 * ones, SCALE, D, no_max=False,
                                        mxu_sum=True), 2 * ones)
    for variant in ps.TRICKS:
        assert torch.equal(ps.softmax_tricks(qc, qc, 2 * ones, SCALE, D, variant), 2 * ones)


def _softmax_checks():
    """What P5's and P6's entry points do not take raises on either device
    before any library loads (the caller makes loading one fail): a head
    dim, a width that is not a whole number of heads, a ``no_max``,
    ``mxu_sum``, ``variant`` or recipe the probes do not have."""
    q = torch.zeros((B, S, HD))
    for case, call in {
        "head_dim_40": lambda: ps.softmax_nomax(q[..., :240], q[..., :240], q[..., :240],
                                                SCALE, 40, no_max=True, mxu_sum=False),
        "width_not_heads": lambda: ps.softmax_tricks(q[..., :96], q[..., :96], q[..., :96],
                                                     SCALE, D, 1),
        "no_max_bf16": lambda: ps.softmax_nomax(q, q, q, SCALE, D, no_max="bf16",
                                                mxu_sum=False),
        "mxu_sum_2": lambda: ps.softmax_nomax(q, q, q, SCALE, D, no_max=True, mxu_sum=2),
        "variant_3": lambda: ps.softmax_tricks(q, q, q, SCALE, D, 3),
        "recipe": lambda: ps.softmax_recipe_plain(q, q, q, SCALE, D, recipe="max_exp3"),
    }.items():
        with pytest.raises(ValueError):
            call()


def _softmax_tools_on_cpu(capsys):
    """The port's softmax probes with ``--device cpu`` at the shapes the
    caller cut: K1's plain version as "current", every (no_max, mxu_sum) of
    P5 against its base recipe and every variant of P6 against the exact
    attention in fp32, the plain versions, untimed; on these unit normal
    inputs every recipe lies within bf16 rounding of the base and of the
    exact softmax."""
    from imagharmony_tpu_torch.probes import _attn, probe_softmax_nomax, probe_softmax_tricks

    p5 = probe_softmax_nomax.main(["--device", "cpu"])
    p6 = probe_softmax_tricks.main(["--device", "cpu"])
    shapes = len(_attn.KBLOCK_SHAPES)
    assert len(p5) == shapes * len(ps.NOMAX) and len(p6) == shapes * len(ps.TRICKS)
    text = capsys.readouterr().out
    assert text.count("the plain versions, not timed") == 2
    assert text.count("current (K1)") == 2 * shapes
    assert text.count("no_max=False mxu_sum=0: not timed maxerr_vs_base=0.00e+00") == shapes
    assert text.count("maxerr vs fp32 exact=") == shapes * len(ps.TRICKS)
    assert all(r["time"] is None and r["maxdiff"] < 2e-2 for r in p5 + p6)


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_nomax_attention_matches_plain(cuda):
    """The kernel against its plain version on the card (bf16 inputs, the
    plain version in fp32 from them; gate max abs <= 2e-2 and cosine >=
    0.9999), at both SDXL shapes' short one, a ragged S and kv_len < S (at
    head dim 64 with the last key tile part masked, and at head dims 32 and
    128); P3 and P4 bit for bit equal to P2 at the same tiles, and two P2
    calls on the same inputs at a shape with more work items than SMs; the
    clamp and the overflow kept (v = 1: exactly 1; v = 2: inf), and a row
    whose every e lies below 2^-126 giving NaN, as the TPU kernel; the launch
    counts; what the kernel does not take raising. Then P5's and P6's
    recipes (``_cuda_softmax_recipes``, below)."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    for k in pa.launches:
        pa.launches[k] = 0
    def check(out, q, k, v, d, kv_len, kb, where):
        ref = pa.nomax_attn_plain(q.float(), k.float(), v.float(), d**-0.5, d,
                                  kv_len=kv_len, kb=kb)
        diff = (out.float() - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(out.double().flatten(),
                                                    ref.double().flatten(), dim=0).item()
        assert diff <= 2e-2 and cos >= 0.9999, (where, diff, cos)

    for b, s, heads, d, kv_len in [(2, 1024, 20, 64, None), (2, 333, 4, 64, None),
                                   (2, 1024, 20, 64, 777), (1, 300, 2, 32, 211),
                                   (2, 200, 2, 128, 129)]:
        q, k, v = rnd(b, s, 3 * heads * d).chunk(3, dim=-1)
        scale, kb0 = d**-0.5, pa.default_kb(d)
        if kv_len is not None:
            out = pa.nhd_with_g(q, k, v, scale, d, kv_len, d)
            check(out, q, k, v, d, kv_len, kb0, (b, s, heads, d, kv_len))
            continue
        for bq in pa.BQS:
            for kb in pa.kbs(d):
                out = pa.kblock_attn(q, k, v, scale, d, bq, kb)
                check(out, q, k, v, d, None, kb, (b, s, heads, d, bq, kb))
        p2 = pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, kb0)
        assert torch.equal(pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, kb0), p2)
        assert torch.equal(pa.batchpack_attn(q, k, v, scale, d), p2)
        for g in range(d, heads * d + 1, d):
            if (heads * d) % g == 0:
                assert torch.equal(pa.nhd_with_g(q, k, v, scale, d, s, g), p2), g
    assert min(pa.launches.values()) > 0

    q = torch.full((1, 4096, 64), 4.0, device=cuda, dtype=torch.bfloat16)
    ones = torch.ones_like(q)
    assert torch.equal(pa.kblock_attn(q, q, ones, 0.125, 64, 128, 128), ones)
    assert torch.isinf(pa.kblock_attn(q, q, 2 * ones, 0.125, 64, 128, 128)).all()
    qt, kt, vt = _subnormal_e(gen, cuda)
    for bq in pa.BQS:
        assert torch.isnan(pa.kblock_attn(qt, kt, vt, 0.125, 64, bq, 128)).all(), bq

    n = dict(pa.launches)
    with pytest.raises(TypeError):
        pa.kblock_attn(q.float(), q.float(), q.float(), 0.125, 64, 128, 128)
    with pytest.raises(ValueError):
        pa.kblock_attn(q, q, q, 0.125, 64, 256, 128)
    assert pa.launches == n

    _cuda_softmax_recipes(cuda)


def _subnormal_e(gen, cuda):
    """(q, k, v) at (1, 1024, 2 * 64) whose scaled logits all lie in (-129,
    -127) (scale 0.125), so that every e of the clamp recipes lies below
    2^-126. The kernel flushes such e to 0, as the TPU kernels' f32
    arithmetic does: each row sums to 0, and its output is 0 / 0 = NaN, the
    TPU kernel's result. (The plain versions keep subnormals and give
    finite values here.)"""
    q = torch.full((1, 1024, 128), 4.0, device=cuda, dtype=torch.bfloat16)
    k = (-2.765625 + 0.03 * torch.randn((1, 1024, 128), generator=gen, device=cuda)).to(q.dtype)
    v = torch.randn((1, 1024, 128), generator=gen, device=cuda).to(q.dtype)
    qs = (q[0, 0, 0].float() * (0.125 * fa._LOG2E)).to(q.dtype).float()
    logits = qs * k.float().view(1, 1024, 2, 64).sum(dim=-1)
    assert (logits > -129).all() and (logits < -127).all()
    return q, k, v


def _cuda_softmax_recipes(cuda):
    """Each recipe's kernel, through P5's and P6's entry points, against its
    plain version on the card (bf16 inputs, the plain version in fp32 from
    them; P2's gate: max abs <= 2e-2 and cosine >= 0.9999), at the short
    SDXL shape, a ragged S and head dims 32 and 128; P5's base and P6 v2
    bit for bit; P5's fp32 clamp recipe at P2's clamp bit for bit P2; the
    saturation and overflow kept, and the clamp recipes' NaN on rows whose
    every e lies below 2^-126; two calls of P6 v0 (a statistics pass,
    then PV) on the same inputs bit for bit; the launch counts."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name in ps.launches:
        ps.launches[name] = 0
    calls = {recipe: (lambda q, k, v, s, d, n=no_max, m=mxu_sum: ps.softmax_nomax(
        q, k, v, s, d, no_max=n, mxu_sum=m)) for (no_max, mxu_sum), recipe in ps.NOMAX.items()}
    calls.update({recipe: (lambda q, k, v, s, d, n=variant: ps.softmax_tricks(q, k, v, s, d, n))
                  for variant, recipe in ps.TRICKS.items() if recipe not in calls})
    for b, s, heads, d in [(2, 1024, 20, 64), (2, 333, 4, 64), (1, 300, 2, 32), (2, 200, 2, 128)]:
        q, k, v = torch.randn((b, s, 3 * heads * d), generator=gen,
                              device=cuda).to(torch.bfloat16).chunk(3, dim=-1)
        scale = d**-0.5
        for recipe, call in calls.items():
            out = call(q, k, v, scale, d)
            ref = ps.softmax_recipe_plain(q.float(), k.float(), v.float(), scale, d,
                                          recipe=recipe)
            diff = (out.float() - ref).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(out.double().flatten(),
                                                        ref.double().flatten(), dim=0).item()
            assert diff <= 2e-2 and cos >= 0.9999, (recipe, b, s, heads, d, diff, cos)
        assert torch.equal(ps.softmax_nomax(q, k, v, scale, d, no_max=False, mxu_sum=False),
                           ps.softmax_tricks(q, k, v, scale, d, 2))
        assert torch.equal(ps.softmax_tricks(q, k, v, scale, d, 0),
                           ps.softmax_tricks(q, k, v, scale, d, 0))
        p2 = pa.kblock_attn(q, k, v, scale, d, pa.DEFAULT_BQ, pa.default_kb(d))
        with pytest.MonkeyPatch.context() as m:
            m.setattr(ps, "CLAMP", pa.CLAMP)
            assert torch.equal(ps.softmax_nomax(q, k, v, scale, d, no_max="fp32",
                                                mxu_sum=False), p2)
    assert min(ps.launches.values()) > 0
    qt, kt, vt = _subnormal_e(gen, cuda)
    for recipe, call in calls.items():
        if recipe.startswith("clamp"):
            assert torch.isnan(call(qt, kt, vt, 0.125, 64)).all(), recipe

    qc = torch.full((1, 4096, 64), 4.0, device=cuda, dtype=torch.bfloat16)
    ones = torch.ones_like(qc)
    for no_max in (True, "fp32"):
        for mxu_sum in (False, True):
            assert torch.equal(ps.softmax_nomax(qc, qc, ones, 0.125, 64, no_max=no_max,
                                                mxu_sum=mxu_sum), ones)
            assert torch.isinf(ps.softmax_nomax(qc, qc, 2 * ones, 0.125, 64, no_max=no_max,
                                                mxu_sum=mxu_sum)).all()
    for variant in ps.TRICKS:
        assert torch.equal(ps.softmax_tricks(qc, qc, 2 * ones, 0.125, 64, variant), 2 * ones)

    n = dict(ps.launches)
    with pytest.raises(TypeError):
        ps.softmax_tricks(qc.float(), qc.float(), qc.float(), 0.125, 64, 1)
    assert ps.launches == n

"""P2-P4, the no-max attention of the attention probes (imagharmony_tpu_torch/
kernels/probe_attention.py), and the port's attention probe tools
(imagharmony_tpu_torch/probes/probe_attn_kblock.py, probe_attn_lanegroup.py).

On the CPU: the plain version ``nomax_attn_plain``, through each entry
point, against the TPU kernels run unchanged in Pallas TPU interpret mode
(``kblock_attn`` and ``batchpack_attn`` of tools/probe_attn_kblock.py,
``nhd_with_g`` of tools/probe_attn_lanegroup.py), a clamped case where it
keeps the TPU kernels' saturation and not the exact softmax, the entry
points' checks, and the two probe tools with ``--device cpu``.

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): the kernel
against its plain version under the three schedules, the schedules bit
for bit against each other, the clamp and the overflow kept. The machine
with the card has no JAX, so this module imports JAX only inside the tests
that compare with it; run the card's tests there with

    python -m pytest tests/test_torch_probe_attention.py -m cuda --noconftest -p no:cacheprovider
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.kernels import flash_attention as fa
from imagharmony_tpu_torch.kernels import probe_attention as pa
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


def test_schedule_and_layout_checks(monkeypatch):
    """A tile, head dim, g or kv_len the kernel is not built for raises on
    either device, before any library loads (here on CPU tensors, whose
    plain version would compute any of them). The CUDA path's operand
    checks (``flash_attention._check_layout`` at P2-P4's head dims, naming
    the entry point that was called) refuse another dtype, a width that is
    not a whole number of heads and rows that break the TMA's 16-byte rule,
    and take row-strided column views of one packed qkv tensor."""
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


def test_probe_tools_run_plain_on_cpu(capsys, monkeypatch):
    """The port's attention probes with ``--device cpu``, their SDXL shapes
    cut to 1/16 of the sequence: K1's plain version as "current", then
    every (bq, kb) tile of P2 and P3 (k-block tool) and every g of P4
    (lane-group tool), the plain versions, untimed; the no-max results lie
    within bf16 rounding of the exact softmax on these unit normal inputs,
    and the g sweep gives one result."""
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


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_nomax_attention_matches_plain(cuda):
    """The kernel against its plain version on the card (bf16 inputs, the
    plain version in fp32 from them; gate max abs <= 2e-2 and cosine >=
    0.9999), at both SDXL shapes' short one, a ragged S and kv_len < S,
    head dims 32 and 128; P3 and P4 bit for bit equal to P2 at the same
    tiles; the clamp and the overflow kept (v = 1: exactly 1; v = 2: inf);
    the launch counts; what the kernel does not take raising."""
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
                                   (1, 300, 2, 32, 211), (2, 200, 2, 128, 129)]:
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
        assert torch.equal(pa.batchpack_attn(q, k, v, scale, d), p2)
        for g in range(d, heads * d + 1, d):
            if (heads * d) % g == 0:
                assert torch.equal(pa.nhd_with_g(q, k, v, scale, d, s, g), p2), g
    assert min(pa.launches.values()) > 0

    q = torch.full((1, 4096, 64), 4.0, device=cuda, dtype=torch.bfloat16)
    ones = torch.ones_like(q)
    assert torch.equal(pa.kblock_attn(q, q, ones, 0.125, 64, 128, 128), ones)
    assert torch.isinf(pa.kblock_attn(q, q, 2 * ones, 0.125, 64, 128, 128)).all()

    n = dict(pa.launches)
    with pytest.raises(TypeError):
        pa.kblock_attn(q.float(), q.float(), q.float(), 0.125, 64, 128, 128)
    with pytest.raises(ValueError):
        pa.kblock_attn(q, q, q, 0.125, 64, 256, 128)
    assert pa.launches == n

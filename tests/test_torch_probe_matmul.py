"""P1, the matmul probe's plain product (imagharmony_tpu_torch/kernels/
probe_matmul.py), and the port's matmul probe tool
(imagharmony_tpu_torch/probes/probe_pallas_matmul.py).

On the CPU: P1's plain version against the TPU kernel of
tools/probe_pallas_matmul.py (``pallas_mm``) run unchanged in Pallas TPU
interpret mode, in fp32, bf16 and int8; the entry point's CPU path; the
wrapper's checks; the probe tool with ``--device cpu``.

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): P1 against
its plain version in both pairs. The machine with the card has no JAX, so
this module imports JAX only inside the tests that compare with it; run the
card's tests there with

    python -m pytest tests/test_torch_probe_matmul.py -m cuda --noconftest -p no:cacheprovider
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.kernels import probe_matmul as pm
from torch_port_util import TOL, close, cuda, randn, t  # noqa: F401  (cuda is a fixture)

TOOLS = Path(__file__).resolve().parent.parent / "tools"

# the probe at a small size: (M, K, N), blocks of 128
M, K, N, BLOCK = 256, 128, 256, 128


def _probe():
    """tools/probe_pallas_matmul.py as a module (the directory is not a
    package)."""
    spec = importlib.util.spec_from_file_location("_probe_pallas_matmul",
                                                  TOOLS / "probe_pallas_matmul.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(pair):
    rng = np.random.default_rng(3)
    if pair == "int8":
        return (rng.integers(-127, 128, (M, K)).astype(np.int8),
                rng.integers(-127, 128, (K, N)).astype(np.int8))
    return randn(0, M, K), randn(1, K, N)


def test_plain_matches_pallas_mm():
    """``probe_mm_plain`` against the probe's ``pallas_mm`` run as it is in
    Pallas TPU interpret mode, on seeded inputs, in each pair: fp32 in and
    out with fp32 accumulation (the algorithm; tolerance 2e-5 absolute and
    relative), bf16 in and out with fp32 accumulation (within 2e-2 of the
    output's largest magnitude: a bf16 rounding of the output on each side,
    a step apart at most), int8 in and int32 out with int32 accumulation
    (exact, element for element, through the entry point ``probe_mm``).
    The pairs are one test, not three cases: the suite's collected count
    decides how its xdist workers share the JAX pipeline tests (see
    ROADMAP C)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    for pair, (jdt, acc, out) in {"fp32": (jnp.float32, jnp.float32, jnp.float32),
                                  "bf16": (jnp.bfloat16, jnp.float32, jnp.bfloat16),
                                  "int8": (jnp.int8, jnp.int32, jnp.int32)}.items():
        x, w = _inputs(pair)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(_probe().pallas_mm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), BLOCK,
                                                BLOCK, out, acc))
        assert ref.shape == (M, N), pair
        if pair == "fp32":
            close(pm.probe_mm_plain(t(x), t(w), out_dtype=torch.float32), ref, **TOL)
        elif pair == "bf16":
            xb, wb = (t(a).to(torch.bfloat16) for a in (x, w))
            got = pm.probe_mm(xb, wb, out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            ref = ref.astype(np.float32)
            close(got, ref, rtol=0, atol=2e-2 * float(np.abs(ref).max()))
        else:
            got = pm.probe_mm(t(x), t(w), out_dtype=torch.int32)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)


# (error or None, _check_layout's arguments) of each case
def _layout_cases():
    bf, i8 = torch.bfloat16, torch.int8
    x, w = torch.zeros(4, 64, dtype=bf), torch.zeros(64, 32, dtype=bf)
    xq, wq = torch.zeros(4, 64, dtype=i8), torch.zeros(64, 32, dtype=i8)
    return {
        "accepted_bf16": (None, (x, w, bf)),
        "accepted_int8": (None, (xq, wq, torch.int32)),
        "fp32": (TypeError, (x.float(), w.float(), torch.float32)),
        "mixed_dtypes": (TypeError, (x, wq, bf)),
        "int8_to_bf16": (TypeError, (xq, wq, bf)),
        "bf16_to_fp32": (TypeError, (x, w, torch.float32)),
        "inner_mismatch": (ValueError, (x[:, :48], w, bf)),
        "bf16_k_not_multiple_of_8": (ValueError, (x[:, :60], w[:60], bf)),
        "int8_k_not_multiple_of_16": (ValueError, (xq[:, :56], wq[:56], torch.int32)),
        "int8_n_not_multiple_of_16": (ValueError, (xq, torch.zeros(64, 40, dtype=i8),
                                                   torch.int32)),
        "weight_row_stride": (ValueError, (x, torch.zeros(64, 36, dtype=bf)[:, :32], bf)),
        "transposed_weight": (ValueError, (x, torch.zeros(32, 64, dtype=bf).t(), bf)),
    }


def test_cpu_path_and_layout_checks(monkeypatch):
    """On CPU tensors ``probe_mm`` is ``probe_mm_plain`` and launches
    nothing. What P1 does not take raises in ``_check_layout`` (which runs
    on tensors of any device) before any library loads: another type pair
    than bf16 -> bf16 and int8 -> int32, shapes that do not chain, rows that
    break the TMA's 16-byte rule (K or N not a whole number of 16-byte
    units, a row stride that is not, a W that is not row-major); the entry
    point raises on the pair on the CPU too. What P1 takes passes."""
    rng = np.random.default_rng(5)
    xq = t(rng.integers(-128, 128, (64, 32)).astype(np.int8))
    wq = t(rng.integers(-128, 128, (32, 48)).astype(np.int8))
    before = pm.launches
    got = pm.probe_mm(xq, wq, out_dtype=torch.int32)
    assert torch.equal(got, torch.as_tensor(xq.numpy().astype(np.int64)
                                            @ wq.numpy().astype(np.int64)).to(torch.int32))
    xb, wb = t(randn(0, 8, 16)).bfloat16(), t(randn(1, 16, 24)).bfloat16()
    assert torch.equal(pm.probe_mm(xb, wb, out_dtype=torch.bfloat16),
                       pm.probe_mm_plain(xb, wb, out_dtype=torch.bfloat16))
    assert pm.launches == before

    def no_library(name):
        raise AssertionError(f"a library was loaded: {name}")

    monkeypatch.setattr(pm.build, "load", no_library)
    for case, (err, args) in _layout_cases().items():
        if err is None:
            pm._check_layout(*args)
            continue
        with pytest.raises(err):
            pm._check_layout(*args)
        if err is TypeError:
            with pytest.raises(TypeError):
                pm.probe_mm(args[0], args[1], out_dtype=args[2])


def test_probe_tool_runs_plain_on_cpu(capsys, monkeypatch):
    """The port's matmul probe with ``--device cpu``, its SDXL shapes cut to
    1/8 of every size: every shape in both pairs and both GEGLU shapes,
    the plain versions, untimed; P1's int8 product equals the library's;
    the lines say so."""
    from imagharmony_tpu_torch.probes import probe_pallas_matmul as tool

    for attr in ("SHAPES", "GEGLU_SHAPES"):
        monkeypatch.setattr(tool, attr, [(m // 8, k // 8, n // 8, label)
                                         for m, k, n, label in getattr(tool, attr)])
    results = tool.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "the plain versions, not timed" in text
    assert len(results) == len(tool.SHAPES) + len(tool.GEGLU_SHAPES)
    assert all(r["int8_equal"] for r in results[:len(tool.SHAPES)])
    assert all(r["bf16"] is None for r in results[:len(tool.SHAPES)])
    assert text.count("equal True") == len(tool.SHAPES)


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_probe_mm_matches_plain(cuda):
    """P1 against its plain version on the card: bf16 at an SDXL shape and
    at ragged ones (M, N past a tile, K past a 64-column panel; gate cosine
    >= 0.9999 and max abs <= 1e-2 of the reference's max), int8 element
    for element at the same shapes (N a multiple of 16), the launch count,
    and what the kernel does not take raising before any launch. ``plan``
    must cut the long-K (2048, 5120, 1280) along K in both pairs;
    (4000, 200, 4104) has more ragged tiles than the card has SMs, so a
    persistent CTA walks several. Two calls on the same inputs give the
    same bits."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    split = (2048, 5120, 1280)
    cases = [(8192, 640, 5120), (300, 144, 200), (77, 136, 456), split, (300, 200, 456),
             (4000, 200, 4104)]
    pm.launches = 0
    for m, k, n in cases:
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=cuda).to(torch.bfloat16)
        if (m, k, n) == split:
            assert pm.plan(x, w, out_dtype=torch.bfloat16)["split_tiles"] > 0
        out = pm.probe_mm(x, w, out_dtype=torch.bfloat16)
        assert torch.equal(out, pm.probe_mm(x, w, out_dtype=torch.bfloat16)), (m, k, n)
        torch.cuda.synchronize()
        ref = pm.probe_mm_plain(x, w, out_dtype=torch.float32)
        diff = (out.float() - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(out.double().flatten(),
                                                    ref.double().flatten(), dim=0).item()
        assert diff <= 1e-2 * ref.abs().max().item() and cos >= 0.9999, (m, k, n, diff, cos)
        n16 = -(-n // 16) * 16
        xq = torch.randint(-128, 128, (m, -(-k // 16) * 16), generator=gen, device=cuda,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (xq.shape[1], n16), generator=gen, device=cuda,
                           dtype=torch.int8)
        if (m, k, n) == split:
            assert pm.plan(xq, wq, out_dtype=torch.int32)["split_tiles"] > 0
        got = pm.probe_mm(xq, wq, out_dtype=torch.int32)
        assert torch.equal(got, pm.probe_mm(xq, wq, out_dtype=torch.int32)), (m, k, n)
        assert torch.equal(got, pm.probe_mm_plain(xq, wq, out_dtype=torch.int32)), (m, k, n)
    assert pm.launches == 4 * len(cases)
    x = torch.zeros((64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        pm.probe_mm(x.float(), x.float(), out_dtype=torch.float32)
    with pytest.raises(ValueError):
        pm.probe_mm(x[:, :60], x[:60], out_dtype=torch.bfloat16)
    assert pm.launches == 4 * len(cases)

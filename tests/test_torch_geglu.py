"""K5, the fused GEGLU projection (imagharmony_tpu_torch/kernels/geglu.py).

On the CPU: K5's plain version against each TPU kernel of the GEGLU probes
(tools/probe_geglu_v2.py, probe_geglu_epilogue.py, probe_geglu_tune.py,
probe_pallas_matmul.py) run unchanged in Pallas TPU interpret mode, against
the JAX model's ``nn.layers.geglu`` in fp32 and under its bf16 policy,
``GEGLUFn``'s gradients against ``jax.grad`` of it, and the wrapper's
checks.

On a card (tests marked ``cuda``, taking the ``cuda`` fixture): K5 against
its plain version at an SDXL shape and at ragged ones, each gelu, and a
gradient through it. The machine with the card has no JAX, so this module
imports JAX only inside the tests that compare with it; run the card's
tests there with

    python -m pytest tests/test_torch_geglu.py -m cuda --noconftest -p no:cacheprovider
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from imagharmony_tpu_torch.kernels import geglu as kg
from torch_port_util import TOL, close, cuda, randn, t  # noqa: F401  (cuda is a fixture)

TOOLS = Path(__file__).resolve().parent.parent / "tools"

# the probes at a small size: (M, K, inner), blocks of 128
M, K, INNER, BLOCK = 256, 128, 256, 128


def _probe(name):
    """tools/<name>.py as a module (the directory is not a package)."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interleaved(wh, wg, bn):
    """probe_geglu_v2's packed weight (its main, :91-94): per bn-column tile
    j, wh's tile then wg's tile."""
    k, inner = wh.shape
    wp = np.empty((k, 2 * inner), np.float32)
    for j in range(inner // bn):
        wp[:, j * 2 * bn: j * 2 * bn + bn] = wh[:, j * bn:(j + 1) * bn]
        wp[:, j * 2 * bn + bn: (j + 1) * 2 * bn] = wg[:, j * bn:(j + 1) * bn]
    return wp


def _run_probe(case, x, wh, wg):
    import jax.numpy as jnp

    xj, whj, wgj = (jnp.asarray(a) for a in (x, wh, wg))
    if case.startswith("v2_packed"):
        bn = 2 * BLOCK if case.endswith("bn256") else BLOCK
        return _probe("probe_geglu_v2").geglu_packed(
            xj, jnp.asarray(_interleaved(wh, wg, bn)), INNER, BLOCK, bn)
    if case.startswith("epilogue_"):
        mod = _probe("probe_geglu_epilogue")
        epi = getattr(mod, "epi_" + case[len("epilogue_"):])
        return mod.geglu(xj, whj, wgj, epi, bm=BLOCK, bn=BLOCK)
    if case.startswith("tune_"):
        return _probe("probe_geglu_tune").pallas_geglu(xj, whj, wgj, BLOCK, BLOCK,
                                                       case == "tune_m_fast")
    return _probe("probe_pallas_matmul").pallas_geglu(xj, whj, wgj, BLOCK, BLOCK)


# probe case -> the gelu of K5 that computes the same function (the probes'
# Abramowitz-Stegun erf is within 1.5e-7 of erf: their "erf" is K5's)
PROBES = {
    "v2_packed": "tanh",
    "v2_packed_bn256": "tanh",
    "epilogue_tanh_f32": "tanh",
    "epilogue_as_f32": "erf",
    "epilogue_none": "none",
    "epilogue_tanh_bf16": "tanh",
    "epilogue_as_bf16": "erf",
    "tune_n_fast": "erf",
    "tune_m_fast": "erf",
    "matmul": "erf",
}


@pytest.mark.parametrize("case", list(PROBES))
def test_plain_matches_probe_kernels(case):
    """``geglu_plain`` against each of the four GEGLU probe kernels and each
    of their variants (the packed weight interleaved at two tile widths, the
    five epilogues, both grid orders), run as they are in Pallas TPU
    interpret mode on seeded fp32 inputs. The probes take the weight as
    (K, inner) halves; K5 as diffusers' (2*inner, K). Tolerance 2e-5
    absolute and relative: the products are fp32 on both sides and the A-S
    erf is within 1.5e-7 of erf. The two bf16 epilogues compute the same
    function rounded to bf16 on the way (h, g and the gelu's terms), so
    they are held to 2e-2 of the output's largest magnitude: a few bf16
    steps."""
    from jax.experimental.pallas import tpu as pltpu

    x = randn(0, M, K)
    w = randn(1, K, 2 * INNER) * 0.1
    wh, wg = w[:, :INNER], w[:, INNER:]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_run_probe(case, x, wh, wg), np.float32)
    assert ref.shape == (M, INNER)
    out = kg.geglu_plain(t(x), t(np.ascontiguousarray(w.T)), None, gelu=PROBES[case])
    if case.endswith("_bf16"):
        close(out, ref, rtol=0, atol=2e-2 * float(np.abs(ref).max()))
    else:
        close(out, ref, **TOL)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_matches_jax_geglu(precision, with_bias):
    """``geglu_plain`` with and without a bias against the JAX model's
    ``geglu`` (two dots, bias, gelu), fp32 with the exact gelu at the
    per-module tolerance, and under the JAX bf16 policy with the tanh gelu
    against the port in bf16. There the two round at other places (JAX adds
    the bias to a bf16 product, F.linear adds it before rounding), so the
    bound is 2e-2 of the output's largest magnitude: a few bf16 steps."""
    import jax.numpy as jnp

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.nn import layers as jl

    x, w, b = randn(2, 3, 40, 64), randn(3, 64, 2 * 96) * 0.2, randn(4, 2 * 96)
    params = {"weight": jnp.asarray(w)} | ({"bias": jnp.asarray(b)} if with_bias else {})
    policy = jdt.FP32 if precision == "fp32" else jdt.DEFAULT
    ref = np.asarray(jl.geglu(params, jnp.asarray(x), policy=policy), np.float32)
    dt = torch.float32 if precision == "fp32" else torch.bfloat16
    out = kg.geglu_plain(t(x).to(dt), t(np.ascontiguousarray(w.T)).to(dt),
                         t(b).to(dt) if with_bias else None,
                         gelu="erf" if precision == "fp32" else "tanh")
    if precision == "fp32":
        close(out, ref)
    else:
        close(out, ref, rtol=0, atol=2e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("gelu", ["erf", "tanh", "none"])
def test_geglu_fn_grads_match_jax(gelu):
    """``GEGLUFn``'s dx, dW and db (its plain backward) against ``jax.grad``
    of the JAX ``geglu`` in fp32 (``approximate`` set to the gelu; for
    "none" the same two dots and bias with h * g), for a loss sum(out * c)
    with a seeded c, at 2e-5. Only the inputs that need a gradient get
    one."""
    import jax
    import jax.numpy as jnp

    from imagharmony_tpu import dtypes as jdt
    from imagharmony_tpu.nn import layers as jl

    x, w, b = randn(5, 2, 24, 48), randn(6, 48, 2 * 64) * 0.2, randn(7, 2 * 64)
    c = randn(8, 2, 24, 64)

    def loss(xx, ww, bb):
        if gelu == "none":
            h, g = jnp.split(xx @ ww + bb, 2, axis=-1)
            out = h * g
        else:
            out = jl.geglu({"weight": ww, "bias": bb}, xx, policy=jdt.FP32,
                           approximate=gelu == "tanh")
        return jnp.sum(out * c)

    refs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, w, b)))
    xt, wt, bt = (t(a).requires_grad_() for a in (x, np.ascontiguousarray(w.T), b))
    out = kg.geglu(xt, wt, bt, gelu=gelu)
    assert out.grad_fn is not None
    (out * t(c)).sum().backward()
    close(xt.grad, refs[0])
    close(wt.grad.t(), refs[1])
    close(bt.grad, refs[2])
    # a frozen weight and no bias: only dx
    xt.grad = None
    wf = t(np.ascontiguousarray(w.T))
    (kg.geglu(xt, wf, None, gelu=gelu) * t(c)).sum().backward()
    assert wf.grad is None and xt.grad is not None


def _layout(case):
    """(error or None, _check_layout's arguments) of one layout case."""
    bf = torch.bfloat16
    x, w, b = torch.zeros(4, 64, dtype=bf), torch.zeros(2 * 32, 64, dtype=bf), \
        torch.zeros(2 * 32, dtype=bf)
    return {
        "accepted": (None, (x.view(2, 2, 64), w, b, "tanh")),
        "fp32": (TypeError, (x.float(), w.float(), None, "tanh")),
        "odd_weight_rows": (ValueError, (x, w[:63], None, "tanh")),
        "k_not_multiple_of_8": (ValueError, (x[:, :60], w[:, :60], None, "tanh")),
        "inner_not_multiple_of_8": (ValueError, (x, torch.zeros(2 * 36, 64, dtype=bf), None,
                                                "tanh")),
        "weight_row_stride": (ValueError, (x, torch.zeros(64, 68, dtype=bf)[:, :64], None,
                                           "erf")),
        "unknown_gelu": (ValueError, (x, w, b, "sigmoid")),
        "bias_length": (ValueError, (x, w, b[:32], "tanh")),
        "x_width": (ValueError, (x[:, :32], w, b, "tanh")),
    }[case]


@pytest.mark.parametrize("case", ["accepted", "fp32", "odd_weight_rows", "k_not_multiple_of_8",
                                  "inner_not_multiple_of_8", "weight_row_stride",
                                  "unknown_gelu", "bias_length", "x_width"])
def test_layout_checks(case):
    """What the CUDA kernel does not take raises in ``_check_layout`` before
    any library loads (it runs on tensors of any device): another dtype, a
    weight of odd rows, rows that break the TMA's 16-byte rule (K or inner
    not a multiple of 8, a row stride that is not), an unknown gelu, a bias
    of another length, x of another width. What K5 takes passes."""
    err, args = _layout(case)
    if err is None:
        kg._check_layout(*args)
    else:
        with pytest.raises(err):
            kg._check_layout(*args)


def test_profile_edit_splits_elementwise():
    """``utils/profile_edit.elementwise_op`` names the operation of PyTorch's
    elementwise kernels (GEGLU's gelu and multiply among them) from the
    names the profiler gives them, and K5's own kernel has its class."""
    from imagharmony_tpu_torch.utils import profiling
    from imagharmony_tpu_torch.utils.profile_edit import elementwise_op

    vec = "void at::native::vectorized_elementwise_kernel<4, "
    names = {
        vec + "at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, "
              "at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >(int, "
              "at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, "
              "at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul>)":
            "MulFunctor",
        vec + "at::native::(anonymous namespace)::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
              "at::native::GeluType)::{lambda()#2}::operator()() const::{lambda()#4}::operator()"
              "() const::{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >(int, ...)":
            "GeluCUDAKernelImpl",
        vec + "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, "
              "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)":
            "CUDAFunctor_add",
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::rsqrt_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}>(...)":
            "rsqrt_kernel_cuda",
        "void at::native::vectorized_elementwise_kernel<4>(int)":
            "void at::native::vectorized_elementwise_kernel<4>",
    }
    for name, op in names.items():
        assert profiling.kernel_class(name) == "elementwise"
        assert elementwise_op(name) == op
    assert profiling.kernel_class("void (anonymous namespace)::geglu_wgmma_kernel<64, 1>("
                                  "GegluMaps, GegluArgs)") == "K5"


# --- on the card ---------------------------------------------------------------


def _card_case(cuda, m, k, inner, seed=0, bias=True):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(torch.bfloat16)

    return rnd(m, k), rnd(2 * inner, k, scale=k**-0.5), rnd(2 * inner) if bias else None


@pytest.mark.cuda
def test_cuda_geglu_matches_plain(cuda):
    """K5 against its plain version computed in fp32 from the same bf16
    inputs: SDXL's (8192, 640, 2560) with its bias and the tanh gelu, then
    ragged M and inner (past a 128-row and a 128- and 64-column tile, K not
    a multiple of 64) with each gelu, with and without a bias, x as a
    (B, S, K) tensor. Gate: cosine >= 0.9999 and max abs <= 1e-2 of the
    reference's max (bf16 rounding of the output). ``plan`` must cut
    (2048, 5120, 1280) along K ([h | g] summed before the gelu) and no other
    case: not (128, 1280, 5120), the UNet's long-K shape (its split cost
    more than it saved);
    (300, 200, 456) and (4000, 200, 4104) are ragged, the latter with more
    tiles than the card has SMs, so a persistent CTA walks several. Two
    calls on the same inputs give the same bits. Then the launch counter,
    the checks that raise before any launch, and a gradient through K5
    (``GEGLUFn``: K5 forward, plain backward) against fp32 autograd of the
    plain version."""
    cases = [(8192, 640, 2560, "tanh", True), (300, 200, 200, "tanh", True),
             (300, 200, 200, "erf", False), (77, 136, 456, "none", True),
             (128, 1280, 5120, "tanh", True), (300, 200, 456, "erf", True),
             (4000, 200, 4104, "tanh", True), (2048, 5120, 1280, "tanh", True)]
    kg.geglu_launches = 0
    for m, k, inner, gelu, bias in cases:
        x, w, b = _card_case(cuda, m, k, inner, bias=bias)
        split = kg.plan(x, w, gelu=gelu)["split_tiles"]
        assert split > 0 if (m, k, inner) == (2048, 5120, 1280) else split == 0, (m, k, inner)
        out = kg.geglu(x.view(1, m, k), w, b, gelu=gelu)
        assert torch.equal(out, kg.geglu(x.view(1, m, k), w, b, gelu=gelu)), (m, k, inner, gelu)
        torch.cuda.synchronize()
        ref = kg.geglu_plain(x.float(), w.float(), None if b is None else b.float(), gelu=gelu)
        assert out.shape == (1, m, inner) and out.dtype == torch.bfloat16
        diff = (out[0].float() - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(out.double().flatten(),
                                                    ref.double().flatten(), dim=0).item()
        assert diff <= 1e-2 * ref.abs().max().item() and cos >= 0.9999, (m, k, inner, gelu,
                                                                          diff, cos)
    assert kg.geglu_launches == 2 * len(cases)
    x, w, b = _card_case(cuda, 64, 64, 64)
    with pytest.raises(TypeError):
        kg.geglu(x.float(), w.float(), None, gelu="tanh")
    with pytest.raises(ValueError):
        kg.geglu(x[:, :60], w[:, :60], b, gelu="tanh")
    assert kg.geglu_launches == 2 * len(cases)

    x, w, b = _card_case(cuda, 1024, 640, 2560, seed=1)
    dout = torch.randn((1024, 2560), device=cuda).to(torch.bfloat16)
    leaves = [a.detach().requires_grad_() for a in (x, w, b)]
    kg.geglu(*leaves, gelu="tanh").backward(dout)
    assert kg.geglu_launches == 2 * len(cases) + 1
    refs = [a.float().detach().requires_grad_() for a in (x, w, b)]
    kg.geglu_plain(*refs, gelu="tanh").backward(dout.float())
    for got, ref in zip(leaves, refs):
        cos = torch.nn.functional.cosine_similarity(got.grad.double().flatten(),
                                                    ref.grad.double().flatten(), dim=0).item()
        assert cos >= 0.999, cos

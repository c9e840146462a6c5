"""K1 and its backward K3 (imagharmony_tpu_torch/kernels/flash_attention.py).

On the CPU: the plain versions against the JAX package's Pallas
``flash_attention_nhd`` (and its custom_vjp backward) run in interpret mode
(Sk >= 512, where the JAX kernel accepts the shape), the autograd Function's
plumbing, and the wrapper's routing. On a card (tests marked ``cuda``,
taking the ``cuda`` fixture): the CUDA kernels against the plain versions;
they skip without one. The machine with the card has no
JAX, so this module imports JAX only inside the tests that compare with it;
run the card's tests there with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import threading

import pytest
import torch

from imagharmony_tpu_torch.kernels import build
from imagharmony_tpu_torch.kernels import flash_attention as fa
from torch_port_util import close, cuda, randn, t  # noqa: F401  (cuda is a fixture)


@pytest.fixture()
def jfa(monkeypatch):
    """The JAX package's kernel module, in Pallas interpret mode."""
    from imagharmony_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jfa, "_INTERPRET", True)
    return jfa


@pytest.mark.parametrize("s,heads,d", [(512, 2, 64), (512, 4, 32), (600, 2, 64)],
                         ids=["d64", "d32", "odd_s600"])
def test_plain_matches_pallas_interpret(jfa, s, heads, d):
    """fp32, at the per-module tolerance: in fp32 the Pallas kernel's
    clamped no-max exp2 softmax and the true softmax agree to ~1e-6 at
    these inputs."""
    import jax.numpy as jnp

    q, k, v = (randn(i, 1, s, heads * d) for i in range(3))
    ref = jfa.flash_attention_nhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  scale=d**-0.5, head_dim=d)
    assert ref is not None
    out = fa.flash_attention_nhd_plain(t(q), t(k), t(v), scale=d**-0.5, head_dim=d)
    close(out, ref)


def test_bwd_plain_matches_pallas_interpret_vjp(jfa):
    """K3's plain version against ``jax.vjp`` of the JAX
    ``flash_attention_nhd`` in Pallas interpret mode (its backward runs
    ``_attn_bwd_kernel``), and against torch.autograd of the plain forward,
    fp32, at the shape of tests/test_flash_attention.py's
    test_nhd_gradient_parity. Tolerance 1e-4 absolute and relative: fp32
    sums in another order, and the Pallas kernel's no-max exp clamped at
    80 is exact at these logits."""
    import jax
    import jax.numpy as jnp

    heads, d, s, sk = 2, 64, 256, 512
    q, k, v = randn(10, 1, s, heads * d), randn(11, 1, sk, heads * d), randn(12, 1, sk, heads * d)
    g = randn(13, 1, s, heads * d)
    kw = dict(scale=d**-0.5, head_dim=d)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_nhd(q, k, v, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    out = fa.flash_attention_nhd_bwd_plain(t(q), t(k), t(v), t(g), **kw)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention_nhd_plain(tq, tk, tv, **kw).backward(t(g))
    for o, r, a in zip(out, ref, (tq.grad, tk.grad, tv.grad)):
        close(o, r, rtol=1e-4, atol=1e-4)
        close(o, a, rtol=1e-4, atol=1e-4)


def test_function_on_cpu_matches_autograd_of_plain():
    """The autograd Function on CPU tensors: its gradients equal autograd
    through the plain forward, its lse equals torch.logsumexp of the logits
    (times log2(e)), and q/k/v given as column views of one packed tensor
    get the gradients of contiguous copies. fp32, tolerance 1e-5."""
    heads, d = 2, 32
    kw = dict(scale=d**-0.5, head_dim=d)
    qkv = t(randn(14, 2, 70, 3 * heads * d)).requires_grad_()
    q, k, v = qkv.chunk(3, dim=-1)
    g = t(randn(15, 2, 70, heads * d))
    out = fa.flash_attention_nhd(q, k, v, **kw)
    assert out.grad_fn is not None and "FlashAttnNHD" in type(out.grad_fn).__name__
    out.backward(g)
    ref_in = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_nhd_plain(*ref_in, **kw).backward(g)
    close(qkv.grad, torch.cat([x.grad for x in ref_in], dim=-1), rtol=1e-5, atol=1e-5)

    _, lse = fa.flash_attention_nhd_fwd(q.detach(), k.detach(), v.detach(), **kw)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.detach().reshape(2, 70, heads, d),
                          k.detach().reshape(2, 70, heads, d)) * kw["scale"]
    close(lse, torch.logsumexp(logits, dim=-1) * 1.4426950408889634, rtol=1e-5, atol=1e-5)
    assert lse.shape == (2, heads, 70)

    with torch.no_grad():  # no gradient needed: no Function, no grad_fn
        assert fa.flash_attention_nhd(q, k, v, **kw).grad_fn is None


def test_wrapper_routes_cpu_to_plain_and_takes_strided_slices():
    """A CPU tensor takes the plain version (no launch counted); q/k/v as
    column views of one packed (B, S, 3*H*D) tensor give the result of
    contiguous copies. And the cost the kernels declare (kernels/cost.py):
    ``profiling.compiled_stats`` of a CPU call counts the plain version's
    products, which equal what the kernel declares on a card for K1, K4,
    K2 (text + IP keys) and K5, 10/11 of K3's declared 11·b·h·sq·sk·d for
    the plain backward, and nothing is declared on the CPU; a declaration
    reaches every open count, from any thread, and none outside one; a
    forward and backward through K1's autograd Function counts the plain
    lse's product and the plain backward's five; ``(x @ x).sum()`` at
    64² counts 2·64³ flops, within 1% of the JAX package's
    ``compiled_stats`` (its reduction included), with no peak on the
    CPU."""
    qkv = t(randn(3, 2, 70, 3 * 2 * 32))
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride(1) == 3 * 2 * 32
    before = fa.launches
    out = fa.flash_attention_nhd(q, k, v, scale=32**-0.5, head_dim=32)
    assert fa.launches == before
    ref = fa.flash_attention_nhd_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=32**-0.5, head_dim=32)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert out.shape == (2, 70, 64) and out.is_contiguous()

    from imagharmony_tpu_torch.kernels import cost
    from imagharmony_tpu_torch.kernels import cross_attention as ca
    from imagharmony_tpu_torch.kernels import geglu as kg
    from imagharmony_tpu_torch.utils import profiling

    def flops(fn):
        with cost.counting() as declared:
            stats = profiling.compiled_stats(fn)
        assert declared.flops == 0 and stats["peak_temp_bytes"] is None
        return stats["flops"]

    kw = dict(scale=32**-0.5, head_dim=32)
    assert flops(lambda: fa.flash_attention_nhd(q, k, v, **kw)) == cost.attention(
        2, 2, 70, 70, 32, 2)[0]
    qh, kh, vh, gh = (t(randn(i, 2, 3, n, 40)) for i, n in ((4, 50), (5, 30), (6, 30), (7, 50)))
    assert flops(lambda: fa.flash_attention(qh, kh, vh, scale=0.1)) == cost.attention(
        2, 3, 50, 30, 40, 2)[0]
    assert 11 * flops(lambda: fa.flash_attention_bwd_plain(qh, kh, vh, gh, scale=0.1)) == \
        10 * cost.attention_bwd(2, 3, 50, 30, 40, 2)[0]
    kip, vip = t(randn(8, 2, 4, 64)), t(randn(9, 2, 4, 64))
    assert flops(lambda: ca.flash_cross_nhd(q, k[:, :9], v[:, :9], k_ip=kip, v_ip=vip,
                                            ip_scale=0.5, **kw)) == \
        cost.cross(2, 2, 70, 9, 4, 32, 2)[0]
    x, w, b = t(randn(10, 2, 6, 48)), t(randn(11, 2 * 24, 48)), t(randn(12, 2 * 24))
    assert flops(lambda: kg.geglu(x, w, b, gelu="tanh")) == cost.geglu(12, 48, 24)[0]

    # a backward through K1's autograd Function: the plain forward with the
    # lse (4 + 2 products of b·h·sq·sk·d) and the plain backward (10); on a
    # card K1 declares 4 and K3 11, one b·h·sq·sk·d less
    x1 = cost.attention(2, 2, 70, 70, 32, 2)[0] // 4
    qg = q.detach().requires_grad_()
    assert flops(lambda: fa.flash_attention_nhd(qg, k, v, **kw).sum().backward()) == 16 * x1
    assert cost.attention(2, 2, 70, 70, 32, 2)[0] + cost.attention_bwd(
        2, 2, 70, 70, 32, 2)[0] == 15 * x1

    cost.declare("K1", 1, 2, 3)  # no count open: nothing to add to
    with cost.counting() as outer, cost.counting() as inner:
        cost.declare("K1", 5, 6, 7)
    assert outer == inner == cost.Count(5, 6, 7, {"K1": 5}, {"K1": 1})
    # a count takes what other threads declare (the autograd engine runs a
    # CUDA backward, K3 and the checkpointed reruns, on threads of its own)
    with cost.counting() as outer:
        with cost.counting() as inner:
            worker = threading.Thread(target=cost.declare, args=("K3", 11, 12, 13))
            worker.start()
            worker.join()
        cost.declare("K1", 5, 6, 7)
    assert inner == cost.Count(11, 12, 13, {"K3": 11}, {"K3": 1})
    assert outer == cost.Count(16, 18, 20, {"K3": 11, "K1": 5}, {"K3": 1, "K1": 1})
    assert not cost.active()

    import jax.numpy as jnp
    from imagharmony_tpu.utils import profiling as jprofiling

    stats = profiling.compiled_stats(lambda x: (x @ x).sum(), torch.ones(64, 64))
    want = jprofiling.compiled_stats(lambda x: (x @ x).sum(), jnp.ones((64, 64)))["flops"]
    assert stats["flops"] == 2 * 64**3 and abs(stats["flops"] - want) <= 0.01 * want, want
    assert stats["peak_temp_bytes"] is None


def test_wrapper_raises_off_cpu_and_cuda():
    q = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_nhd(q, q, q, scale=0.125, head_dim=64)


def test_library_path_is_keyed_by_source():
    """The built library's name carries a hash of the source and the flags,
    so an edited source rebuilds instead of loading a stale library."""
    for name in ("flash_attn_nhd", "flash_attn_nhd_bwd"):
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == build.library_path(name)
    assert build.library_path("flash_attn_nhd") != build.library_path("flash_attn_nhd_bwd")


def test_library_path_hashes_the_headers(monkeypatch, tmp_path):
    """The sources include ``sm90_tiles.cuh``: editing a header changes the
    name of every library, so none loads stale."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = ("flash_attn_nhd", "flash_attn_nhd_bwd", "cross_attn_nhd")
    before = [build.library_path(n) for n in names]
    header = tmp_path / "sm90_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build.library_path(n) for n in names]
    assert all(a != b for a, b in zip(before, after))


def test_resource_usage_reads_ptxas_report(monkeypatch, tmp_path):
    """``build.resource_usage`` on a stand-in compiler that prints what
    ``nvcc -Xptxas -v`` prints: registers, shared memory, spills and
    whether ptxas serialized the wgmma products (its C7515 notice) per
    kernel, keyed by the kernel's name (demangled where c++filt exists)."""
    report = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3abc21attn_fwd_wgmma_kernelILi160ELi1EEEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc21attn_fwd_wgmma_kernelILi160ELi1EEEvPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 218 registers, used 1 barriers, 44544 bytes smem
ptxas info    : Compile time = 266.200 ms
ptxas info    : Compiling entry function '_ZN3abc20attn_bwd_prep_kernelEvPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc20attn_bwd_prep_kernelEvPKfi
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized \
due to non wgmma instructions defining accumulator registers of a wgmma between start and end of \
the pipeline stage in the function '_ZN3abc20attn_bwd_prep_kernelEvPKfi'
"""
    (tmp_path / "report.txt").write_text(report)
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'report.txt'} >&2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    usage = build.resource_usage("flash_attn_nhd")
    by_suffix = {("160" in k, "prep" in k): v for k, v in usage.items()}
    assert by_suffix[(True, False)] == {"registers": 218, "smem_bytes": 44544, "spill_bytes": 0,
                                        "wgmma_serialized": False}
    assert by_suffix[(False, True)] == {"registers": 32, "smem_bytes": 0, "spill_bytes": 20,
                                        "wgmma_serialized": True}
    fake.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    with pytest.raises(RuntimeError, match="boom"):
        build.resource_usage("flash_attn_nhd")


def test_misaligned_operands_raise_before_any_library(monkeypatch):
    """K1, K3 and K4 read their operands with TMA, which takes base addresses
    and strides that are multiples of 16 bytes: the layout checks raise on
    a base or a row stride that is not, before any library is built or
    loaded (the checks do not look at the device, so CPU tensors show it)."""
    import imagharmony_tpu_torch.nn.attention as pattn

    def refuse(name):
        raise AssertionError(f"a library was loaded: {name}")

    monkeypatch.setattr(build, "load", refuse)
    ok = torch.zeros((1, 8, 3 * 64), dtype=torch.bfloat16)
    fa._check_layout(*ok.chunk(3, dim=-1), 64, fa.HEAD_DIMS)
    shifted = torch.zeros((1, 8, 3 * 64 + 8), dtype=torch.bfloat16)[:, :, 1:1 + 3 * 64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_layout(*shifted.chunk(3, dim=-1), 64, fa.HEAD_DIMS)
    odd_rows = torch.zeros((1, 8, 3 * 64 + 2), dtype=torch.bfloat16)[:, :, :3 * 64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_layout(*odd_rows.chunk(3, dim=-1), 64, fa.BWD_HEAD_DIMS)
    views = [pattn.split_heads(x, 2) for x in shifted.chunk(3, dim=-1)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_bhsd_layout(*views)
    views = [pattn.split_heads(x, 2) for x in odd_rows.chunk(3, dim=-1)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_bhsd_layout(*views)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """bf16 kernel vs the fp32 plain version on the same bf16 inputs, passed
    as strided slices of one packed tensor, at each (S, H, D) below, batch 2
    (S=1000: ragged last tiles in both batches; S=256 with 20 heads: one
    warpgroup a CTA, S=4096: two). Tolerance: bf16 rounding of P and of the
    output. The call with the lse output gives the same output bit for bit
    and the plain lse within 2e-2 log2 units. Then 200 queries against 333
    keys, forward and K3 (tolerances as in the tests below). Then, where the
    machine has two cards, every kernel (K1 with its lse, K3, K4, K2 with
    the IP branch) on cuda:0 and then on cuda:1, each against its plain
    version: the libraries keep their state (shared-memory attribute, SM
    count, the thread's context) per device, so the second card's first
    launches work too."""
    for s, heads, d in [(1024, 20, 64), (1000, 2, 64), (64, 4, 32), (5, 3, 128), (256, 20, 64),
                        (300, 2, 128), (4096, 10, 64), (200, 3, 32)]:
        gen = torch.Generator(device=cuda).manual_seed(0)
        qkv = torch.randn((2, s, 3 * heads * d), generator=gen, device=cuda).to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        kw = dict(scale=d**-0.5, head_dim=d)
        before = fa.launches
        out = fa.flash_attention_nhd(q, k, v, **kw)
        out_lse, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launches == before + 2
        ref = fa.flash_attention_nhd_plain(q.float(), k.float(), v.float(), **kw)
        err = float((out.float() - ref).abs().max())
        cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0)
        assert err <= 2e-2 and float(cos) >= 0.9999, ((s, heads, d), err, float(cos))
        assert torch.equal(out, out_lse)
        assert float((lse - fa.lse_plain(q.float(), k.float(), **kw)).abs().max()) <= 2e-2
    # queries and keys of different lengths (the wrappers take them): K1 and K3
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 200, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = torch.randn((2, 333, 256), generator=gen, device=cuda).to(torch.bfloat16).chunk(2, -1)
    dout = torch.randn((2, 200, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kw = dict(scale=0.125, head_dim=64)
    out, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
    grads = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v, dout)]
    ref = fa.flash_attention_nhd_plain(*f32[:3], **kw)
    assert float((out.float() - ref).abs().max()) <= 2e-2
    for g, r in zip(grads, fa.flash_attention_nhd_bwd_plain(*f32, **kw)):
        _agree(g, r)
    if torch.cuda.device_count() >= 2:
        for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
            _every_kernel_on(dev)


def _every_kernel_on(dev):
    """K1 with its lse, K3, K4 and K2 with the IP branch on ``dev``, each
    against its plain version on the same inputs."""
    from imagharmony_tpu_torch.kernels import cross_attention as ca
    from imagharmony_tpu_torch.nn.attention import split_heads

    q, k, v, dout = _bf16_case(dev, 1, 1024, 10, 64)
    kw = dict(scale=0.125, head_dim=64)
    out, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
    grads = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
    qh, kh, vh = (split_heads(x, 8) for x in _bf16_case(dev, 2, 1000, 8, 40)[:3])
    k4 = fa.flash_attention(qh, kh, vh, scale=40**-0.5)
    q2, kt, vt, _ = _bf16_case(dev, 2, 300, 8, 40)
    kip, vip = (x[:, :4] for x in _bf16_case(dev, 2, 77, 8, 40)[:2])
    ckw = dict(scale=40**-0.5, head_dim=40, ip_scale=0.6)
    k2 = ca.flash_cross_nhd(q2, kt[:, :77], vt[:, :77], k_ip=kip, v_ip=vip, **ckw)
    torch.cuda.synchronize(dev)
    f32 = [x.float() for x in (q, k, v, dout)]
    assert float((out.float() - fa.flash_attention_nhd_plain(*f32[:3], **kw)).abs().max()) \
        <= 2e-2, dev
    for g, r in zip(grads, fa.flash_attention_nhd_bwd_plain(*f32, **kw)):
        _agree(g, r)
    ref4 = fa.flash_attention_plain(qh.float(), kh.float(), vh.float(), scale=40**-0.5)
    assert float((k4.float() - ref4).abs().max()) <= 2e-2, dev
    ref2 = ca.flash_cross_nhd_plain(q2.float(), kt[:, :77].float(), vt[:, :77].float(),
                                    k_ip=kip.float(), v_ip=vip.float(), **ckw)
    assert float((k2.float() - ref2).abs().max()) <= 2e-2, dev


def _bf16_case(cuda, b, s, heads, d, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * heads * d), generator=gen, device=cuda).to(torch.bfloat16)
    dout = torch.randn((b, s, heads * d), generator=gen, device=cuda).to(torch.bfloat16)
    return (*qkv.chunk(3, dim=-1), dout)


def _agree(out, ref, *, max_rel=2e-2, min_cos=0.9995):
    ref = ref.float()
    err = float((out.float() - ref).abs().max())
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.flatten(), dim=0)
    assert err <= max_rel * float(ref.abs().max()) and float(cos) >= min_cos, (err, float(cos))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,d", [(1, 1024, 10, 64), (2, 1000, 2, 64), (2, 64, 4, 32),
                                         (1, 5, 3, 32), (1, 256, 20, 64), (2, 77, 3, 40),
                                         (1, 300, 2, 80), (2, 200, 2, 128), (1, 130, 2, 160)])
def test_cuda_bwd_kernel_matches_plain(cuda, b, s, heads, d):
    """K3 on K1's layout, at every head dim it takes (fed by K1's lse where K1
    takes the head dim, else by the plain forward's), against the fp32 plain
    backward on the same bf16 inputs, q/k/v as strided slices: each of dq,
    dk, dv within 2e-2 of the reference's max-abs and at cosine >= 0.9995
    (bf16 rounding of P, dS and the outputs); a second call on the same
    inputs gives the same bits. K1's lse against the plain one at 2e-2 log2
    units: K1 rounds q*scale*log2(e) to bf16 (relative 2^-9), so a logit s
    of size ~5 carries ~1e-2 of error, in the forward as in this lse."""
    q, k, v, dout = _bf16_case(cuda, b, s, heads, d)
    kw = dict(scale=d**-0.5, head_dim=d)
    f32 = [x.float() for x in (q, k, v, dout)]
    ref_lse = fa.lse_plain(f32[0], f32[1], **kw)
    if d in fa.HEAD_DIMS:
        out, lse = fa.flash_attention_nhd_fwd(q, k, v, **kw)
        assert float((lse - ref_lse).abs().max()) <= 2e-2
    else:
        out, lse = fa.flash_attention_nhd_plain(q, k, v, **kw), ref_lse
    before = fa.bwd_launches
    grads = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_nhd_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    assert all(torch.equal(g, h) for g, h in zip(grads, again))
    for g, r in zip(grads, fa.flash_attention_nhd_bwd_plain(*f32, **kw)):
        _agree(g, r)


@pytest.mark.cuda
def test_cuda_gradient_goes_through_k3(cuda, monkeypatch):
    """A CUDA input that requires grad gets K1's output with a grad_fn; its
    backward launches K3 once, never the plain backward, and agrees with
    the plain backward."""
    q, k, v, dout = _bf16_case(cuda, 1, 256, 4, 64, seed=1)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    k1, k3 = fa.launches, fa.bwd_launches
    out = fa.flash_attention_nhd(*leaves, scale=0.125, head_dim=64)
    assert out.grad_fn is not None
    plain = fa.flash_attention_nhd_bwd_plain

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran on CUDA tensors")

    monkeypatch.setattr(fa, "flash_attention_nhd_bwd_plain", refuse)
    out.backward(dout)
    torch.cuda.synchronize()
    monkeypatch.setattr(fa, "flash_attention_nhd_bwd_plain", plain)
    assert (fa.launches, fa.bwd_launches) == (k1 + 1, k3 + 1)
    ref = plain(q.float(), k.float(), v.float(), dout.float(), scale=0.125, head_dim=64)
    for leaf, r in zip(leaves, ref):
        _agree(leaf.grad, r)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_nhd(x, x, x, scale=0.125, head_dim=64)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_nhd(xb, xb, xb, scale=0.125, head_dim=16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_nhd(xb, xb.cpu(), xb, scale=0.125, head_dim=64)
    # a gradient request at a head dim K1 and K3 do not take raises up front
    x16 = torch.zeros((1, 64, 128), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_nhd(x16, x16, x16, scale=0.25, head_dim=16)


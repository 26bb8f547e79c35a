"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the JAX kernel tests' own: 3e-5 in fp32, 2.5e-2 in bf16
for the forward, 2e-4 / 1e-3 for the backward's dq, dk and dv in fp32.
The plain version computes in fp32 from the same inputs; bf16 goes to the
sm90 kernels (tensor cores, P and dS as bf16 hi + lo pairs), fp32 to the
FMA kernels. In bf16 each O element is also held to 1e-4 + 1e-2 |O| (one
bf16 rounding is at most 2**-7 |O|) and the fp32 LSE to 1e-4, as
``chip_smoke.py`` does; a bf16 gradient element to 1e-2 |want| + 1e-3
max |want| beside the 2.5e-2 bound (the sums run over many more terms
than the forward's). The fused softmax
kernels take ``tests/test_kernels.py``'s: 1e-6 / 2e-2 for y, 1e-5 + 1e-4
|want| for dx in fp32; the pipelined step the flash arm's grad tolerance.
The rope kernel's forward equals its plain version bit for bit (the same
fp32 products, differences and one rounding); its backward rounds once
where the plain chain's autograd rounds each product, so it is held to a
float64 reference at the flash kernels' bf16 bars and to no larger an
error than the chain's.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rope as rp

# b, sq, sk, nq, nkv, hd, dtype, window, softcap, q_offset
CASES = [
    (2, 64, 64, 4, 2, 32, "float32", 0, 0.0, 0),
    (2, 64, 64, 4, 1, 32, "float32", 16, 0.0, 0),
    (1, 96, 96, 8, 8, 16, "float32", 0, 20.0, 0),
    (2, 64, 64, 4, 2, 32, "bfloat16", 0, 0.0, 0),
    (1, 40, 40, 2, 2, 64, "float32", 0, 0.0, 0),
    (1, 128, 128, 16, 4, 8, "float32", 32, 50.0, 0),
    (3, 32, 32, 2, 2, 128, "bfloat16", 8, 0.0, 0),
    (2, 24, 56, 4, 2, 32, "float32", 20, 0.0, 32),
    (1, 300, 300, 6, 2, 96, "bfloat16", 0, 0.0, 0),
    (1, 64, 64, 10, 1, 256, "float32", 16, 0.0, 0),     # head_dim 256: two
    (1, 24, 56, 16, 8, 256, "float32", 0, 50.0, 32),     # output passes
    (2, 40, 40, 4, 2, 256, "bfloat16", 0, 0.0, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset", CASES)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, nq, nkv, hd, dtype, window,
                                    softcap, q_offset):
    gen = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              return_lse=True)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    tol = 2.5e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=0)
    if dtype == "bfloat16":
        torch.testing.assert_close(out.float(), want_out.float(), atol=1e-4,
                                   rtol=1e-2)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_strided_inputs(cuda):
    """q/k/v as views of one fused projection (non-contiguous heads)."""
    gen = torch.Generator(cuda).manual_seed(1)
    qkv = torch.randn((2, 70, 3, 4, 64), generator=gen, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, want, atol=3e-5, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_wide_heads(cuda):
    q = torch.zeros((1, 8, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)


def _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, dtype, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    do = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    return q, k, v, do


def _assert_grad_close(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == "bfloat16":
        torch.testing.assert_close(g, w, atol=2.5e-2, rtol=0)
        bound = 1e-2 * w.abs() + 1e-3 * w.abs().max()
        assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())
    else:
        torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset", CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, sq, sk, nq, nkv, hd, dtype,
                                       window, softcap, q_offset):
    q, k, v, do = _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, dtype)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = (fa.flash_attention_bwd.dq_launches,
              fa.flash_attention_bwd.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for t, w, src in zip(got, want, (q, k, v)):
        assert t.dtype == src.dtype and t.shape == src.shape
        _assert_grad_close(t, w, dtype)


@pytest.mark.gpu
def test_flash_bwd_kernels_are_deterministic(cuda):
    """One block owns each output tile and no atomics are used: two runs
    give the same bits."""
    q, k, v, do = _bwd_inputs(cuda, 2, 300, 300, 8, 2, 64, "bfloat16", 3)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_flash_bwd_strided_inputs_through_autograd(cuda):
    """q/k/v as views of one fused projection, and the strided dO an
    einsum's backward hands over, through ops.flash_attention."""
    from repro_torch.kernels import ops
    gen = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn((2, 70, 3, 4, 64), generator=gen, device=cuda,
                      requires_grad=True)
    wo = torch.randn((4, 64, 16), generator=gen, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = torch.autograd.grad(torch.einsum(
        "bsnh,nhd->bsd", ops.flash_attention(q, k, v), wo).square().sum(), qkv)
    want = torch.autograd.grad(torch.einsum(
        "bsnh,nhd->bsd", ref.flash_attention_ref(q, k, v), wo).square().sum(),
        qkv)
    torch.testing.assert_close(got[0], want[0], atol=2e-4, rtol=1e-3)


@pytest.mark.gpu
def test_flash_bwd_rejects_wide_heads(cuda):
    q = torch.zeros((1, 8, 2, 264), device=cuda)
    lse = torch.zeros((1, 8, 2, 1), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)


# the fused softmax sweep of tests/test_kernels.py:94-99: shape, dtype,
# scale, causal; y to 1e-6 fp32 / 2e-2 bf16, dx to 1e-5 + 1e-4 |want| in
# fp32 and 2e-2 in bf16 (one bf16 rounding of an fp32 sum taken in another
# order), rows summing to 1 within 2e-2
# The bf16 (sm90) route's own cases, as chip_smoke.py's SM90_SWEEP: tiles
# cut by sq and sk (200; 24 queries over 56 keys at q_offset 32), GQA m 1,
# 2, 3, 4, 8, 10, head_dim 8 to 256 (past 128 the kernels run the output's
# head_dim in two passes), window and softcap.
# b, sq, sk, nq, nkv, hd, window, softcap, q_offset
SM90_CASES = [
    (2, 200, 200, 8, 8, 64, 0, 0.0, 0),
    (2, 24, 56, 8, 4, 32, 20, 0.0, 32),
    (1, 200, 200, 16, 4, 24, 0, 30.0, 0),
    (2, 24, 56, 16, 2, 128, 0, 0.0, 32),
    (1, 200, 200, 8, 1, 8, 50, 0.0, 0),
    (1, 300, 300, 6, 2, 96, 0, 0.0, 0),
    (1, 256, 256, 32, 4, 128, 64, 30.0, 0),
    (1, 130, 130, 4, 4, 96, 0, 20.0, 0),
    (1, 64, 64, 10, 1, 256, 32, 0.0, 0),       # recurrentgemma's heads
    (1, 130, 130, 16, 8, 256, 0, 50.0, 0),     # gemma2-9b's heads, softcap
    (2, 24, 56, 10, 1, 256, 20, 0.0, 32),
    (1, 100, 100, 4, 2, 200, 0, 20.0, 0),      # hd 200: chunks past hd
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,window,softcap,q_offset", SM90_CASES)
def test_sm90_forward_matches_plain_and_repeats(cuda, b, sq, sk, nq, nkv, hd,
                                                window, softcap, q_offset):
    q, k, v, _ = _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, "bfloat16", 4)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              return_lse=True)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    again = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=1e-4, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,window,softcap,q_offset", SM90_CASES)
def test_sm90_dq_matches_plain_and_repeats(cuda, b, sq, sk, nq, nkv, hd, window,
                                           softcap, q_offset):
    q, k, v, do = _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, "bfloat16", 5)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for t, w in zip(got, want):
        _assert_grad_close(t, w, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,window,softcap,q_offset", SM90_CASES)
def test_sm90_dkv_matches_plain_and_repeats(cuda, b, sq, sk, nq, nkv, hd, window,
                                            softcap, q_offset):
    """The bf16 dk/dv kernel: one launch a backward, dK and dV within the
    bf16 gradient bound, and two runs bit-equal (one block owns each key
    tile, no atomics)."""
    q, k, v, do = _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, "bfloat16", 6)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    assert fa._entry("dkv", q=q, k=k, v=v, dout=do) == "flash_attention_dkv_sm90"
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = fa.flash_attention_bwd.dkv_launches
    _, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    _, dk2, dv2 = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.dkv_launches == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _, want_dk, want_dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for t, w, src in ((dk, want_dk, k), (dv, want_dv, v)):
        assert t.dtype == src.dtype and t.shape == src.shape
        _assert_grad_close(t, w, "bfloat16")


@pytest.mark.gpu
def test_sm90_route_raises_before_launch_on_misaligned_strides(cuda):
    """TMA needs strides that are multiples of 16 bytes: a bf16 view with a
    68-element (136-byte) head stride is refused before any launch, while
    the FMA route takes an fp32 view with a 280-byte one."""
    qb = torch.randn((1, 16, 4, 68), device=cuda).to(torch.bfloat16)[..., :64]
    kb = torch.randn((1, 16, 4, 64), device=cuda).to(torch.bfloat16)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.dq_launches)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd(qb, kb, kb)
    out, lse = fa.flash_attention_fwd(qb.contiguous(), kb, kb, return_lse=True)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_bwd(qb, kb, kb, out, lse, out)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.dq_launches) \
        == (before[0] + 1, before[1])
    q = torch.randn((1, 16, 4, 70), device=cuda)[..., :64]
    k = torch.randn((1, 16, 4, 64), device=cuda)
    torch.testing.assert_close(fa.flash_attention_fwd(q, k, k),
                               ref.flash_attention_ref(q, k, k), atol=3e-5, rtol=0)


FS_CASES = [
    ((4, 64, 64), "float32", 1.0, False),
    ((2, 4, 32, 32), "bfloat16", 0.125, True),
    ((1, 8, 48, 48), "float32", 0.07, True),
    ((96, 128), "float32", 2.0, False),
    ((2, 3, 700, 700), "float32", 0.1, True),      # rows wider than 512
]
# the forward's instances, as chip_smoke.py's FS_ROWS: a warp a row in
# registers up to 4096 columns, with 16-byte accesses where sk allows them
# (200, 512, 2048, 4096) and scalar ones where it does not (1, 7, 513), and
# the online block kernel past 4096; causal scores are square
FS_CASES += [((((2, sk, sk) if sk <= 513 else (sk, sk)) if causal else (2, 33, sk)),
              dtype, 0.3, causal)
             for sk in (1, 7, 200, 512, 513, 2048, 4096, 8192)
             for causal in (False, True) for dtype in ("float32", "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,scale,causal", FS_CASES)
def test_fused_softmax_kernels_match_plain(cuda, shape, dtype, scale, causal):
    from repro_torch.kernels import fused_softmax as fs
    gen = torch.Generator(cuda).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=cuda) * 4).to(getattr(torch, dtype))
    dy = torch.randn(shape, generator=gen, device=cuda).to(x.dtype)
    before = (fs.fused_softmax_fwd.launches, fs.fused_softmax_bwd.launches)
    y = fs.fused_softmax_fwd(x, scale=scale, causal=causal)
    dx = fs.fused_softmax_bwd(y, dy, scale=scale)
    again = fs.fused_softmax_fwd(x, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert (fs.fused_softmax_fwd.launches, fs.fused_softmax_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    assert torch.equal(y, again)
    bf16 = dtype == "bfloat16"
    # bf16: the tests' 2e-2 and, element by element, one bf16 rounding of
    # y (1e-4 + 1e-2|y|) and of dx (1e-2|dx| + 1e-3 mean|dx|)
    want = ref.fused_softmax_ref(x, scale=scale, causal=causal).float()
    torch.testing.assert_close(y.float(), want, atol=2e-2 if bf16 else 1e-6, rtol=0)
    if bf16:
        torch.testing.assert_close(y.float(), want, atol=1e-4, rtol=1e-2)
    torch.testing.assert_close(y.float().sum(-1), torch.ones(shape[:-1], device=cuda),
                               atol=2e-2, rtol=0)
    want_dx = ref.fused_softmax_bwd_ref(y, dy, scale=scale).float()
    torch.testing.assert_close(dx.float(), want_dx, atol=2e-2 if bf16 else 1e-5,
                               rtol=0 if bf16 else 1e-4)
    if bf16:
        torch.testing.assert_close(dx.float(), want_dx, rtol=1e-2,
                                   atol=1e-3 * float(want_dx.abs().mean()))


@pytest.mark.gpu
def test_pipelined_step_on_the_card_matches_the_cpu(cuda):
    """The executor on the card (flash kernels, host_offload through pinned
    memory) against the same step on the CPU, at the flash arm's grad
    tolerance."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), num_layers=4,
                              dtype="float32", attn_impl="flash")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    spec = ScheduleSpec("1f1b", 4, 4, residency="host_offload")
    before = (rp.rope_fwd.launches, rp.rope_bwd.launches)
    got = PipelineExecutor(cfg, spec).step(
        T.tree_map(lambda t: t.to(cuda), params), {k: v.to(cuda) for k, v in batch.items()})
    # the rope kernel: one launch a direction a layer and microbatch
    assert (rp.rope_fwd.launches - before[0], rp.rope_bwd.launches - before[1]) \
        == (4 * 4, 4 * 4)
    want = PipelineExecutor(cfg, spec).step(params, batch)
    assert got.stats.offloads == got.stats.fetches > 0
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5
    for a, b in zip(T.leaves(got.grads), T.leaves(want.grads)):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=1e-3)


# b, s, nq, nkv, hd, layout, positions: granite-moe's 16/8 x 64, head_dim
# 128 and 256, decode's s 1, a sliced run's offset, int64 and per-row
# positions, q/k left strided by a transpose, a head_dim not a multiple of 16
# bytes' elements (scalar accesses) and views of one fused projection
ROPE_CASES = [
    (2, 64, 16, 8, 64, "contiguous", "arange"),
    (1, 48, 8, 2, 128, "contiguous", "arange"),
    (2, 16, 4, 1, 256, "contiguous", "arange"),
    (4, 1, 16, 8, 64, "contiguous", "decode"),
    (2, 40, 16, 8, 64, "contiguous", "offset"),
    (2, 33, 4, 2, 64, "contiguous", "int64"),
    (2, 24, 16, 8, 64, "transposed", "arange"),
    (2, 24, 4, 2, 12, "contiguous", "arange"),
    (2, 24, 4, 4, 128, "fused", "arange"),
]


def _rope_inputs(cuda, b, s, nq, nkv, hd, layout, positions, dtype, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    if layout == "fused":  # q and k as views of one (b, s, 2, heads, hd) tensor
        qk = torch.randn((b, s, 2, nq, hd), generator=gen, device=cuda).to(dt)
        q, k = qk[:, :, 0], qk[:, :, 1, :nkv]
    elif layout == "transposed":  # (b, heads, s, hd) seen as (b, s, heads, hd)
        q = torch.randn((b, nq, s, hd), generator=gen, device=cuda).to(dt).transpose(1, 2)
        k = torch.randn((b, nkv, s, hd), generator=gen, device=cuda).to(dt).transpose(1, 2)
    else:
        q = torch.randn((b, s, nq, hd), generator=gen, device=cuda).to(dt)
        k = torch.randn((b, s, nkv, hd), generator=gen, device=cuda).to(dt)
    if positions == "decode":
        pos = torch.full((b, 1), 1234, dtype=torch.int32, device=cuda)
    elif positions == "int64":
        pos = torch.randint(0, 32768, (b, s), generator=gen, device=cuda)
    else:
        off = 1024 if positions == "offset" else 0
        pos = (off + torch.arange(s, dtype=torch.int32, device=cuda))[None].expand(b, s)
    return q, k, pos


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nq,nkv,hd,layout,positions", ROPE_CASES)
def test_rope_kernel_forward_is_the_plain_version(cuda, b, s, nq, nkv, hd, layout,
                                                   positions, dtype):
    q, k, pos = _rope_inputs(cuda, b, s, nq, nkv, hd, layout, positions, dtype)
    for theta in (10_000.0, 1_000_000.0):
        freq = rp.freqs(theta, hd // 2, cuda)
        before = rp.rope_fwd.launches
        qo, ko = rp.rope_fwd(q, k, pos, freq)
        torch.cuda.synchronize()
        assert rp.rope_fwd.launches == before + 1
        assert qo.is_contiguous() and ko.is_contiguous()
        assert torch.equal(qo, ref.rope_ref(q, pos, freq))
        assert torch.equal(ko, ref.rope_ref(k, pos, freq))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nq,nkv,hd,layout,positions", ROPE_CASES)
def test_rope_kernel_backward_within_the_bars(cuda, b, s, nq, nkv, hd, layout,
                                              positions):
    """bf16 grads through ``ops.rope_qk`` (one launch a direction) against
    the float64 grads of the plain chain: within the flash kernels' bf16
    bars, no further than the chain's own bf16 grads, and equal bit for bit
    to the kernel's plain backward (``ref.rope_bwd_ref``)."""
    from repro_torch.kernels import ops
    theta = 10_000.0
    q, k, pos = _rope_inputs(cuda, b, s, nq, nkv, hd, layout, positions, "bfloat16")
    gen = torch.Generator(cuda).manual_seed(2)
    gq = torch.randn((b, s, nq, hd), generator=gen, device=cuda).to(torch.bfloat16)
    gk = torch.randn((b, s, nkv, hd), generator=gen, device=cuda).to(torch.bfloat16)
    freq = rp.freqs(theta, hd // 2, cuda)

    def grads(f, dtype):
        a = q.detach().to(dtype).requires_grad_(True)
        c = k.detach().to(dtype).requires_grad_(True)
        return torch.autograd.grad(f(a, c), (a, c), (gq.to(dtype), gk.to(dtype)))

    before = (rp.rope_fwd.launches, rp.rope_bwd.launches)
    got = grads(lambda a, c: ops.rope_qk(a, c, pos, theta), torch.bfloat16)
    torch.cuda.synchronize()
    assert (rp.rope_fwd.launches, rp.rope_bwd.launches) == (before[0] + 1, before[1] + 1)
    chain = grads(lambda a, c: (ref.rope_ref(a, pos, freq), ref.rope_ref(c, pos, freq)),
                  torch.bfloat16)
    want = grads(lambda a, c: (ref.rope_ref(a, pos, freq), ref.rope_ref(c, pos, freq)),
                 torch.float64)
    for g_, c_, w_, gin in zip(got, chain, want, (gq, gk)):
        _assert_grad_close(g_, w_, "bfloat16")
        err, chain_err = ((x.double() - w_).abs().max() for x in (g_, c_))
        assert err <= chain_err, (float(err), float(chain_err))
        assert torch.equal(g_, ref.rope_bwd_ref(gin, pos, freq))


@pytest.mark.gpu
def test_rope_qk_takes_the_kernel_once_a_direction(cuda):
    """``layers.rope_qk`` on CUDA tensors: one forward and one backward
    launch for q and k together, the plain chain's values forward."""
    from repro_torch.models import layers
    q, k, pos = _rope_inputs(cuda, 2, 32, 16, 8, 64, "contiguous", "arange", "bfloat16")
    q.requires_grad_(True)
    before = (rp.rope_fwd.launches, rp.rope_bwd.launches)
    qo, ko = layers.rope_qk(q, k, pos, 10_000.0)
    (qo.float().sum() + ko.float().sum()).backward()
    torch.cuda.synchronize()
    assert (rp.rope_fwd.launches, rp.rope_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(qo, layers.rope(q.detach(), pos, 10_000.0))
    assert torch.equal(ko, layers.rope(k, pos, 10_000.0))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [63, 264])
def test_rope_kernel_rejects_head_dims_before_launch(cuda, hd):
    q = torch.zeros((1, 4, 2, hd), device=cuda)
    freq = torch.zeros((hd // 2,), device=cuda)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    before = (rp.rope_fwd.launches, rp.rope_bwd.launches)
    with pytest.raises(ValueError, match="head_dim"):
        rp.rope_fwd(q, q, pos, freq)
    with pytest.raises(ValueError, match="head_dim"):
        rp.rope_bwd(q, q, pos, freq)
    from repro_torch.models import layers
    with pytest.raises(ValueError, match="head_dim"):  # no plain chain on the card
        layers.rope_qk(q, q, pos, 10_000.0)
    assert (rp.rope_fwd.launches, rp.rope_bwd.launches) == before

"""The port's fused scale-mask-softmax vs the JAX package's, on the CPU.

``repro.kernels.ops.fused_softmax`` runs its Pallas kernels in interpret
mode; the port's ``ops.fused_softmax`` takes its plain versions here (a CPU
tensor), which is what the CUDA kernels are held against on the card.
Inputs come from numpy seeds. Shapes, dtypes, scales and tolerances are
``tests/test_kernels.py``'s: y 1e-6 in fp32 and 2e-2 in bf16, grads atol
1e-5 / rtol 1e-4, the unfused chain 1e-2 from the fused op.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_softmax as fs
from repro_torch.kernels import ops, ref

CASES = [
    ((4, 64, 64), "float32", 1.0, False),
    ((2, 4, 32, 32), "bfloat16", 0.125, True),
    ((1, 8, 48, 48), "float32", 0.07, True),
    ((96, 128), "float32", 2.0, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads, and when several
    test workers share the cores, every process's BLAS threads waiting on
    each other make a run of small GEMMs minutes long."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 4).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("shape,dtype,scale,causal", CASES)
def test_forward_matches_jax(shape, dtype, scale, causal):
    jx, tx = _pair(_x(shape), dtype)
    want = jops.fused_softmax(jx, scale, causal, 16, True)
    got = ops.fused_softmax(tx, scale, causal)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got).sum(-1), np.ones(shape[:-1]), atol=2e-2)


# row lengths on each side of the CUDA forward's instance switches (a warp
# a row with 16-byte or scalar accesses, chip_smoke.py's FS_ROWS), at sizes
# the CPU takes quickly
ROW_CASES = [((2, sk, sk) if causal else (2, 3, sk), dtype, 0.3, causal)
             for sk in (1, 7, 200, 513) for causal in (False, True)
             for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("shape,dtype,scale,causal", ROW_CASES)
def test_forward_matches_jax_at_the_kernel_row_lengths(shape, dtype, scale, causal):
    jx, tx = _pair(_x(shape, 6), dtype)
    want = jops.fused_softmax(jx, scale, causal, 64, True)
    got = fs.fused_softmax_fwd(tx, scale=scale, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got).sum(-1), np.ones(shape[:-1]), atol=2e-2)


@pytest.mark.parametrize("shape,dtype,scale,causal", CASES)
def test_grad_matches_jax(shape, dtype, scale, causal):
    import jax
    a = _x(shape, 1)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jx, tx = _pair(a, dtype)
    jg, tg = _pair(g, dtype)
    _, vjp = jax.vjp(lambda x: jops.fused_softmax(x, scale, causal, 16, True), jx)
    want, = vjp(jg)
    x = tx.requires_grad_(True)
    got, = torch.autograd.grad(ops.fused_softmax(x, scale, causal), x, tg)
    if dtype == "bfloat16":
        tol = dict(atol=2e-2, rtol=0)   # one bf16 rounding of dx, as y's
    else:
        tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_grad_through_loss_matches_jax():
    """``tests/test_kernels.py::test_fused_softmax_grad_kernel``'s case."""
    import jax
    a = np.random.default_rng(3).standard_normal((2, 2, 16, 16)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(
        jops.fused_softmax(x, 0.5, True, 8, True) ** 2))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    got, = torch.autograd.grad((ops.fused_softmax(x, 0.5, True) ** 2).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_unfused_chain_matches_fused_and_jax():
    """The staged chain computes what the fused op does (only the kernel
    count differs, the paper's section 3.2 point), and what the JAX
    package's chain does."""
    jx, tx = _pair(_x((4, 32, 32), 4), "bfloat16")
    chain = ops.unfused_softmax_chain(tx, scale=0.3, causal=True)
    np.testing.assert_allclose(_np(chain), _np(ops.fused_softmax(tx, 0.3, True)),
                               atol=1e-2)
    np.testing.assert_allclose(
        _np(chain), _np(jops.unfused_softmax_chain(jx, scale=0.3, causal=True)),
        atol=1e-2)


def test_plain_versions_match_jax_reference():
    from repro.kernels import ref as jref
    a = _x((3, 24, 24), 5)
    for causal in (False, True):
        np.testing.assert_allclose(
            ref.fused_softmax_ref(torch.from_numpy(a), scale=0.2, causal=causal).numpy(),
            np.asarray(jref.fused_softmax_ref(jnp.asarray(a), scale=0.2, causal=causal)),
            atol=1e-6, rtol=0)


def test_causal_needs_square_scores():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(AssertionError, match="square"):
        ops.fused_softmax(x, 1.0, True)
    with pytest.raises(ValueError, match="square"):
        fs.fused_softmax_fwd(x, causal=True)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor takes the plain version; only a kernel launch counts."""
    before = (fs.fused_softmax_fwd.launches, fs.fused_softmax_bwd.launches)
    x = torch.randn(2, 8, 8, requires_grad=True)
    torch.autograd.grad(ops.fused_softmax(x, 0.5, True).sum(), x)
    assert (fs.fused_softmax_fwd.launches, fs.fused_softmax_bwd.launches) == before


def test_other_devices_raise():
    x = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.fused_softmax_fwd(x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.fused_softmax_bwd(x, x)

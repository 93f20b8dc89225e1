"""The GEMM's transposed operands and the embedding's gradient, on the card.

``matmul_cuda`` reads a transposed view (``x.t()`` of a row-major tensor, as
the GEMM's backward passes ``rhs^T`` and ``lhs2^T``) in place on its TMA path,
at every bf16 config, ring and persistent kernel alike; a bf16 backward on
that path copies nothing (``matmul.TRANSPOSE_COPIES``).  The embedding's
gradient (``layers.table_grad``) is bitwise repeatable on the card and within
1e-6 of the CPU's.  This file imports no JAX (the CPU tests that hold these
to the JAX package are ``test_torch_matmul.py`` and
``test_torch_embed_grad.py``).  Every test needs the card (``cuda`` marker)
and skips without one:

  python -m pytest -q tests/test_torch_gemm_card.py
"""
import pytest
import torch

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.models import layers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_transposed_views_match_plain_on_card(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n in [(4, 4096, 1024), (256, 1024, 512), (1024, 512, 4096)]:
        a = torch.randn(m, k, device=card, generator=g).bfloat16()
        b = torch.randn(k, n, device=card, generator=g).bfloat16()
        at, bt = a.t().contiguous().t(), b.t().contiguous().t()
        want = mm.matmul_plain(a, b).float()
        scale = want.abs().max()
        for cfg in mm.config_space():
            for side, (lhs, rhs) in {"lhs": (at, b), "rhs": (a, bt)}.items():
                mm.reset_launches()
                first, second = mm.matmul_cuda(lhs, rhs, cfg), mm.matmul_cuda(lhs, rhs, cfg)
                assert ((first.float() - want).abs().max() / scale).item() <= 1e-2, (cfg, m, k, n)
                assert torch.equal(first, second), cfg
                # read in place where a tensor map takes the view (m % 8 for a transposed lhs), else copied
                in_place = mm.tma_aligned(m, n, k, side == "lhs", side == "rhs", lhs.data_ptr(), rhs.data_ptr())
                assert mm.TRANSPOSED_READS[side] == 2 * in_place and sum(mm.TRANSPOSE_COPIES.values()) == 2 - 2 * in_place


@pytest.mark.cuda
def test_bf16_backward_reads_its_operands_in_place(card):
    """The backward's first CUDA work on autograd's device thread is a GEMM encoding
    tensor maps there (cuTensorMapEncodeTiled needs a context bound to that thread)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(8, 128, 4096, device=card, generator=g).bfloat16().requires_grad_(True)
    w = (torch.randn(4096, 1024, device=card, generator=g) * 4096 ** -0.5).bfloat16().requires_grad_(True)
    mm.reset_launches()
    out = ops.matmul(x, w)
    gy = torch.randn(out.shape, device=card, generator=g).bfloat16()
    gx, gw = torch.autograd.grad(out, (x, w), gy)
    torch.cuda.synchronize()
    assert mm.PATH_LAUNCHES["tma"] == 3 and sum(mm.TRANSPOSE_COPIES.values()) == 0
    assert mm.TRANSPOSED_READS == {"lhs": 1, "rhs": 1}
    want = torch.autograd.grad(mm.matmul_plain(x.reshape(-1, 4096), w).reshape(out.shape), (x, w), gy)
    for got, ref in zip((gx, gw), want):
        assert got.shape == ref.shape and ((got.float() - ref.float()).abs().max() / ref.float().abs().max()) <= 1e-2


@pytest.mark.cuda
def test_embedding_gradient_is_repeatable_on_card(card):
    g = torch.Generator(device="cpu").manual_seed(3)
    table = torch.randn(1000, 256, generator=g)
    tokens = torch.minimum(torch.randint(0, 40, (8, 128), generator=g) ** 2 // 40, torch.tensor(999))
    cot = torch.randn(8, 128, 256, generator=g)
    grads = []
    for dev in ("cuda", "cuda", "cpu"):
        w = table.to(dev).requires_grad_(True)
        out = layers.embed_tokens({"embed": w}, tokens.to(dev))
        (gw,) = torch.autograd.grad(out, w, cot.to(dev))
        grads.append(gw.cpu())
    assert torch.equal(grads[0], grads[1])
    assert ((grads[0] - grads[2]).abs().max() / grads[2].abs().max()).item() <= 1e-6

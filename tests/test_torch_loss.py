"""Every model class's ``loss_fn`` and gradients against the JAX package's.

Reduced granite-8b, qwen3-moe (the aux loss in the total), qwen2.5-32b
(seeded nonzero QKV biases), llama-3.2-vision (f32 image embeddings; the
pipeline's bf16 ones in a test of their own), rwkv6-7b, hymba-1.5b at 4
layers and seamless-m4t-large-v2, in f32 on the CPU on the same weights and
the same seeded pipeline batch: the loss, the metrics and every parameter's
gradient (``jax.value_and_grad(model.loss_fn)``) within 1e-4 relative to the
leaf's largest gradient.  On the CPU every GEMM under grad runs as the
``repro_torch::gemm`` op with the plain GEMM, so the backward formula the card
runs is the one checked here.

Also: remat ``"full"`` and ``"dots"`` equal to no remat, with the GEMMs each
launches counted by phase; a tied reduced config (the gradient reaches
``embed`` through the head); the GEMM op's ``gradcheck`` in f64; the
forward's selections equal to the reference's log; and the refusal of the
attention op under grad (the WKV / scan ops take their backward kernels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair, reduced_pair
from repro.configs import registry as jax_registry
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.kernels.matmul import DEFAULT_CONFIG as JAX_DEFAULT
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.core.runtime import KernelRuntime
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.weights import params_from_jax

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
CASES = {
    "granite-8b": None, "qwen3-moe-235b-a22b": None, "qwen2.5-32b": None, "llama-3.2-vision-90b": None,
    "rwkv6-7b": None, "hymba-1.5b": 4, "seamless-m4t-large-v2": None,
}


def _pair(arch: str):
    if registry.get(arch).qkv_bias:
        return model_pair(arch)
    return reduced_pair(arch, CASES.get(arch))


def _batches(cfg, image_f32: bool = True, batch: int = 2, seq: int = 16):
    """The same pipeline batch for both packages (a VLM's image embeddings
    widened to f32 in both when ``image_f32``)."""
    jb = JaxPipeline(cfg, JaxDataConfig(global_batch=batch, seq_len=seq)).device_batch(1)
    tb = TokenPipeline(cfg, DataConfig(global_batch=batch, seq_len=seq)).device_batch(1, device="cpu")
    if image_f32 and "image_embs" in jb:
        jb["image_embs"] = jb["image_embs"].astype(jnp.float32)
        tb["image_embs"] = tb["image_embs"].float()
    return jb, tb


def _flat(tree, prefix=""):
    return dict(adamw.trainable(tree, prefix))


def _port_grads(model, params, batch):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))


def _grads_close(got: dict, ref: dict, rtol: float = 1e-4, skip=()) -> None:
    ref = _flat(jax.tree.map(np.asarray, ref))
    assert set(got) == set(ref)
    for path, r in ref.items():
        if path in skip:
            continue
        scale = float(np.abs(r).max())
        assert scale > 0, f"{path}: the reference's gradient is zero"
        np.testing.assert_allclose(got[path].numpy(), r, rtol=rtol, atol=rtol * scale, err_msg=path)


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_every_gradient_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batches(tm.cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    loss, metrics, grads = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert set(metrics) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(metrics[key]), float(jmet[key]), **LOSS_TOL, err_msg=key)
    if tm.cfg.moe is not None:
        assert float(metrics["aux_loss"]) > 0
        np.testing.assert_allclose(float(loss), float(metrics["ce_loss"] + 0.01 * metrics["aux_loss"]), rtol=1e-6)
    _grads_close(grads, jgrads)


def test_vlm_bf16_image_embeddings_match_reference():
    """The pipeline's bf16 image embeddings, as both launchers train: the
    normalised embeddings round to bf16 before the cross GEMMs (the GEMM of
    two dtypes runs in f32 and rounds to the activation's bf16, as the
    reference's ``jnp.dot`` then ``astype``).  The gradients of the cross
    blocks' ``wk``, ``wv`` and ``ln_img`` flow back through those bf16
    values, whose cotangents both packages round to bf16: an f32 difference
    of one ulp can move one a bf16 step (2^-8), so those three leaves are
    held to 1e-2; every other to 1e-4."""
    jm, jp, tm, tp = reduced_pair("llama-3.2-vision-90b")
    jb, tb = _batches(tm.cfg, image_f32=False)
    assert tb["image_embs"].dtype == torch.bfloat16
    (jloss, _), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    loss, _, grads = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    bf16_fed = ("cross/attn/wk", "cross/attn/wv", "cross/ln_img")
    _grads_close(grads, jgrads, skip=bf16_fed)
    _grads_close({p: grads[p] for p in bf16_fed}, {"cross": {"attn": {"wk": jgrads["cross"]["attn"]["wk"],
                                                                     "wv": jgrads["cross"]["attn"]["wv"]},
                                                            "ln_img": jgrads["cross"]["ln_img"]}}, rtol=1e-2)


def _no_remat_loss(tm, params, batch):
    x, aux = tm._forward(params, batch["tokens"], image_embs=batch.get("image_embs"), remat=False)
    x = L.rms_norm(x, params["final_norm"], tm.cfg.norm_eps)
    loss = L.cross_entropy_loss(L.logits_from_hidden(params["emb"], x), batch["targets"], tm.cfg.vocab)
    return loss + 0.01 * aux if tm.is_moe else loss


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-235b-a22b", "llama-3.2-vision-90b"])
def test_remat_policies_equal_no_remat(arch):
    _, _, tm, tp = reduced_pair(arch)
    _, tb = _batches(tm.cfg)
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    results, counts = {}, {}
    try:
        for policy in ("none", "full", "dots"):
            ops.GRAD_GEMMS.clear()
            if policy == "none":
                loss = _no_remat_loss(tm, tp, tb)
            else:
                L.set_remat_policy(policy)
                loss = tm.loss_fn(tp, tb)[0]
            results[policy] = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
            counts[policy] = dict(ops.GRAD_GEMMS)
    finally:
        L.set_remat_policy("full")
        for t in leaves.values():
            t.requires_grad_(False)
    for policy in ("full", "dots"):
        torch.testing.assert_close(results[policy][0], results["none"][0], rtol=1e-6, atol=0)
        for path, a, b in zip(leaves, results[policy][1], results["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=path)
    fwd = counts["none"]["forward"]
    assert counts["none"]["grad_lhs"] == counts["none"]["grad_rhs"] == fwd
    assert "recompute" not in counts["none"]
    assert counts["full"]["forward"] == fwd and counts["full"]["recompute"] > 0  # the head is not recomputed
    assert counts["dots"]["forward"] == fwd and "recompute" not in counts["dots"]
    if not tm.is_vlm:  # a VLM's groups nest their layers' checkpoints: those recompute twice and save twice
        assert counts["dots"]["saved"] == counts["full"]["recompute"]
    if arch == "granite-8b":  # 7 GEMMs a layer, 2 layers, and the head
        assert counts["full"] == {"forward": 15, "recompute": 14, "grad_lhs": 15, "grad_rhs": 15}
    with pytest.raises(ValueError, match="remat policy"):
        L.set_remat_policy("everything")


def test_tied_embeddings_train_through_embed():
    """A tied reduced granite (the registry ties none): the head reads
    ``embed`` under grad, so its gradient sums the gather's and the head's,
    as the reference's ``embed.T``; ``embed_t`` is not trained, and the train
    step refreshes it from the updated ``embed``."""
    jcfg = dataclasses.replace(jax_registry.get("granite-8b").reduced(), tie_embeddings=True)
    tcfg = dataclasses.replace(registry.get("granite-8b").reduced(), tie_embeddings=True)
    jm = jax_build_model(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert "unembed" not in tp["emb"] and "embed_t" in tp["emb"]
    jb, tb = _batches(tcfg)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    loss, _, grads = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _grads_close(grads, jgrads)
    from repro_torch.train.train_step import make_train_step

    step = make_train_step(tm, adamw.AdamWConfig(lr=1e-2, warmup_steps=0))
    before = tp["emb"]["embed_t"].clone()
    tp, _, _ = step(tp, adamw.init(tp), tb)
    assert not torch.equal(tp["emb"]["embed_t"], before)
    torch.testing.assert_close(tp["emb"]["embed_t"], tp["emb"]["embed"].t(), rtol=0, atol=0)
    with torch.no_grad():  # serving reads the refreshed copy
        torch.testing.assert_close(L.logits_from_hidden(tp["emb"], tb["tokens"][:, :1, None].float().expand(-1, -1, 64)),
                                   tb["tokens"][:, :1, None].float().expand(-1, -1, 64) @ tp["emb"]["embed"].t())


@pytest.mark.parametrize("lead", [(5,), (2, 3), (2, 1, 4)])
def test_matmul_function_gradcheck_f64(lead):
    """The backward formula through the plain GEMM in f64, both gradients
    (and each alone), featurized as the forward and over the flattened rows."""
    gen = torch.Generator().manual_seed(len(lead))
    lhs = torch.randn(*lead, 6, dtype=torch.float64, generator=gen, requires_grad=True)
    rhs = torch.randn(6, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    fn = ops.matmul  # on CPU tensors the repro_torch::gemm op runs the plain GEMM, in f64 here
    assert torch.autograd.gradcheck(fn, (lhs, rhs))
    assert torch.autograd.gradcheck(lambda a: fn(a, rhs.detach()), (lhs,))
    assert torch.autograd.gradcheck(lambda b: fn(lhs.detach(), b), (rhs,))
    out = ops.matmul(lhs, rhs)
    assert out.grad_fn is not None and "repro_torch_gemm" in type(out.grad_fn).__name__


def test_mixed_dtype_gradients_land_in_operand_dtypes():
    """A bf16 activation against f32 weights (the VLM's image path): the
    gradients come back bf16 and f32, as the operands."""
    x = torch.randn(2, 3, 8).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(8, 5, requires_grad=True)
    out = ops.matmul(x, w)
    assert out.dtype == torch.bfloat16
    gx, gw = torch.autograd.grad(out.float().sum(), (x, w))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    torch.testing.assert_close(gw, x.detach().float().reshape(-1, 8).t() @ torch.ones(6, 5))


class _Recorder:
    """Policy that records every matmul problem it is asked about, in order."""

    cacheable = False

    def __init__(self, config):
        self.config = config
        self.seen = []

    def select_matmul(self, m, k, n, batch):
        self.seen.append((m, k, n, batch))
        return self.config


@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-large-v2"])
def test_forward_selections_equal_reference_log(arch):
    """The reference selects once per traced call site (its scans trace their
    remat bodies once, and its backward GEMMs are XLA's): the port's forward
    selections equal that log, in order, layer 0 selecting under
    ``ops.scan_layers``.  The recompute and the two backward GEMMs select
    afterwards: the recompute the forward's layer problems again, the
    backward their transposed problems (m = S, k = n, n = k, batch = B) and
    the flattened (k, B*S, n, 1)."""
    jm, jp, tm, tp = reduced_pair(arch)
    jb, tb = _batches(tm.cfg)
    jrec, jrt = _Recorder(JAX_DEFAULT), JaxRuntime()
    jrt.install(jrec)
    with jrt.activate():
        jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    trec, trt = _Recorder(DEFAULT_CONFIG), KernelRuntime()
    trt.install(trec)
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        with trt.activate():
            loss, _ = tm.loss_fn(tp, tb)
            forward = list(trec.seen)
            torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    assert forward == jrec.seen
    later = trec.seen[len(forward):]
    b, s = tb["tokens"].shape
    transposed = {(m, n, k, bb) for m, k, n, bb in forward} | {(k, bb * m, n, 1) for m, k, n, bb in forward}
    assert later and all(p in set(forward) or p in transposed for p in later)
    assert (tm.cfg.d_model, b * s, tm.cfg.padded_vocab(), 1) in later  # the head's weight gradient


def test_kernels_without_backward_refuse_grad(monkeypatch):
    """On a CUDA tensor with grad the attention op raises (here the check alone:
    a CPU tensor keeps autograd through the plain version).  The WKV and scan
    ops no longer refuse: with their tensors taken for the card's (stub
    kernels standing in for the CUDA wrappers, which hold each op's forward
    and backward to the plain versions), each runs under grad through its
    custom op and its backward kernel's wrapper."""
    x = torch.randn(2, 3, requires_grad=True)
    with pytest.raises(ops.NoBackwardKernelError, match="ops.attention.*no backward kernel"):
        ops._refuse_grad("attention", x.detach(), x)
    ops._refuse_grad("attention", x.detach())
    with torch.no_grad():
        ops._refuse_grad("attention", x)

    from repro_torch.kernels import ssm as sm
    from repro_torch.kernels import wkv as wk
    from repro_torch.kernels.ref import wkv_states_ref

    calls = []

    def stub(name, fn):
        def run(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_refuse_grad", lambda family, *t: pytest.fail(f"ops.{family} refused grad"))
    monkeypatch.setattr(ops, "wkv_cuda", stub("wkv", lambda r, k, v, lw, u, st, cfg, keep_states: (
        *wk.wkv_plain(r, k, v, lw, u, st), wkv_states_ref(k, v, lw, st, wk.launch_chunk(cfg, r.shape[1]))[0])))
    monkeypatch.setattr(ops, "wkv_backward_cuda", stub("wkv_bwd", lambda r, k, v, lw, u, st, do, dso, cfg, states: (
        wk.wkv_backward_plain(r, k, v, lw, u, st, do, dso, wk.launch_chunk(cfg, r.shape[1]), *states))))
    monkeypatch.setattr(ops, "ssm_cuda", stub("ssm", lambda *a: sm.ssm_plain(*a[:5])))
    monkeypatch.setattr(ops, "ssm_backward_cuda", stub("ssm_bwd", lambda *a: sm.ssm_backward_plain(
        *a[:7], a[7].chunk)))
    monkeypatch.setattr(ops, "ssm_cuda_fused", stub("ssm_fused", lambda *a: sm.ssm_fused_plain(*a[:6])))
    monkeypatch.setattr(ops, "ssm_fused_backward_cuda", stub("ssm_fused_bwd", lambda *a: sm.ssm_fused_backward_plain(
        *a[:8], a[8].chunk)))
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, requires_grad=True)
    r, k, v, u = rnd(1, 5, 2, 16), rnd(1, 5, 2, 16), rnd(1, 5, 2, 16), rnd(2, 16)
    logw = (-torch.rand((1, 5, 2, 16), generator=gen) - 0.1).requires_grad_(True)
    x, dt, a, b, c = rnd(1, 6, 8), rnd(1, 6, 8), rnd(8, 8), rnd(1, 6, 8), rnd(1, 6, 8)
    dta = rnd(1, 6, 8, 8)
    ops.GRAD_SCANS.clear()
    for op, out, leaves in (("wkv", lambda: ops.wkv(r, k, v, logw, u)[0], (r, k, v, logw, u)),
                            ("ssm_scan", lambda: ops.ssm_scan(x, dta, b, c)[0], (x, dta, b, c)),
                            ("ssm_scan_fused", lambda: ops.ssm_scan_fused(x, dt, a, b, c)[0], (x, dt, a, b, c))):
        grads = torch.autograd.grad(out().square().sum(), leaves)
        assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads), op
        assert ops.grad_scans(op) == {"forward": 1, "backward": 1}, op
    assert calls == ["wkv", "wkv_bwd", "ssm", "ssm_bwd", "ssm_fused", "ssm_fused_bwd"]

"""Kernel entry points with runtime kernel selection (the paper's launcher).

Every matmul of the port's models routes through :func:`matmul`, every
multi-token RWKV6 WKV recurrence through :func:`wkv`, and every multi-token
Mamba selective scan through :func:`ssm_scan_fused` (:func:`ssm_scan` is the
same scan from dt * x and dt * a, the TPU kernel's inputs); :func:`attention` is the
tuned flash-attention op (no model calls it: their attention is plain torch
code, as in the reference).  Each asks the current
:class:`~repro_torch.core.runtime.KernelRuntime` for the deployed config of
the problem and runs it.  On a CUDA tensor that is always the hand-written
kernel (``matmul_cuda``, ``wkv_cuda``, ``ssm_cuda`` / ``ssm_cuda_fused``,
``attention_cuda``), and nothing falls back to the plain version: the plain
version runs only for tensors on the CPU.

Every call runs under the fault guard (:func:`_guarded_call`, the reference's
``ops._guarded_call``): an injected fault (the runtime's ``FaultPlan``), an
allocator's out of memory, a kernel's ``KernelBuildError`` or
``KernelLaunchError``, or a non-finite output while validation is armed is
recorded as an incident and the config quarantined behind the runtime's
circuit breaker.  A sticky CUDA error (an illegal address, raised as
``torch.AcceleratorError``) is not contained: it poisons the context and
names no config.  Where the reference answers that call from its reference
path, the port, on a CUDA tensor, runs the family's default config once (it
is always compiled; the breaker redirects later selections to it too).  A
failing default config, or a call with no config, has nothing compiled left:
the guard records ``unrecoverable`` and raises.  On CPU tensors the plain
version answers, as the reference's does.

Inside a program build (``KernelRuntime.pinning``, what a serving engine
runs its bodies under) a call selects, fires the plan's dispatch sites and
runs the breaker only on the build's first run, the counterpart of the
reference's one trace, and pins the config it served; later runs (the
capture, eager replays) launch the pinned config and consult nothing.
Outputs inside a build are never corrupted or validated, as the reference
never sees a traced value.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from ..core.faults import GUARDED_EXCEPTIONS, FaultPlan, NonFiniteOutputError, incident
from ..core.runtime import current_runtime, quarantine_redirect
from .attention import DEFAULT_ATTN_CONFIG, AttentionConfig, attention_cuda, attention_plain
from .matmul import DEFAULT_CONFIG, MatmulConfig, matmul_cuda, matmul_plain
from .ssm import DEFAULT_SSM_CONFIG, SsmConfig, ssm_cuda, ssm_cuda_fused, ssm_fused_plain, ssm_plain
from .wkv import DEFAULT_WKV_CONFIG, WkvConfig, wkv_cuda, wkv_plain

__all__ = ["FixedPolicy", "KernelPolicy", "attention", "matmul", "ssm_scan", "ssm_scan_fused", "wkv"]


class KernelPolicy(Protocol):
    """Maps a kernel problem to the deployed config that should run it.

    A policy that has no ``select_attention`` (``select_wkv``,
    ``select_ssm``) does not cover the attention (wkv, ssm_scan) family: the
    runtime then selects ``None`` and the op runs its default config.  A
    tuned ``core.dispatch.Deployment`` is such a policy.
    """

    def select_matmul(self, m: int, k: int, n: int, batch: int) -> MatmulConfig: ...

    def select_attention(self, sq: int, skv: int, d: int) -> AttentionConfig: ...

    def select_wkv(self, s: int, hd: int) -> WkvConfig: ...

    def select_ssm(self, s: int, d: int) -> SsmConfig: ...


@dataclasses.dataclass
class FixedPolicy:
    """Single-kernel-per-family baseline (what an untuned library ships)."""

    matmul_config: MatmulConfig = DEFAULT_CONFIG
    attention_config: AttentionConfig = DEFAULT_ATTN_CONFIG
    wkv_config: WkvConfig = DEFAULT_WKV_CONFIG
    ssm_config: SsmConfig = DEFAULT_SSM_CONFIG

    def select_matmul(self, m, k, n, batch):
        return self.matmul_config

    def select_attention(self, sq, skv, d):
        return self.attention_config

    def select_wkv(self, s, hd):
        return self.wkv_config

    def select_ssm(self, s, d):
        return self.ssm_config


def scan_layers(n: int):
    """Iterate a model's ``n`` layers as the reference's ``lax.scan`` does:
    layer 0's kernel calls select, later layers replay its configs
    (``KernelRuntime.scan_layers``)."""
    return current_runtime().scan_layers(n)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def _select(rt, family: str, problem: tuple, select):
    """The config of one call and its pin: selected live (and recorded when a
    program build is recording), or, in a sealed build, its pinned config
    with pin ``None`` (a replay consults nothing)."""
    pins = rt.pins()
    if pins is None:
        return select(), False
    if pins.sealed:
        return pins.take(family, problem), None
    config = select()
    return config, pins.record(family, problem, config)


def _raise_non_finite(family: str, out) -> None:
    """Raise :class:`NonFiniteOutputError` if an output tensor has NaN/Inf.

    Returns at once while the stream captures a CUDA graph: there is no
    value to read, and reading one would be a sync, which a capture forbids.
    """
    leaves = out if isinstance(out, tuple) else (out,)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        if leaf.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        if not bool(torch.isfinite(leaf).all()):
            raise NonFiniteOutputError(f"{family} kernel call produced non-finite output")


def _guarded_call(rt, family: str, config, run, run_ref, *, on_card: bool, pin=False):
    """Execute one kernel call under the fault guard.

    ``run(config)`` launches the kernel at a config (the default one for
    ``None``), ``run_ref()`` is the plain version; ``pin`` is the call's pin
    in a recording program build (``False`` outside one, ``None`` when
    replaying a sealed one, see :func:`_select`).

    The happy path costs a try frame and a few attribute checks.  On a
    contained failure (``GUARDED_EXCEPTIONS``, or a non-finite output while
    validation is armed outside a program) the guard records the incident
    and quarantines ``(device, family, config)``; then a CPU call runs the
    plain version, as the reference does, and a CUDA call runs the family's
    default config once and pins it.  Where nothing compiled is left (the
    default failed, or the call had no config) it records ``unrecoverable``
    and raises.  A successful run of a half-open breaker's probe config
    closes the breaker (absolve).  A replayed call (pin ``None``) only runs:
    its failure quarantines the config and propagates to the engine, whose
    retry builds the program again.
    """
    if pin is None:
        try:
            return run(config)
        except GUARDED_EXCEPTIONS as e:
            recoverable = config is not None and config != quarantine_redirect(family)
            if recoverable:
                rt.quarantine_config(family, config, e)
            rt.record_incident(incident(f"dispatch.{family}", family, config, e,
                                        "quarantined" if recoverable else "unrecoverable",
                                        device=rt.active_device()))
            raise
    plan = rt.fault_plan
    in_build = pin is not False
    validate = not in_build and (plan is not None or rt._validate_outputs)
    try:
        spec = None
        if plan is not None:
            key = config.name() if config is not None and hasattr(config, "name") else ""
            spec = plan.raise_if(f"dispatch.{family}", key)
        out = run(config)
        if spec is not None and spec.kind in ("nan", "inf") and not in_build:
            out = FaultPlan.corrupt_array(spec, out)
        if validate:
            _raise_non_finite(family, out)
        if spec is not None and spec.kind == "latency":
            rt.record_incident(incident(f"dispatch.{family}", family, config, "injected latency spike",
                                        "latency_spike", device=rt.active_device()))
        if config is not None and rt._quarantine and rt.probing(family, config):
            rt.absolve(family, config)
            rt.record_incident(incident(f"dispatch.{family}", family, config, "re-probe succeeded",
                                        "absolved", device=rt.active_device()))
        return out
    except GUARDED_EXCEPTIONS as e:
        if not on_card:
            if config is not None:
                rt.quarantine_config(family, config, e)
            rt.record_incident(incident(f"dispatch.{family}", family, config, e,
                                        "quarantined" if config is not None else "fallback_ref",
                                        device=rt.active_device()))
            return run_ref()
        redirect = quarantine_redirect(family)
        if config is None or config == redirect:
            rt.record_incident(incident(f"dispatch.{family}", family, config, e, "unrecoverable",
                                        device=rt.active_device()))
            raise
        rt.quarantine_config(family, config, e)
        rt.record_incident(incident(f"dispatch.{family}", family, config, e, "quarantined",
                                    device=rt.active_device()))
        if in_build:
            pin[2] = redirect
        try:
            out = run(redirect)
            if validate:
                _raise_non_finite(family, out)
        except GUARDED_EXCEPTIONS as e2:
            rt.record_incident(incident(f"dispatch.{family}", family, redirect, e2, "unrecoverable",
                                        device=rt.active_device()))
            raise
        return out


def matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``lhs @ rhs`` with runtime kernel selection.

    ``lhs``: (..., k), ``rhs``: (k, n).  The problem is featurized as in the
    tuning dataset: the trailing lead dim is the GEMM M and everything before
    it the repeated batch, so a (B, S, D) activation is B GEMMs of (S, D).
    The kernel itself runs once on ``lhs.reshape(m * batch, k)``.
    """
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be 2-D, got {tuple(rhs.shape)}")
    *lead, k = lhs.shape
    n = rhs.shape[1]
    m = lead[-1] if lead else 1
    batch = 1
    for d in lead[:-1]:
        batch *= d
    rt = current_runtime()
    config, pin = _select(rt, "matmul", (m, k, n, batch), lambda: rt.select_matmul_config(m, k, n, batch))
    lhs2 = lhs.reshape(m * batch, k)
    run_ref = lambda: matmul_plain(lhs2, rhs, out_dtype).reshape(*lead, n)
    if not _on_card(lhs2):
        return _guarded_call(rt, "matmul", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
    lhs2 = lhs2.contiguous()
    run = lambda cfg: matmul_cuda(lhs2, rhs, cfg or DEFAULT_CONFIG, out_dtype=out_dtype).reshape(*lead, n)
    return _guarded_call(rt, "matmul", config, run, run_ref, on_card=True, pin=pin)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Attention with runtime kernel selection.

    q: (..., sq, d), k/v: (..., skv, d) with the same leading dims (no GQA
    broadcast, as in the reference).  Under ``causal`` the diagonal is
    aligned to the end of KV; a row with no visible column (sq > skv) is
    zeros.  The problem is featurized as in the reference: (sq, skv, d).  On
    CPU tensors the plain version runs; on a CUDA tensor the kernel runs
    once over all the leading dims.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    rt = current_runtime()
    config, pin = _select(rt, "attention", (sq, skv, d), lambda: rt.select_attention_config(sq, skv, d))
    run_ref = lambda: attention_plain(q, k, v, causal=causal, scale=scale)
    if not _on_card(q):
        return _guarded_call(rt, "attention", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    run = lambda cfg: attention_cuda(qc, kc, vc, cfg or DEFAULT_ATTN_CONFIG, causal=causal, scale=scale)
    return _guarded_call(rt, "attention", config, run, run_ref, on_card=True, pin=pin)


def wkv(r, k, v, logw, u, state=None):
    """Chunked RWKV6 WKV with runtime kernel selection.

    r/k/v/logw: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) or None.
    Returns (o (B, S, H, hd) f32, final state f32).  The problem is
    featurized as in the reference: (S, hd).  On CPU tensors the plain
    version runs (it ignores the chunk, as the reference's jnp path does).
    """
    _, s, _, hd = r.shape
    rt = current_runtime()
    config, pin = _select(rt, "wkv", (s, hd), lambda: rt.select_wkv_config(s, hd))
    run_ref = lambda: wkv_plain(r, k, v, logw, u, state)
    if not _on_card(r):
        return _guarded_call(rt, "wkv", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
    run = lambda cfg: wkv_cuda(r, k, v, logw, u, state, cfg or DEFAULT_WKV_CONFIG)
    return _guarded_call(rt, "wkv", config, run, run_ref, on_card=True, pin=pin)


def ssm_scan(dtx, dta, b, c, state=None):
    """Mamba selective scan with runtime kernel selection.

    dtx: (B, S, d); dta: (B, S, d, N); b/c: (B, S, N); state: (B, d, N) or
    None.  Returns (y (B, S, d) f32, final state (B, d, N) f32).  The problem
    is featurized as in the reference: (S, d).  On CPU tensors the plain
    version runs.
    """
    _, s, d = dtx.shape
    rt = current_runtime()
    config, pin = _select(rt, "ssm_scan", (s, d), lambda: rt.select_ssm_config(s, d))
    run_ref = lambda: ssm_plain(dtx, dta, b, c, state)
    if not _on_card(dtx):
        return _guarded_call(rt, "ssm_scan", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
    run = lambda cfg: ssm_cuda(dtx, dta, b, c, state, cfg or DEFAULT_SSM_CONFIG)
    return _guarded_call(rt, "ssm_scan", config, run, run_ref, on_card=True, pin=pin)


def ssm_scan_fused(x, dt, a, b, c, state=None):
    """:func:`ssm_scan` of dtx = dt * x and dta = dt[..., None] * a, formed in the kernel.

    x/dt: (B, S, d); a: (d, N); b/c: (B, S, N); state: (B, d, N) or None.
    Returns (y (B, S, d) f32, final state (B, d, N) f32).  Selected and
    guarded as :func:`ssm_scan` is (the ssm_scan family, features (S, d)).
    On CPU tensors the plain version runs; on a CUDA tensor
    ``ssm_cuda_fused``, so the (B, S, d, N) dta is never formed.
    """
    _, s, d = x.shape
    rt = current_runtime()
    config, pin = _select(rt, "ssm_scan", (s, d), lambda: rt.select_ssm_config(s, d))
    run_ref = lambda: ssm_fused_plain(x, dt, a, b, c, state)
    if not _on_card(x):
        return _guarded_call(rt, "ssm_scan", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
    xc, dtc, ac, bc, cc = (t.contiguous() for t in (x, dt, a, b, c))
    run = lambda cfg: ssm_cuda_fused(xc, dtc, ac, bc, cc, state, cfg or DEFAULT_SSM_CONFIG)
    return _guarded_call(rt, "ssm_scan", config, run, run_ref, on_card=True, pin=pin)

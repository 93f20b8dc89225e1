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

Training: on a tensor that requires grad, :func:`matmul` runs as the
``repro_torch::gemm`` custom op (:data:`GEMM_OP`), whose backward is two more
GEMMs through :func:`matmul` (the same selection, guard and kernel); remat
``"dots"`` is a selective-checkpoint policy that saves that op's outputs
(``layers.ckpt``).  Likewise :func:`wkv`, :func:`ssm_scan` and
:func:`ssm_scan_fused` run as the ``repro_torch::wkv``,
``repro_torch::ssm_scan`` and ``repro_torch::ssm_scan_fused`` ops, whose
backward is the recurrence's own backward kernel (``wkv_backward_cuda``,
``ssm_backward_cuda``, ``ssm_fused_backward_cuda``) at the config the
forward ran, selected and guarded as the forward, or on CPU tensors its plain
version (``wkv_backward_plain``, ...), the same function.  :func:`attention`
has no backward kernel (no model trains through it): on a CUDA tensor with
grad it raises :class:`NoBackwardKernelError` rather than return an output
that no gradient flows through; on CPU tensors its plain version keeps
autograd.

Inside a program build (``KernelRuntime.pinning``, what a serving engine
runs its bodies under) a call selects, fires the plan's dispatch sites and
runs the breaker only on the build's first run, the counterpart of the
reference's one trace, and pins the config it served; later runs (the
capture, eager replays) launch the pinned config and consult nothing.
Outputs inside a build are never corrupted or validated, as the reference
never sees a traced value.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from collections import Counter
from typing import Protocol

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ..core.faults import GUARDED_EXCEPTIONS, FaultPlan, NonFiniteOutputError, incident
from ..core.runtime import KernelRuntime, current_runtime, quarantine_redirect
from .attention import DEFAULT_ATTN_CONFIG, AttentionConfig, attention_cuda, attention_plain
from .matmul import DEFAULT_CONFIG, MatmulConfig, matmul_cuda, matmul_plain, transposed
from .ssm import (DEFAULT_SSM_CONFIG, SsmConfig, ssm_backward_cuda, ssm_backward_plain, ssm_cuda, ssm_cuda_fused,
                  ssm_fused_backward_cuda, ssm_fused_backward_plain, ssm_fused_plain, ssm_plain)
from .wkv import (DEFAULT_WKV_CONFIG, WkvConfig, launch_chunk, wkv_backward_cuda, wkv_backward_plain, wkv_cuda,
                  wkv_plain)

__all__ = ["GEMM_OP", "FixedPolicy", "GRAD_SCANS", "KernelPolicy", "NoBackwardKernelError", "SSM_BWD_OP",
           "SSM_FUSED_BWD_OP", "SSM_FUSED_OP", "SSM_OP", "WKV_BWD_OP", "WKV_OP", "attention", "gemm_phase", "matmul",
           "ssm_scan", "ssm_scan_fused", "wkv",
           # launcher-side selection helpers (route through the current runtime)
           "select_kernel_config", "select_matmul_config", "select_ssm_config", "select_wkv_config",
           # runtime-state readers (current-runtime passthroughs)
           "active_device", "device_policies", "device_resolution", "get_kernel_policy", "policy_epoch",
           "selection_log", "selection_logging_enabled", "shape_cache_stats",
           # deprecated global mutators (shims over the current runtime)
           "activate_device", "clear_device_policies", "clear_selection_log", "clear_shape_cache",
           "set_kernel_policy", "set_kernel_policy_for_device", "set_pallas_enabled", "set_selection_logging",
           "set_shape_cache_cap"]


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


# ---------------------------------------------------------------------------
# deprecated module-level API: thin shims over the current (default) runtime,
# as the reference's
# ---------------------------------------------------------------------------
def _warn_global(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.kernels.ops.{old}() mutates shared global runtime state and is "
        f"deprecated; hold a repro_torch.KernelRuntime and call {new} instead",
        DeprecationWarning,
        stacklevel=3,
    )


def set_kernel_policy(policy: KernelPolicy | None) -> None:
    """Deprecated shim: ``KernelRuntime.install(policy)`` on the current runtime."""
    _warn_global("set_kernel_policy", "KernelRuntime.install(policy)")
    current_runtime().install(policy)


def get_kernel_policy() -> KernelPolicy | None:
    return current_runtime().policy()


def set_kernel_policy_for_device(device: str, policy: KernelPolicy | None) -> None:
    """Deprecated shim: ``KernelRuntime.install_for_device(device, policy)``."""
    _warn_global("set_kernel_policy_for_device", "KernelRuntime.install_for_device(device, policy)")
    current_runtime().install_for_device(device, policy)


def device_policies() -> dict[str, KernelPolicy]:
    """Registered per-device policies of the current runtime (name -> policy)."""
    return current_runtime().device_policies()


def active_device() -> str | None:
    """Canonical name of the current runtime's live registered device."""
    return current_runtime().active_device()


def device_resolution() -> tuple[str | None, str | None]:
    """(requested, resolved) device names from the last device activation."""
    return current_runtime().device_resolution()


def activate_device(device: str | None = None, *, strict: bool = False) -> str:
    """Deprecated shim: ``KernelRuntime.activate_device(device)``."""
    _warn_global("activate_device", "KernelRuntime.activate_device(device)")
    return current_runtime().activate_device(device, strict=strict)


def clear_device_policies() -> None:
    """Deprecated shim: ``KernelRuntime.clear_device_policies()``."""
    _warn_global("clear_device_policies", "KernelRuntime.clear_device_policies()")
    current_runtime().clear_device_policies()


def set_pallas_enabled(enabled: bool, *, interpret: bool = False) -> None:
    """The reference switches its ops between the Pallas kernels and their jnp
    versions; the port has no such switch: a CUDA tensor always launches the
    hand-written kernel and only a CPU tensor takes the plain version."""
    raise NotImplementedError(
        "set_pallas_enabled has no counterpart in repro_torch: a CUDA tensor always runs the hand-written "
        "kernel, and the plain version runs only for CPU tensors")


def set_selection_logging(enabled: bool, *, cap: int | None = None) -> None:
    """Deprecated shim: ``KernelRuntime.set_selection_logging(enabled)``."""
    _warn_global("set_selection_logging", "KernelRuntime.set_selection_logging(enabled)")
    current_runtime().set_selection_logging(enabled, cap=cap)


def selection_logging_enabled() -> bool:
    return current_runtime().selection_logging_enabled()


def selection_log() -> list[tuple]:
    """Dispatch decisions of the current runtime (op, problem, config)."""
    return current_runtime().selection_log()


def clear_selection_log() -> None:
    """Deprecated shim: ``KernelRuntime.clear_selection_log()``."""
    _warn_global("clear_selection_log", "KernelRuntime.clear_selection_log()")
    current_runtime().clear_selection_log()


def clear_shape_cache() -> None:
    """Deprecated shim: ``KernelRuntime.clear_shape_cache()``."""
    _warn_global("clear_shape_cache", "KernelRuntime.clear_shape_cache()")
    current_runtime().clear_shape_cache()


def set_shape_cache_cap(cap: int) -> None:
    """Deprecated shim: ``KernelRuntime.set_shape_cache_cap(cap)``."""
    _warn_global("set_shape_cache_cap", "KernelRuntime.set_shape_cache_cap(cap)")
    current_runtime().set_shape_cache_cap(cap)


def shape_cache_stats() -> dict:
    """Dispatch shape-cache counters of the current runtime (this thread)."""
    return current_runtime().shape_cache_stats()


def policy_epoch() -> int:
    """Policy epoch of the current runtime (swap observability)."""
    return current_runtime().policy_epoch()


def select_kernel_config(family: str, problem: tuple):
    """Launcher-side selection against the current runtime: shape-memoized under the
    family-qualified key, logged as ``(family, problem, config)``; ``None`` when no
    policy is installed or the policy does not cover this family."""
    return current_runtime().select_config(family, problem)


def select_matmul_config(m: int, k: int, n: int, batch: int = 1) -> MatmulConfig | None:
    """The selection :func:`matmul` makes, on its own; ``None`` when no policy is installed."""
    return current_runtime().select_matmul_config(m, k, n, batch)


def select_wkv_config(s: int, hd: int) -> WkvConfig | None:
    """The selection :func:`wkv` makes, on its own."""
    return current_runtime().select_wkv_config(s, hd)


def select_ssm_config(s: int, d: int) -> SsmConfig | None:
    """The selection :func:`ssm_scan` makes, on its own."""
    return current_runtime().select_ssm_config(s, d)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def _through_op(*tensors) -> bool:
    """Whether a call must go through its dispatcher op even without grad: a
    DTensor operand (the op's sharding rule runs the kernel on each rank's
    local shard) or a meta tensor (the op's fake impl gives the shapes; it
    never reaches :func:`_on_card`'s choice of wrapper or plain version)."""
    return any(isinstance(t, DTensor) or (isinstance(t, torch.Tensor) and t.is_meta) for t in tensors)


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
    The kernel itself runs once on ``lhs.reshape(m * batch, k)``.  The output
    is ``out_dtype``, by default ``lhs``'s.  Operands of two dtypes (a VLM's
    bf16 image embeddings against f32 weights) run in f32, as the
    reference's ``jnp.dot`` promotes them.  With grad enabled and an operand
    that requires it, the call runs as the ``repro_torch::gemm`` op
    (:data:`GEMM_OP`), whose gradient GEMMs come back here.  So does a call
    on DTensors (the op's sharding rule: each rank runs the GEMM of its local
    shards, so selection sees the local problem) or on meta tensors (the
    op's fake impl).
    """
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be 2-D, got {tuple(rhs.shape)}")
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _gemm(lhs, rhs, out_dtype)
    if _through_op(lhs, rhs):
        with _uncounted():
            return _gemm(lhs, rhs, out_dtype)
    return _matmul_call(lhs, rhs, out_dtype)


def _matmul_call(lhs: torch.Tensor, rhs: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    """One selected, guarded GEMM: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
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
    out_dtype = out_dtype or lhs.dtype
    if lhs.dtype != rhs.dtype:
        lhs2, rhs = lhs2.float(), rhs.float()
    if transposed(lhs2) is None:  # the kernel reads row-major operands and transposed views of them
        lhs2 = lhs2.contiguous()
    if transposed(rhs) is None:
        rhs = rhs.contiguous()
    kernel_out = out_dtype if (lhs2.dtype, out_dtype) != (torch.float32, torch.bfloat16) else torch.float32
    run = lambda cfg: matmul_cuda(lhs2, rhs, cfg or DEFAULT_CONFIG, out_dtype=kernel_out).to(out_dtype).reshape(
        *lead, n)
    return _guarded_call(rt, "matmul", config, run, run_ref, on_card=True, pin=pin)


# ---------------------------------------------------------------------------
# the GEMM's gradient
# ---------------------------------------------------------------------------
# GEMMs run under grad, by phase: "forward" (a forward under grad), "recompute" (a
# checkpointed layer's forward run again in the backward under remat "full"),
# "grad_lhs" and "grad_rhs" (the two backward GEMMs); remat "dots" counts the GEMM
# outputs its policy saves as "saved" (``layers.ckpt``; once per region that saves
# them).  The reference's selection log holds only the forward's selections (its
# backward GEMMs are XLA's transposes and JAX traces a remat body once); the other
# phases are the port's own.
GRAD_GEMMS: Counter = Counter()


class _PhaseLocal(threading.local):
    def __init__(self):
        self.label = "forward"
        self.counted = True  # False for a call that runs the op only to reach its rule or fake
        self.ran = None  # the config a recurrence op's last forward ran, read by its setup_context


_phase = _PhaseLocal()


@contextlib.contextmanager
def gemm_phase(label: str):
    """Count the GEMMs run inside under ``label`` in :data:`GRAD_GEMMS`."""
    prev, _phase.label = _phase.label, label
    try:
        yield
    finally:
        _phase.label = prev


@contextlib.contextmanager
def _uncounted():
    """Op calls inside count in neither :data:`GRAD_GEMMS` nor :data:`GRAD_SCANS`:
    calls without grad that take the op for its sharding rule or its fake impl."""
    prev, _phase.counted = _phase.counted, False
    try:
        yield
    finally:
        _phase.counted = prev


def _count(counter: Counter, key) -> None:
    if _phase.counted:
        counter[key] += 1


def gemm_phase_label() -> str:
    """The label this thread's GEMMs count under now."""
    return _phase.label


@torch.library.custom_op("repro_torch::gemm", mutates_args=(),
                         schema="(Tensor lhs, Tensor rhs, ScalarType? out_dtype) -> Tensor")
def _gemm(lhs: torch.Tensor, rhs: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    """``ops.matmul`` under grad: the selected, guarded GEMM as a dispatcher op,
    so autograd and torch's selective-checkpoint policies see it."""
    _count(GRAD_GEMMS, _phase.label)
    return _matmul_call(lhs, rhs, out_dtype)


GEMM_OP = torch.ops.repro_torch.gemm.default


@_gemm.register_fake
def _gemm_fake(lhs, rhs, out_dtype):
    return lhs.new_empty((*lhs.shape[:-1], rhs.shape[1]), dtype=out_dtype or lhs.dtype)


R = Replicate()


@register_sharding(GEMM_OP)
def _gemm_sharding(lhs, rhs, out_dtype):
    """``aten.mm``'s strategies on one mesh dim: lhs's lead dims sharded (rhs
    replicated), rhs's columns sharded (lhs replicated), or the contraction
    sharded on both, giving a partial sum; else everything replicated."""
    last = lhs.ndim - 1
    rules = [([R], [R, R, None]), ([Shard(last)], [R, Shard(1), None]),
             ([Partial()], [Shard(last), Shard(0), None])]
    rules += [([Shard(d)], [Shard(d), R, None]) for d in range(last)]
    return rules


def _gemm_setup(ctx, inputs, output):
    lhs, rhs, _ = inputs
    ctx.save_for_backward(lhs, rhs)
    ctx.runtime = current_runtime()


def _gemm_backward(ctx, grad_out):
    """Two more GEMMs through :func:`matmul`, so the tuned tree selects both
    configs and the fault guard covers them:

      * ``grad_lhs = grad_out . rhs^T``: for lhs (B, S, k) the problem
        (m = S, k = n, n = k, batch = B), featurized as the forward;
      * ``grad_rhs = lhs2^T . grad_out2``: one GEMM (k, B*S, n, batch 1) over
        the flattened rows.

    Each gradient comes back in its operand's dtype.  ``rhs^T`` and
    ``lhs2^T`` are passed as ``.t()`` views: the kernel's TMA path reads them
    where they lie (its other paths copy them, ``matmul.TRANSPOSE_COPIES``).
    The runtime active at the forward is activated here, which on the card
    runs on autograd's device thread.
    """
    lhs, rhs = ctx.saved_tensors
    rt: KernelRuntime = ctx.runtime
    # grad_out in the GEMM's input dtype: an f32 grad_out of a bf16 GEMM with an f32
    # output (the vocab head) is cast to bf16 before both backward GEMMs, which
    # accumulate in f32; a GEMM of two dtypes ran in f32, and so does its backward.
    g = grad_out.to(lhs.dtype if lhs.dtype == rhs.dtype else torch.float32)
    k, n = rhs.shape
    grad_lhs = grad_rhs = None
    with rt.activate():
        if ctx.needs_input_grad[0]:
            _count(GRAD_GEMMS, "grad_lhs")
            grad_lhs = matmul(g, rhs.t(), out_dtype=lhs.dtype)
        if ctx.needs_input_grad[1]:
            _count(GRAD_GEMMS, "grad_rhs")
            grad_rhs = matmul(lhs.reshape(-1, k).t(), g.reshape(-1, n).contiguous(), out_dtype=rhs.dtype)
    return grad_lhs, grad_rhs, None


_gemm.register_autograd(_gemm_backward, setup_context=_gemm_setup)


class NoBackwardKernelError(NotImplementedError):
    """A kernel without a backward kernel was called on the card with grad."""


def _refuse_grad(family: str, *tensors) -> None:
    """Raise :class:`NoBackwardKernelError` when grad is on and any input
    requires it: the kernel's output carries no gradient, and a loss built on
    it would train every weight upstream of it on a silently dropped term."""
    if _wants_grad(*tensors):
        raise NoBackwardKernelError(
            f"ops.{family} on a CUDA tensor has no backward kernel: no model trains through it (their attention "
            f"is plain torch code); run it under torch.no_grad(), or on the CPU")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


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
    _refuse_grad("attention", q, k, v)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    run = lambda cfg: attention_cuda(qc, kc, vc, cfg or DEFAULT_ATTN_CONFIG, causal=causal, scale=scale)
    return _guarded_call(rt, "attention", config, run, run_ref, on_card=True, pin=pin)


# ---------------------------------------------------------------------------
# the recurrences under grad
# ---------------------------------------------------------------------------
# Calls of the recurrences' ops under grad, by (op, phase): "forward" and "recompute" as
# GRAD_GEMMS counts them (the thread's gemm_phase label), "backward" for each backward
# kernel call (one per op call the backward reaches).
GRAD_SCANS: Counter = Counter()

S0, S1, S2 = Shard(0), Shard(1), Shard(2)


def grad_scans(op: str) -> dict[str, int]:
    """:data:`GRAD_SCANS` of one op (``"wkv"``, ``"ssm_scan"``, ``"ssm_scan_fused"``), by phase."""
    return {phase: n for (name, phase), n in GRAD_SCANS.items() if name == op}


class _Run:
    """The guard's ``run(cfg)`` for ``launch``: keeps the config it launched
    (``None`` runs ``default``; the guard may redirect), which the backward reads."""

    def __init__(self, launch, default):
        self.launch, self.default, self.config = launch, default, None

    def __call__(self, cfg):
        self.config = cfg or self.default
        return self.launch(self.config)


def _setup(ctx, inputs, extra=()):
    """Save what a recurrence's backward reads: its inputs (and ``extra``), the
    config its forward ran (left in ``_phase.ran`` by the op's forward, or its
    fake impl), and the runtime active at the forward, which the backward (on
    autograd's device thread, on the card) activates."""
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*inputs, *extra)
    ctx.config = _phase.ran
    ctx.runtime = current_runtime()


def _grad_call(op: str, family: str, config, run, run_ref, on_card: bool):
    """One guarded backward kernel call at the forward's config, under the
    current runtime (the backward formula activates the forward's): a failing
    config is quarantined and the default config's backward runs."""
    _count(GRAD_SCANS, (op, "backward"))
    rt = current_runtime()
    if not on_card:
        return _guarded_call(rt, family, config, lambda cfg: run_ref(), run_ref, on_card=False)
    return _guarded_call(rt, family, config, run, run_ref, on_card=True)


def _only_needed(ctx, grads) -> tuple:
    return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _opt(spec, placement):
    """``placement`` for an optional tensor argument that is present, ``None`` for one that is not."""
    return None if spec is None else placement


def _dense(*outs) -> tuple:
    """An op's outputs contiguous, as its fake impl gives them (the plain
    versions return some transposed; a DTensor reshape views the local shard)."""
    return tuple(t.contiguous() for t in outs)


def _zeros_f32(like):
    return torch.zeros_like(like, dtype=torch.float32)


def wkv(r, k, v, logw, u, state=None):
    """Chunked RWKV6 WKV with runtime kernel selection.

    r/k/v/logw: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) or None.
    Returns (o (B, S, H, hd) f32, final state f32).  The problem is
    featurized as in the reference: (S, hd).  On CPU tensors the plain
    version runs (it ignores the chunk, as the reference's jnp path does).
    With grad enabled and an operand that requires it, the call runs as the
    ``repro_torch::wkv`` op (:data:`WKV_OP`), whose backward is the WKV's
    backward kernel; on DTensors or meta tensors it runs as that op too
    (sharded over batch or heads by its rule, never over the sequence).
    """
    args = (*(t.contiguous() for t in (r, k, v, logw, u)), None if state is None else state.contiguous())
    if _wants_grad(r, k, v, logw, u, state):
        return _wkv_op(*args)[:2]
    if _through_op(*args):
        with _uncounted():
            return _wkv_op(*args)[:2]
    return _wkv_call(r, k, v, logw, u, state)[0]


def _wkv_call(r, k, v, logw, u, state, keep_states: bool = False):
    """One selected, guarded WKV: ((o, final state[, hs]), the config it ran)."""
    _, s, _, hd = r.shape
    rt = current_runtime()
    config, pin = _select(rt, "wkv", (s, hd), lambda: rt.select_wkv_config(s, hd))
    run_ref = lambda: wkv_plain(r, k, v, logw, u, state)
    if not _on_card(r):
        out = _guarded_call(rt, "wkv", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
        return out, config or DEFAULT_WKV_CONFIG
    if keep_states:
        run = _Run(lambda cfg: wkv_cuda(r, k, v, logw, u, state, cfg, keep_states=True), DEFAULT_WKV_CONFIG)
    else:
        run = _Run(lambda cfg: wkv_cuda(r, k, v, logw, u, state, cfg), DEFAULT_WKV_CONFIG)
    return _guarded_call(rt, "wkv", config, run, run_ref, on_card=True, pin=pin), run.config


@torch.library.custom_op("repro_torch::wkv", mutates_args=(),
                         schema="(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, Tensor? state) "
                                "-> (Tensor, Tensor, Tensor)")
def _wkv_op(r, k, v, logw, u, state):
    """``ops.wkv`` under grad as a dispatcher op.  Returns (o, final state, hs:
    the state at every chunk's start, which the backward kernel reads; no
    chunks on the CPU, whose plain backward makes its own).  The config it
    ran is left in ``_phase.ran`` for the autograd setup."""
    _count(GRAD_SCANS, ("wkv", _phase.label))
    out, _phase.ran = _wkv_call(r, k, v, logw, u, state, keep_states=True)
    b, _, h, hd = r.shape
    hs = out[2] if len(out) > 2 else r.new_empty((b, h, 0, hd, hd), dtype=torch.float32)
    return _dense(out[0], out[1], hs)


WKV_OP = torch.ops.repro_torch.wkv.default


@_wkv_op.register_fake
def _wkv_fake(r, k, v, logw, u, state):
    """Shapes at the default config (``hs`` holds chunks off the CPU: the meta
    device stands for the card)."""
    b, s, h, hd = r.shape
    _phase.ran = DEFAULT_WKV_CONFIG
    chunks = 0 if r.device.type == "cpu" else -(-s // launch_chunk(DEFAULT_WKV_CONFIG, s))
    f32 = torch.float32
    return (r.new_empty(r.shape, dtype=f32), r.new_empty((b, h, hd, hd), dtype=f32),
            r.new_empty((b, h, chunks, hd, hd), dtype=f32))


@register_sharding(WKV_OP)
def _wkv_sharding(r, k, v, logw, u, state):
    """Over batch, or over heads (u's rows with them), never over the sequence."""
    return [([R, R, R], [R, R, R, R, R, _opt(state, R)]),
            ([S0, S0, S0], [S0, S0, S0, S0, R, _opt(state, S0)]),
            ([S2, S1, S1], [S2, S2, S2, S2, S0, _opt(state, S1)])]


def _wkv_setup(ctx, inputs, output):
    _, s_out, hs = output
    ctx.mark_non_differentiable(hs)
    _setup(ctx, inputs, (s_out, hs))


def _wkv_backward(ctx, do, ds_out, _hs):
    """The ``repro_torch::wkv_backward`` op under the forward's runtime."""
    r, k, v, logw, u, state, s_out, hs = ctx.saved_tensors
    do = _zeros_f32(r) if do is None else do
    with ctx.runtime.activate():
        grads = _wkv_bwd_op(r, k, v, logw, u, state, do, ds_out, s_out, hs, ctx.config.chunk)
    return _only_needed(ctx, (*grads[:5], None if state is None else grads[5]))


_wkv_op.register_autograd(_wkv_backward, setup_context=_wkv_setup)


@torch.library.custom_op("repro_torch::wkv_backward", mutates_args=(),
                         schema="(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, Tensor? state, Tensor do, "
                                "Tensor? ds_out, Tensor s_out, Tensor hs, int chunk) "
                                "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _wkv_bwd_op(r, k, v, logw, u, state, do, ds_out, s_out, hs, chunk):
    """The WKV's backward kernel at the forward's config (its launch chunk, and the
    forward's ``hs``; a redirect to another chunk makes its own), or on the CPU
    :func:`~repro_torch.kernels.wkv.wkv_backward_plain` at that chunk.  Returns
    (dr, dk, dv, dlogw, du, dstate); dstate holds nothing without a state."""
    b, s, h, hd = r.shape
    do = do.contiguous()
    ds_out = None if ds_out is None else ds_out.contiguous()
    config = WkvConfig(chunk)
    launched = launch_chunk(config, s)
    run_ref = lambda: wkv_backward_plain(r, k, v, logw, u, state, do, ds_out, launched)

    def run(cfg):
        cfg = cfg or DEFAULT_WKV_CONFIG
        states = (hs, s_out) if launch_chunk(cfg, s) == launched else None
        return wkv_backward_cuda(r, k, v, logw, u, state, do, ds_out, cfg, states)

    grads = _grad_call("wkv", "wkv", config, run, run_ref, _on_card(r))
    dstate = grads[5] if state is not None else r.new_empty((b, h, 0, 0), dtype=torch.float32)
    return _dense(*grads[:5], dstate)


WKV_BWD_OP = torch.ops.repro_torch.wkv_backward.default


@_wkv_bwd_op.register_fake
def _wkv_bwd_fake(r, k, v, logw, u, state, do, ds_out, s_out, hs, chunk):
    b, _, h, _ = r.shape
    dstate = torch.empty_like(state) if state is not None else r.new_empty((b, h, 0, 0), dtype=torch.float32)
    return (*(torch.empty_like(t) for t in (r, k, v, logw, u)), dstate)


@register_sharding(WKV_BWD_OP)
def _wkv_bwd_sharding(r, k, v, logw, u, state, do, ds_out, s_out, hs, chunk):
    """The forward's shardings; du sums over the batch, so over batch it is a partial sum."""
    return [([R] * 6, [R, R, R, R, R, _opt(state, R), R, _opt(ds_out, R), R, R, None]),
            ([S0, S0, S0, S0, Partial(), S0],
             [S0, S0, S0, S0, R, _opt(state, S0), S0, _opt(ds_out, S0), S0, S0, None]),
            ([S2, S2, S2, S2, S0, S1],
             [S2, S2, S2, S2, S0, _opt(state, S1), S2, _opt(ds_out, S1), S1, S1, None])]


def ssm_scan(dtx, dta, b, c, state=None):
    """Mamba selective scan with runtime kernel selection.

    dtx: (B, S, d); dta: (B, S, d, N); b/c: (B, S, N); state: (B, d, N) or
    None.  Returns (y (B, S, d) f32, final state (B, d, N) f32).  The problem
    is featurized as in the reference: (S, d).  On CPU tensors the plain
    version runs.  With grad enabled and an operand that requires it, the
    call runs as the ``repro_torch::ssm_scan`` op (:data:`SSM_OP`), whose
    backward is the scan's backward kernel; on DTensors or meta tensors it
    runs as that op too (sharded over batch or channels, never the sequence).
    """
    args = (*(t.contiguous() for t in (dtx, dta, b, c)), None if state is None else state.contiguous())
    if _wants_grad(dtx, dta, b, c, state):
        return _ssm_op(*args)
    if _through_op(*args):
        with _uncounted():
            return _ssm_op(*args)
    return _ssm_call(dtx, dta, b, c, state)[0]


def _ssm_call(dtx, dta, b, c, state):
    """One selected, guarded scan from dtx and dta: ((y, final state), the config it ran)."""
    _, s, d = dtx.shape
    rt = current_runtime()
    config, pin = _select(rt, "ssm_scan", (s, d), lambda: rt.select_ssm_config(s, d))
    run_ref = lambda: ssm_plain(dtx, dta, b, c, state)
    if not _on_card(dtx):
        out = _guarded_call(rt, "ssm_scan", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
        return out, config or DEFAULT_SSM_CONFIG
    run = _Run(lambda cfg: ssm_cuda(dtx, dta, b, c, state, cfg), DEFAULT_SSM_CONFIG)
    return _guarded_call(rt, "ssm_scan", config, run, run_ref, on_card=True, pin=pin), run.config


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(),
                         schema="(Tensor dtx, Tensor dta, Tensor b, Tensor c, Tensor? state) -> (Tensor, Tensor)")
def _ssm_op(dtx, dta, b, c, state):
    """``ops.ssm_scan`` under grad as a dispatcher op: (y, final state); the
    config it ran is left in ``_phase.ran`` for the autograd setup."""
    _count(GRAD_SCANS, ("ssm_scan", _phase.label))
    out, _phase.ran = _ssm_call(dtx, dta, b, c, state)
    return _dense(*out)


SSM_OP = torch.ops.repro_torch.ssm_scan.default


def _scan_fake(x, b):
    _phase.ran = DEFAULT_SSM_CONFIG
    bsz, _, d = x.shape
    return x.new_empty(x.shape, dtype=torch.float32), x.new_empty((bsz, d, b.shape[-1]), dtype=torch.float32)


@_ssm_op.register_fake
def _ssm_fake(dtx, dta, b, c, state):
    return _scan_fake(dtx, b)


@register_sharding(SSM_OP)
def _ssm_sharding(dtx, dta, b, c, state):
    """Over batch, or over channels (b, c replicated), never over the sequence."""
    return [([R, R], [R, R, R, R, _opt(state, R)]),
            ([S0, S0], [S0, S0, S0, S0, _opt(state, S0)]),
            ([S2, S1], [S2, S2, R, R, _opt(state, S1)])]


def _ssm_setup(ctx, inputs, output):
    _setup(ctx, inputs)


def _ssm_backward(ctx, dy, ds_out):
    """The ``repro_torch::ssm_scan_backward`` op under the forward's runtime."""
    dtx, dta, b, c, state = ctx.saved_tensors
    dy = _zeros_f32(dtx) if dy is None else dy
    with ctx.runtime.activate():
        grads = _ssm_bwd_op(dtx, dta, b, c, state, dy, ds_out, ctx.config.block_d, ctx.config.chunk)
    return _only_needed(ctx, (*grads[:4], None if state is None else grads[4]))


_ssm_op.register_autograd(_ssm_backward, setup_context=_ssm_setup)


def _no_state(x):
    """The d(state) output of a scan without a state: (B, 0, 0), nothing in it."""
    return x.new_empty((x.shape[0], 0, 0), dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=(),
                         schema="(Tensor dtx, Tensor dta, Tensor b, Tensor c, Tensor? state, Tensor dy, "
                                "Tensor? ds_out, int block_d, int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _ssm_bwd_op(dtx, dta, b, c, state, dy, ds_out, block_d, chunk):
    """The scan's backward kernel (dta entry) at the forward's config, or on the CPU
    :func:`~repro_torch.kernels.ssm.ssm_backward_plain` at its chunk.  Returns
    (d(dtx), d(dta), db, dc, d(state)); d(state) holds nothing without a state."""
    dy = dy.contiguous()
    ds_out = None if ds_out is None else ds_out.contiguous()
    config = SsmConfig(block_d, chunk)
    run_ref = lambda: ssm_backward_plain(dtx, dta, b, c, state, dy, ds_out, chunk)
    run = lambda cfg: ssm_backward_cuda(dtx, dta, b, c, state, dy, ds_out, cfg or DEFAULT_SSM_CONFIG)
    grads = _grad_call("ssm_scan", "ssm_scan", config, run, run_ref, _on_card(dtx))
    return _dense(*grads[:4], grads[4] if state is not None else _no_state(dtx))


SSM_BWD_OP = torch.ops.repro_torch.ssm_scan_backward.default


@_ssm_bwd_op.register_fake
def _ssm_bwd_fake(dtx, dta, b, c, state, dy, ds_out, block_d, chunk):
    return (*(torch.empty_like(t) for t in (dtx, dta, b, c)),
            torch.empty_like(state) if state is not None else _no_state(dtx))


@register_sharding(SSM_BWD_OP)
def _ssm_bwd_sharding(dtx, dta, b, c, state, dy, ds_out, block_d, chunk):
    """The forward's shardings; db, dc sum over channels, so over channels they are partial sums."""
    return [([R] * 5, [R, R, R, R, _opt(state, R), R, _opt(ds_out, R), None, None]),
            ([S0] * 5, [S0, S0, S0, S0, _opt(state, S0), S0, _opt(ds_out, S0), None, None]),
            ([S2, S2, Partial(), Partial(), S1], [S2, S2, R, R, _opt(state, S1), S2, _opt(ds_out, S1), None, None])]


def ssm_scan_fused(x, dt, a, b, c, state=None):
    """:func:`ssm_scan` of dtx = dt * x and dta = dt[..., None] * a, formed in the kernel.

    x/dt: (B, S, d); a: (d, N); b/c: (B, S, N); state: (B, d, N) or None.
    Returns (y (B, S, d) f32, final state (B, d, N) f32).  Selected and
    guarded as :func:`ssm_scan` is (the ssm_scan family, features (S, d)).
    On CPU tensors the plain version runs; on a CUDA tensor
    ``ssm_cuda_fused``, so the (B, S, d, N) dta is never formed.  With grad
    enabled and an operand that requires it, the call runs as the
    ``repro_torch::ssm_scan_fused`` op (:data:`SSM_FUSED_OP`), whose backward
    is the fused entry's backward kernel (no (B, S, d, N) tensor either); on
    DTensors or meta tensors it runs as that op too.
    """
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    args = (x, dt, a, b, c, None if state is None else state.contiguous())
    if _wants_grad(*args):
        return _ssm_fused_op(*args)
    if _through_op(*args):
        with _uncounted():
            return _ssm_fused_op(*args)
    return _ssm_fused_call(x, dt, a, b, c, state)[0]


def _ssm_fused_call(x, dt, a, b, c, state):
    """One selected, guarded fused scan: ((y, final state), the config it ran)."""
    _, s, d = x.shape
    rt = current_runtime()
    config, pin = _select(rt, "ssm_scan", (s, d), lambda: rt.select_ssm_config(s, d))
    run_ref = lambda: ssm_fused_plain(x, dt, a, b, c, state)
    if not _on_card(x):
        out = _guarded_call(rt, "ssm_scan", config, lambda cfg: run_ref(), run_ref, on_card=False, pin=pin)
        return out, config or DEFAULT_SSM_CONFIG
    run = _Run(lambda cfg: ssm_cuda_fused(x, dt, a, b, c, state, cfg), DEFAULT_SSM_CONFIG)
    return _guarded_call(rt, "ssm_scan", config, run, run_ref, on_card=True, pin=pin), run.config


@torch.library.custom_op("repro_torch::ssm_scan_fused", mutates_args=(),
                         schema="(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, Tensor? state) "
                                "-> (Tensor, Tensor)")
def _ssm_fused_op(x, dt, a, b, c, state):
    """``ops.ssm_scan_fused`` under grad as a dispatcher op: (y, final state);
    the config it ran is left in ``_phase.ran`` for the autograd setup."""
    _count(GRAD_SCANS, ("ssm_scan_fused", _phase.label))
    out, _phase.ran = _ssm_fused_call(x, dt, a, b, c, state)
    return _dense(*out)


SSM_FUSED_OP = torch.ops.repro_torch.ssm_scan_fused.default


@_ssm_fused_op.register_fake
def _ssm_fused_fake(x, dt, a, b, c, state):
    return _scan_fake(x, b)


@register_sharding(SSM_FUSED_OP)
def _ssm_fused_sharding(x, dt, a, b, c, state):
    """Over batch, or over channels (a's rows with them; b, c replicated)."""
    return [([R, R], [R, R, R, R, R, _opt(state, R)]),
            ([S0, S0], [S0, S0, R, S0, S0, _opt(state, S0)]),
            ([S2, S1], [S2, S2, S0, R, R, _opt(state, S1)])]


def _ssm_fused_backward(ctx, dy, ds_out):
    """The ``repro_torch::ssm_scan_fused_backward`` op under the forward's runtime."""
    x, dt, a, b, c, state = ctx.saved_tensors
    dy = _zeros_f32(x) if dy is None else dy
    with ctx.runtime.activate():
        grads = _ssm_fused_bwd_op(x, dt, a, b, c, state, dy, ds_out, ctx.config.block_d, ctx.config.chunk)
    return _only_needed(ctx, (*grads[:5], None if state is None else grads[5]))


_ssm_fused_op.register_autograd(_ssm_fused_backward, setup_context=_ssm_setup)


@torch.library.custom_op("repro_torch::ssm_scan_fused_backward", mutates_args=(),
                         schema="(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, Tensor? state, Tensor dy, "
                                "Tensor? ds_out, int block_d, int chunk) "
                                "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _ssm_fused_bwd_op(x, dt, a, b, c, state, dy, ds_out, block_d, chunk):
    """The fused entry's backward kernel at the forward's config, or on the CPU
    :func:`~repro_torch.kernels.ssm.ssm_fused_backward_plain` at its chunk.
    Returns (dx, d(dt), da, db, dc, d(state)); d(state) holds nothing without a state."""
    dy = dy.contiguous()
    ds_out = None if ds_out is None else ds_out.contiguous()
    config = SsmConfig(block_d, chunk)
    run_ref = lambda: ssm_fused_backward_plain(x, dt, a, b, c, state, dy, ds_out, chunk)
    run = lambda cfg: ssm_fused_backward_cuda(x, dt, a, b, c, state, dy, ds_out, cfg or DEFAULT_SSM_CONFIG)
    grads = _grad_call("ssm_scan_fused", "ssm_scan", config, run, run_ref, _on_card(x))
    return _dense(*grads[:5], grads[5] if state is not None else _no_state(x))


SSM_FUSED_BWD_OP = torch.ops.repro_torch.ssm_scan_fused_backward.default


@_ssm_fused_bwd_op.register_fake
def _ssm_fused_bwd_fake(x, dt, a, b, c, state, dy, ds_out, block_d, chunk):
    return (*(torch.empty_like(t) for t in (x, dt, a, b, c)),
            torch.empty_like(state) if state is not None else _no_state(x))


@register_sharding(SSM_FUSED_BWD_OP)
def _ssm_fused_bwd_sharding(x, dt, a, b, c, state, dy, ds_out, block_d, chunk):
    """The forward's shardings; da sums over the batch, db and dc over channels: partial sums there."""
    return [([R] * 6, [R, R, R, R, R, _opt(state, R), R, _opt(ds_out, R), None, None]),
            ([S0, S0, Partial(), S0, S0, S0], [S0, S0, R, S0, S0, _opt(state, S0), S0, _opt(ds_out, S0), None, None]),
            ([S2, S2, S0, Partial(), Partial(), S1],
             [S2, S2, S0, R, R, _opt(state, S1), S2, _opt(ds_out, S1), None, None])]

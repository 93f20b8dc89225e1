"""The port stands alone: no JAX, nothing of ``repro``, and CUDA by default."""
import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import TransformerLM, build_model

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 25  # every module of the package was imported
    assert bad == "[]"


def test_entry_points_default_to_cuda():
    cfg = registry.get("granite-8b").reduced()
    assert inspect.signature(TransformerLM).parameters["device"].default == "cuda"
    assert inspect.signature(build_model).parameters["device"].default == "cuda"
    assert build_model(cfg).device == torch.device("cuda")
    assert TransformerLM(cfg).device.type == "cuda"


def test_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "granite-8b", "--requests", "1"])


def test_served_path_calls_no_library_gemm():
    """Only the plain version may multiply with a library call; the served
    path goes through ops.matmul and the hand-written kernel."""
    pkg = SRC / "repro_torch"
    banned = ("torch.matmul", "F.linear", "scaled_dot_product_attention", "torch.compile", "cublas")
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{word} in {path.relative_to(pkg)}"
        matmuls = [n for n in ast.walk(ast.parse(text))
                   if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult)]
        assert not matmuls or path.name == "ref.py", f"@ in {path.relative_to(pkg)}"


def test_facade_is_lazy_and_imports_no_jax():
    """``import repro_torch`` pulls in neither torch nor the tuning stack; its
    names resolve to the port's own modules."""
    probe = ("import sys, repro_torch; assert 'torch' not in sys.modules, 'torch'; "
             "assert not any(m.startswith('repro_torch.core') for m in sys.modules); "
             "b = repro_torch.DeploymentBundle; rt = repro_torch.KernelRuntime; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
             "print(b.__module__, rt.__module__, bad)")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["repro_torch.core.bundle", "repro_torch.core.runtime", "[]"]


def test_chip_smoke_imports_nothing_of_the_reference():
    """The smoke script drives the port alone: no ``jax`` and no ``repro`` import."""
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "repro"}, names


_DIST_PROBE = """
import importlib, sys
import torch.distributed as dist
for name in ("repro_torch.dist.sharding", "repro_torch.launch.mesh", "repro_torch.launch.fleet",
             "repro_torch.launch.commanalysis", "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
             "repro_torch.launch.train", "repro_torch.train.trainer", "repro_torch.ckpt.checkpoint"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(dist.is_initialized(), bad)
"""


def test_distribution_modules_stand_alone_and_touch_no_group():
    """The distribution modules import neither JAX nor ``repro``, and importing them
    starts no process group (the dry run starts its fake one, the launcher its own)."""
    proc = subprocess.run([sys.executable, "-c", _DIST_PROBE], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "[]"]


def test_sharded_and_meta_operands_reach_only_the_dispatcher_ops(monkeypatch):
    """A meta operand (what the dry run's DTensors hold) runs the kernel ops' fake impls,
    never a plain version or a kernel wrapper."""
    from repro_torch.kernels import ops

    def refuse(*a, **k):
        raise AssertionError("a plain version or kernel wrapper saw a meta tensor")

    for name in ("matmul_plain", "matmul_cuda", "wkv_plain", "wkv_cuda", "ssm_plain", "ssm_cuda",
                 "ssm_fused_plain", "ssm_cuda_fused"):
        monkeypatch.setattr(ops, name, refuse)
    meta = lambda *shape: torch.empty(shape, device="meta")
    out = ops.matmul(meta(2, 8, 16), meta(16, 4), out_dtype=torch.float32)
    assert out.is_meta and out.shape == (2, 8, 4)
    o, s = ops.wkv(meta(1, 32, 2, 16), meta(1, 32, 2, 16), meta(1, 32, 2, 16), meta(1, 32, 2, 16), meta(2, 16))
    assert o.is_meta and o.shape == (1, 32, 2, 16) and s.shape == (1, 2, 16, 16)
    y, s = ops.ssm_scan_fused(meta(1, 8, 4), meta(1, 8, 4), meta(4, 3), meta(1, 8, 3), meta(1, 8, 3))
    assert y.shape == (1, 8, 4) and s.shape == (1, 4, 3)


def test_the_distribution_package_is_not_ignored():
    """``dist/`` in ``.gitignore`` once kept any directory of that name out of git;
    only the repository root's build output is ignored now."""
    lines = (SRC.parent / ".gitignore").read_text().splitlines()
    assert "dist/" not in lines and "/dist/" in lines

"""Which collectives a gloo group of two processes on one card runs on CUDA tensors.

  python3 scripts/gloo_cuda_collectives.py

For each collective, two fresh processes join a gloo group (``tcp`` on a free
local port), bind ``cuda:0``, run the collective once on CUDA tensors and print
the result; the parent prints each process's exit code (-11: SIGSEGV).  The
c10d calls (``dist.all_reduce``, ``all_gather_into_tensor``, ...), the
functional ones DTensor issues (``_functional_collectives``), a
``DeviceMesh`` on ``cuda``, and, for contrast, two calls on CPU tensors.
Phase 26b of ``chip_smoke.py`` runs on such a group; this shows which entry
points it can use as they are.
"""
import socket
import subprocess
import sys

CHECKS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "funcol_all_gather", "funcol_reduce_scatter", "funcol_all_reduce", "device_mesh",
          "cpu_all_gather_into_tensor", "cpu_reduce_scatter_tensor")


def child(check: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=2, init_method=f"tcp://127.0.0.1:{port}")
    x = torch.arange(8.0, device="cuda") + rank
    if check.startswith("cpu_"):
        x = x.cpu()
    if check == "all_reduce":
        dist.all_reduce(x)
        got = x
    elif check == "broadcast":
        dist.broadcast(x, 0)
        got = x
    elif check == "all_gather":
        got = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(got, x)
        got = torch.cat(got)
    elif check.endswith("all_gather_into_tensor"):
        got = x.new_empty(16)
        dist.all_gather_into_tensor(got, x)
    elif check.endswith("reduce_scatter_tensor"):
        got = x.new_empty(4)
        dist.reduce_scatter_tensor(got, x)
    elif check == "all_to_all_single":
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
    elif check == "funcol_all_gather":
        got = fc.all_gather_tensor(x, 0, dist.group.WORLD)
    elif check == "funcol_reduce_scatter":
        got = fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)
    elif check == "funcol_all_reduce":
        got = fc.all_reduce(x, "sum", dist.group.WORLD)
    else:  # device_mesh
        from torch.distributed.device_mesh import init_device_mesh

        got = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
    if isinstance(got, torch.Tensor):
        got = got.tolist()
    torch.cuda.synchronize()
    print(f"ok {got}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    for check in CHECKS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, check, str(r), str(port)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=60)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            outs = ["timed out", "timed out"]
        for r, (p, out) in enumerate(zip(procs, outs)):
            last = [ln for ln in out.splitlines() if ln.startswith("ok ")]
            print(f"{check} rank {r}: exit {p.returncode} {last[-1] if last else out[-200:]!r}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())

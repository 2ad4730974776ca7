"""What ``torch.distributed`` offers two processes that share one card.

    python -m laudnet_tpu_torch.tools.probe_dist

Starts two processes on card 0 and records, for each collective the
parallel module runs (``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``send``/``recv``,
and the tensor-parallel int8 products' ``all_reduce`` with ``ReduceOp.MAX``
on f32 and the SUM of int32),
whether gloo takes it on CUDA tensors and gives the right answer, and the
same for what FSDP2 asks of the data group over two ranks (a
reduce-scatter with ``ReduceOp.AVG``, an all-gather issued on a side
stream, and one step of a ``fully_shard`` model whose gradients are held
to one process on the whole batch); then
whether NCCL accepts two ranks on the one device. Prints a JSON line
with the card's name and power limit, then NCCL's. Each trial runs in two
processes of its own, all gloo trials at once, killed at a time limit, so
one that hangs is recorded as such.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "send_recv", "all_reduce_max", "all_reduce_int32")
FSDP_TRIALS = ("reduce_scatter_avg", "all_gather_side_stream", "fsdp2_step")


def _trial(backend: str, name: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        ok = x.eq(3).all()
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        ok = x.eq(2).all()
    elif name == "all_reduce_int32":
        n = torch.full((4,), 2 ** 24 + 1 - rank, dtype=torch.int32,
                       device=dev)
        dist.all_reduce(n)          # 2^25 + 1: exact in int32, not in f32
        ok = n.eq(2 ** 25 + 1).all()
    elif name == "broadcast":
        dist.broadcast(x, src=1)
        ok = x.eq(2).all()
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = torch.cat(parts).eq(torch.tensor([1.0] * 4 + [2.0] * 4,
                                              device=dev)).all()
    elif name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = out.eq(torch.tensor([1.0] * 4 + [2.0] * 4, device=dev)).all()
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = out.eq(3).all()
    elif name == "reduce_scatter_avg":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.AVG)
        ok = out.eq(1.5).all()
    elif name == "all_gather_side_stream":
        out = torch.empty(8, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dist.all_gather_into_tensor(out, x, async_op=True).wait()
        torch.cuda.current_stream().wait_stream(side)
        ok = out.eq(torch.tensor([1.0] * 4 + [2.0] * 4, device=dev)).all()
    elif name == "fsdp2_step":
        ok = _fsdp2_step(rank, dev)
    else:
        if rank == 0:
            dist.send(x, dst=1)
            ok = torch.tensor(True)
        else:
            dist.recv(x, src=0)
            ok = x.eq(1).all()
    torch.cuda.synchronize()
    ok = bool(ok)
    dist.barrier()  # neither rank leaves while the other still reads
    if not ok:
        raise AssertionError(f"{name}: wrong result {x.tolist()}")
    dist.destroy_process_group()


def _fsdp2_step(rank: int, dev) -> "torch.Tensor":
    """One forward and backward of a two-layer MLP under ``fully_shard``
    over the two ranks, each on its half of a batch: its gradients against
    the same MLP's on the whole batch in this process."""
    import copy

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                                torch.nn.Linear(256, 8)).to(dev)
    ref = copy.deepcopy(model)
    x = torch.randn(16, 64, device=dev)
    ref(x).square().mean().backward()
    fully_shard(model, mesh=init_device_mesh("cuda", (2,)))
    model(x[8 * rank:8 * rank + 8]).square().mean().backward()
    worst = max(float((p.grad.full_tensor() - q.grad).abs().max())
                for p, q in zip(model.parameters(), ref.parameters()))
    return torch.tensor(worst < 1e-5)


def _start(backend: str, name: str):
    from laudnet_tpu_torch.parallel.mesh import free_port

    port = free_port()
    code = ("from laudnet_tpu_torch.tools.probe_dist import _trial; "
            f"_trial({backend!r}, {name!r}, {{rank}}, {port})")
    return [subprocess.Popen([sys.executable, "-c", code.format(rank=r)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ))
            for r in range(2)]


def _verdict(procs, deadline: float, timeout: float) -> str:
    outs, hung = [], False
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            hung = True
            p.kill()
            outs.append(p.communicate()[0])
    if hung:
        return f"hung (killed after {timeout:.0f} s)"
    if all(p.returncode == 0 for p in procs):
        return "ok"
    said = []
    for rank, out in enumerate(outs):  # each rank's last error line
        lines = [ln.strip() for ln in out.splitlines()
                 if "Error" in ln or "error" in ln]
        if lines:
            said.append(f"rank {rank}: {lines[-1][:240]}")
    return "fails: " + ("; ".join(said) or
                        f"exit codes {[p.returncode for p in procs]}")


def trials(backend: str, names=COLLECTIVES, timeout: float = 60) -> dict:
    """``{name: 'ok' or what went wrong}`` for each collective over
    ``backend`` on two processes sharing card 0; the trials run at once,
    each pair in processes of its own."""
    started = {n: _start(backend, n) for n in names}
    deadline = time.monotonic() + timeout
    return {n: _verdict(procs, deadline, timeout)
            for n, procs in started.items()}


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    import torch

    gloo = trials("gloo", COLLECTIVES + FSDP_TRIALS)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "gloo_on_cuda": gloo}), flush=True)
    print(json.dumps({"nccl_two_ranks_one_card": trials(
        "nccl", ("all_reduce",))["all_reduce"]}), flush=True)


if __name__ == "__main__":
    main()

"""Which torch.distributed ops gloo runs on CUDA tensors, read on the card.

Two ranks share cuda:0 over gloo (the port's case on a one-card machine,
immunostruct_tpu_torch/parallel/mesh.py). For each op, a fresh pair of
ranks runs it once on CUDA tensors and checks the result against the sum,
gather or exchange it should give. Each op gets its own ranks because a
rank whose op hands the transport a device pointer may die or leave its
peer waiting (the collectives time out after 20 s). Prints one line an op
(ok, the error it raised, or how its ranks ended) and, last, one JSON
object {op: "ok" | "..."}.

  python scripts/gloo_cuda_ops.py        (needs one CUDA device)

immunostruct_tpu_torch/parallel/collectives.py::GLOO_CUDA_OPS names the
ops found ok; the others are staged through pinned host memory there.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OPS = ("broadcast", "all_reduce", "reduce", "all_gather",
       "all_gather_into_tensor", "gather", "scatter", "reduce_scatter_tensor",
       "all_to_all_single", "send/recv", "isend/irecv")


def _run(op: str, rank: int, t: torch.Tensor):
    n = dist.get_world_size()
    if op == "broadcast":
        dist.broadcast(t, src=0)
        return torch.equal(t, torch.zeros_like(t))
    if op == "all_reduce":
        dist.all_reduce(t)
        return torch.equal(t, torch.full_like(t, 1.0))
    if op == "reduce":
        dist.reduce(t, dst=0)
        return rank != 0 or torch.equal(t, torch.full_like(t, 1.0))
    if op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return all(torch.equal(p, torch.full_like(t, float(i)))
                   for i, p in enumerate(parts))
    if op == "all_gather_into_tensor":
        out = torch.empty(n * t.numel(), device=t.device)
        dist.all_gather_into_tensor(out, t)
        return all(torch.equal(part, torch.full_like(t, float(i)))
                   for i, part in enumerate(out.view(n, -1)))
    if op == "gather":
        parts = [torch.empty_like(t) for _ in range(n)] if rank == 0 else None
        dist.gather(t, parts, dst=0)
        return rank != 0 or all(torch.equal(p, torch.full_like(t, float(i)))
                                for i, p in enumerate(parts))
    if op == "scatter":
        parts = ([torch.full_like(t, float(i)) for i in range(n)]
                 if rank == 0 else None)
        out = torch.empty_like(t)
        dist.scatter(out, parts, src=0)
        return torch.equal(out, torch.full_like(t, float(rank)))
    if op == "reduce_scatter_tensor":
        inp = torch.cat([t] * n)
        out = torch.empty_like(t)
        dist.reduce_scatter_tensor(out, inp)
        return torch.equal(out, torch.full_like(t, 1.0))
    if op == "all_to_all_single":
        out = torch.empty(n * t.numel(), device=t.device)
        dist.all_to_all_single(out, t.repeat(n))
        return torch.equal(out.view(n, -1)[1 - rank],
                           torch.full_like(t, float(1 - rank)))
    peer = 1 - rank
    recv = torch.empty_like(t)
    if op == "send/recv":
        if rank == 0:
            dist.send(t, peer)
            dist.recv(recv, peer)
        else:
            dist.recv(recv, peer)
            dist.send(t, peer)
    else:
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                        dist.P2POp(dist.irecv, recv, peer)])
        for w in works:
            w.wait()
    return torch.equal(recv, torch.full_like(t, float(peer)))


def probe(rank: int, op: str) -> str:
    t = torch.full((1024,), float(rank), device="cuda")
    try:
        ok = _run(op, rank, t)
        torch.cuda.synchronize()
    except Exception as e:          # the error is the reading
        return f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return "ok" if ok else "ran, wrong result"


def main() -> int:
    from immunostruct_tpu_torch.parallel.dryrun import spawn

    if not torch.cuda.is_available():
        print("gloo_cuda_ops: torch finds no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    table = {}
    for op in OPS:
        try:
            ranks = spawn(probe, 2, op, device="cuda", timeout_s=20)
            table[op] = ranks[0] if ranks[0] == ranks[1] else \
                f"rank 0: {ranks[0]}; rank 1: {ranks[1]}"
        except Exception as e:      # a rank that died is the reading too
            table[op] = f"ranks ended: {type(e).__name__}: " \
                        f"{str(e).splitlines()[0][:160]}"
        print(f"{op}: {table[op]}", flush=True)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Can two processes of one NCCL communicator share one card?

    python tools/torch_nccl_one_card_probe.py

Starts two processes, each calling ``torch.distributed.init_process_group
("nccl")`` on ``cuda:0`` with a localhost rendezvous and then one
``all_reduce`` of a one-element tensor, and prints one JSON line: each
rank's outcome (``ok`` with the reduced value, or the exception's type and
first line). NCCL is expected to refuse ("Duplicate GPU detected"); the
port's pod (drep_tpu_torch/parallel/mesh.py) exchanges host arrays over
gloo for that reason. Needs one CUDA card; stops both processes.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import socket
import sys


def _member(rank: int, port: int, out) -> None:
    import torch

    try:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                             rank=rank)
        x = torch.ones(1, device="cuda:0")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        out.put((rank, {"ok": True, "value": float(x.item())}))
    except Exception as e:  # noqa: BLE001 — the outcome is the probe's result
        out.put((rank, {"ok": False, "error": type(e).__name__, "message": str(e).strip().splitlines()[0][:300]}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nccl_one_card_probe.py: no CUDA device", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_member, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        for _ in procs:
            rank, res = out.get(timeout=180)
            results[rank] = res
    except Exception as e:  # noqa: BLE001 — a hung rank is a result too
        results["timeout"] = type(e).__name__
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    print(json.dumps({"probe": "nccl_two_ranks_one_card", "card": torch.cuda.get_device_name(0),
                      "cards": torch.cuda.device_count(), "nccl": torch.cuda.nccl.version(),
                      "ranks": {str(k): v for k, v in sorted(results.items(), key=str)},
                      "env": {k: os.environ.get(k) for k in ("NCCL_DEBUG",)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

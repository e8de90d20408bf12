"""Launcher — ``python -m apex_tpu_torch.parallel.multiproc script.py
[args...]``.

Counterpart of ``apex_tpu/parallel/multiproc.py`` with its command line
(``--nnodes``, ``--node_rank``, ``--coordinator``, the script and its
arguments).  In PyTorch one process drives one card, so this launcher, like
the reference Apex launcher (``apex/parallel/multiproc.py``), starts one
rank of the script per local device, with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set; the JAX one execs
the script once per host.  A launched script calls
:func:`~apex_tpu_torch.parallel.mesh.initialize_distributed` with no rank
arguments.

- single node (default): ranks rendezvous on ``localhost`` at a free port;
  stale cluster variables of a previous multi-node shell are cleared first.
- ``--nnodes N --node_rank i --coordinator host:port``: node ``i`` starts
  ranks ``i * per_node ... (i + 1) * per_node - 1`` against the
  coordinator, which node 0 serves.

``--nproc_per_node`` (default: the number of visible CUDA devices, 1
without any) sets the ranks a node starts, e.g. gloo ranks on the CPU.
The launcher waits for its ranks; when one fails it stops the others and
exits with that rank's code.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

#: cluster variables a single-node launch clears (the JAX launcher's, and
#: the ones this launcher sets)
_CLUSTER_ENV = ("APEX_TPU_COORDINATOR_ADDRESS", "APEX_TPU_NUM_PROCESSES",
                "APEX_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "NODE_RANK")


def _local_devices() -> int:
    try:
        import torch
        return torch.cuda.device_count() if torch.cuda.is_available() else 1
    except ImportError:                  # pragma: no cover
        return 1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(args, local_rank: int, per_node: int, base=None) -> dict:
    """The environment of local rank ``local_rank`` of this node."""
    env = dict(os.environ if base is None else base)
    if args.nnodes > 1:
        host, _, port = args.coordinator.rpartition(":")
        env["MASTER_ADDR"], env["MASTER_PORT"] = host, port
        env["APEX_TPU_COORDINATOR_ADDRESS"] = args.coordinator
        env["APEX_TPU_NUM_PROCESSES"] = str(args.nnodes)
        env["APEX_TPU_PROCESS_ID"] = str(args.node_rank)
    env.update(RANK=str(args.node_rank * per_node + local_rank),
               WORLD_SIZE=str(args.nnodes * per_node),
               LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(per_node),
               NODE_RANK=str(args.node_rank))
    return env


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "apex_tpu_torch.parallel.multiproc",
        description="launch a training script, one rank per local device")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of node 0 (multi-node only)")
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="ranks this node starts (default: its CUDA "
                        "devices)")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    per_node = (args.nproc_per_node if args.nproc_per_node is not None
                else _local_devices())
    if per_node < 1:
        parser.error("--nproc_per_node must be at least 1")
    base = dict(os.environ)
    if args.nnodes > 1:
        if not args.coordinator or ":" not in args.coordinator:
            parser.error("--coordinator host:port required when --nnodes "
                         "> 1")
    else:
        # a single-node launch must not dial a dead coordinator left in
        # the environment by a previous multi-node shell
        for var in _CLUSTER_ENV:
            base.pop(var, None)
        base["MASTER_ADDR"] = "localhost"
        base["MASTER_PORT"] = str(_free_port())

    procs = [subprocess.Popen(
        [sys.executable, args.script] + args.script_args,
        env=rank_env(args, i, per_node, base)) for i in range(per_node)]
    code = 0
    try:
        running = list(procs)
        while running:
            for p in list(running):
                rc = p.poll()
                if rc is None:
                    continue
                running.remove(p)
                if rc != 0 and code == 0:
                    code = rc
                    for q in running:
                        q.terminate()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return code


if __name__ == "__main__":
    sys.exit(main())

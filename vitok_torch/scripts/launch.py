"""Launch helper: the ``torchrun`` command line of a training or eval CLI.

The counterpart of the JAX package's ``scripts/tpu/launch.py``, which
prints (and runs) the gcloud commands of a TPU pod. Here a host's cards are
the processes ``torchrun`` starts, one a card; this prints the command,
and with ``--run`` executes it. Nothing here calls a cloud.

    python -m vitok_torch.scripts.launch --nproc-per-node 4 -- \\
        train_vae --variant Ld4-Ld24/1x16x64 --data /imgs --bs 8 --mesh data=2,fsdp=2
    python -m vitok_torch.scripts.launch --nnodes 2 --node-rank 0 --master-addr 10.0.0.1 \\
        --nproc-per-node 8 --run -- train_highres --data /imgs --sw 1024 --res 4096

One node takes ``--standalone`` (torchrun picks a free local port); several
take ``--master-addr``/``--master-port`` and run the same command on every
node with its ``--node-rank``.
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import List, Optional

CLIS = ("train_vae", "train_dit", "train_highres", "eval_vae", "generate", "tokenize_data", "dryrun_multiprocess")


def torchrun_command(cli: str, cli_args: List[str], nproc_per_node: int, nnodes: int = 1, node_rank: int = 0,
                     master_addr: Optional[str] = None, master_port: int = 29500) -> List[str]:
    """``[python, -m, torch.distributed.run, ..., -m, vitok_torch.scripts.<cli>, args...]``."""
    if cli not in CLIS:
        raise SystemExit(f"unknown CLI {cli!r}; one of {CLIS}")
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={nproc_per_node}"]
    if nnodes == 1:
        cmd.append("--standalone")
    else:
        if not master_addr:
            raise SystemExit("--nnodes > 1 needs --master-addr (the first node's address)")
        cmd += [f"--nnodes={nnodes}", f"--node-rank={node_rank}", f"--master-addr={master_addr}",
                f"--master-port={master_port}"]
    return cmd + ["-m", f"vitok_torch.scripts.{cli}", *cli_args]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc-per-node", type=int, default=None,
                    help="processes (cards) on this node (default: the cards torch sees)")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node-rank", type=int, default=0)
    ap.add_argument("--master-addr", default=None)
    ap.add_argument("--master-port", type=int, default=29500)
    ap.add_argument("--run", action="store_true", help="execute the command (default: print it)")
    ap.add_argument("command", nargs=argparse.REMAINDER, help="-- <cli> [its arguments]")
    args = ap.parse_args(argv)
    rest = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not rest:
        ap.error("give the CLI after --, e.g. -- train_vae --data /imgs")
    nproc = args.nproc_per_node
    if nproc is None:
        import torch

        nproc = max(torch.cuda.device_count(), 1)
    cmd = torchrun_command(rest[0], rest[1:], nproc, args.nnodes, args.node_rank, args.master_addr,
                           args.master_port)
    print(shlex.join(cmd), flush=True)
    if not args.run:
        return 0
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())

"""A process per card, and the process group from the launcher's
environment (counterpart of ``apex_tpu/parallel/multiproc.py``).

    python -m apex_tpu_torch.parallel.multiproc [--nproc N] script.py args

starts N copies of ``script.py`` (default 2) with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` (``localhost``) and
``MASTER_PORT`` (``$MASTER_PORT`` or 29500) set, waits for all, and
exits with the first non-zero code. In the script,
:func:`init_distributed` joins the group: NCCL where there is a card for
every rank, else gloo (on one card, gloo stages a CUDA tensor's
all-reduce through the host), at ``tcp://MASTER_ADDR:MASTER_PORT``, and
on the card sets this rank's device.
"""

import os
import subprocess
import sys


def init_distributed(backend=None):
    """Join the process group the launcher's environment describes;
    returns False (and does nothing) outside the launcher."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    import torch
    import torch.distributed as dist

    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda and torch.cuda.device_count() >= world \
            else "gloo"
    if cuda:
        torch.cuda.set_device(local % torch.cuda.device_count())
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return True


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc = 2
    if argv and argv[0] == "--nproc":
        nproc = int(argv[1])
        argv = argv[2:]
    if not argv:
        print(__doc__)
        sys.exit(1)
    port = os.environ.get("MASTER_PORT", "29500")
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable] + argv, env=env))
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()

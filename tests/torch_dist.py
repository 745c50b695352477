"""Runs the port's multi-rank scenarios in gloo processes on the CPU.

``run_ranks(world, scenarios, tmp_dir)`` starts ``world`` Python processes
running this file, each one rank of a gloo process group (the rendezvous a
localhost port found by binding port 0), which run the named functions of
``tests/torch_dist_scenarios.py`` in turn and pickle what each returns.
Every group has a deadline of its own: the ranks join with a 60 s timeout
(``init_process_group(timeout=...)``) and the launcher waits at most
``deadline`` seconds, then kills every rank and fails, so a hung
rendezvous or collective cannot run the suite into its time limit. The
ranks import torch and the port, never JAX.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(world: int, scenarios, tmp_dir: str, deadline: float = 150.0):
    """[(name, kwargs)] run on every rank -> {name: [rank 0's value, ...]}."""
    return start_ranks(world, scenarios, tmp_dir, deadline)()


def start_ranks(world: int, scenarios, tmp_dir: str, deadline: float = 150.0):
    """Start the ranks; returns the function that waits for them (within
    ``deadline`` of the start) and gives ``run_ranks``'s value."""
    job = os.path.join(tmp_dir, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(scenarios, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world), str(port), job, tmp_dir],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + deadline
    return lambda: _wait(procs, logs, end, world, tmp_dir, deadline)


def _wait(procs, logs, end, world, tmp_dir, deadline):
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(tmp_dir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n" + f.read()[-4000:])
        raise AssertionError(f"ranks {failed} of {world} failed or passed the {deadline:.0f}-s deadline:\n"
                             + "\n".join(tails))
    out = {}
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"out{rank}.pkl"), "rb") as f:
            for name, value in pickle.load(f).items():
                out.setdefault(name, []).append(value)
    return out


def _rank_main(rank: int, world: int, port: int, job: str, out_dir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from tests import torch_dist_scenarios

    with open(job, "rb") as f:
        scenarios = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    try:
        for name, kwargs in scenarios:
            results[name] = getattr(torch_dist_scenarios, kwargs.get("fn", name))(
                **{k: v for k, v in kwargs.items() if k != "fn"})
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

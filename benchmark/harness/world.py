"""The processes of one run: one, or one per card joined by torch.distributed.

A cell on one card runs in the process the driver starts (:class:`Solo`):
no process group, no collective and no synchronise beyond the run's own.

A cell on N > 1 cards runs as a world of N processes, one per card
(:class:`World`).  The process the driver starts is rank 0.  It loads the
program's kernels (building them where the checkout has none yet), then
starts ranks 1 … N−1 as its children: the same command, with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and a
free ``MASTER_PORT`` in their environment, and each rank's share of the
host's cores.  Every rank joins through the program's
``cora_tpu_torch.parallel.initialize`` (NCCL with one card a rank on CUDA,
gloo on the CPU), whose collectives fail after ``timeout_s``.  Rank 0
watches its children: one that exits with an error ends the run at once,
the others killed; a child dies with rank 0 (the parent-death signal).

In a world the window runs in lockstep (:meth:`World.go_on`: one broadcast
a unit), counts are summed and peaks taken over the ranks after it, and the
records the check keeps are gathered to rank 0 with what it keeps of each
unit (:meth:`World.collect`).  Only rank 0 reports.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

import torch

TIMEOUT_S = 120
LEAD_PID = "CORA_BENCH_LEAD_PID"  # in a child's environment: rank 0's process id


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def join(chips, device, timeout_s=TIMEOUT_S):
    """The processes of a run of a cell on ``chips`` cards: this one on
    ``device``, or a world of one process a card of its type."""
    if int(chips) == 1:
        return Solo(device)
    return World(int(chips), torch.device(device).type, timeout_s)


class Solo:
    """A run in the one process the driver started, on ``device``."""

    lead, ok = True, True

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def meet(self, t):
        return t

    def go_on(self, flag):
        return flag

    def total(self, n):
        return n

    def highest(self, n):
        return n

    def collect(self, records):
        return [rec for _, rec in records]

    def leave(self):
        pass


class World:
    """Rank ``rank`` of a world of ``size`` processes, one per card of
    ``device_type`` (the CPU: gloo, for the tests), on ``device``."""

    def __init__(self, size, device_type, timeout_s=TIMEOUT_S):
        self.size = size
        self.children = []
        self.ok = True
        cores = max(1, len(os.sched_getaffinity(0)) // size)
        torch.set_num_threads(cores)
        if LEAD_PID in os.environ:
            _die_with(int(os.environ[LEAD_PID]))
        else:
            if device_type == "cuda":
                _load_kernels()
            self._start_children(device_type, cores)
        # the check's card-to-card sends run once, after the window
        os.environ.setdefault("TORCH_NCCL_SHOW_EAGER_INIT_P2P_SERIALIZATION_WARNING", "false")
        try:
            from cora_tpu_torch.parallel import distributed

            distributed.initialize(device=device_type, timeout=timedelta(seconds=timeout_s))
        except BaseException:
            self._end_children()
            raise
        import torch.distributed as dist

        self.dist = dist
        self.rank = dist.get_rank()
        self.lead = self.rank == 0
        self.device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                       if device_type == "cuda" else torch.device("cpu"))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    # --- the processes --------------------------------------------------

    def _start_children(self, device_type, cores):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        shared = dict(WORLD_SIZE=str(self.size), LOCAL_WORLD_SIZE=str(self.size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env = dict(os.environ, **shared, OMP_NUM_THREADS=str(cores),
                   **{LEAD_PID: str(os.getpid())})
        for r in range(1, self.size):
            p = subprocess.Popen([sys.executable] + sys.argv, stdin=subprocess.DEVNULL,
                                 stdout=2, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            self.children.append(p)
            print(f"world: rank {r} is process {p.pid}", file=sys.stderr, flush=True)
        os.environ.update(shared, RANK="0", LOCAL_RANK="0")
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        """End the run as soon as a child exits with an error."""
        while True:
            codes = [p.poll() for p in self.children]
            for r, code in enumerate(codes, 1):
                if code not in (None, 0):
                    print(f"world: rank {r} exited with code {code}; ending the run",
                          file=sys.stderr, flush=True)
                    self._end_children()
                    os._exit(3)
            if None not in codes:
                return
            time.sleep(0.2)

    def _end_children(self):
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            p.wait()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        """Rank 0 waits for its children (and kills them where the run
        failed); ``ok`` says whether every rank ended well."""
        if exc_type is not None:
            self._end_children()
            return False
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.children:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"world: process {p.pid} did not end; killed", file=sys.stderr)
                self._end_children()
        self.ok = all(p.returncode == 0 for p in self.children)
        return False

    # --- the collectives ------------------------------------------------

    def _reduce(self, value, op):
        x = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        self.dist.all_reduce(x, op=op)
        return x.item()

    def meet(self, t):
        """Every rank here, its card idle; rank 0's clock after the meeting."""
        _sync(self.device)
        self._reduce(0, self.dist.ReduceOp.SUM)
        return time.perf_counter()

    def go_on(self, flag):
        """Rank 0's ``flag``, on every rank."""
        x = torch.tensor([int(bool(flag))], device=self.device)
        self.dist.broadcast(x, 0)
        return bool(x.item())

    def total(self, n):
        """The sum of ``n`` over the ranks; rank 0 writes each rank's part."""
        parts = [torch.zeros(1, dtype=torch.int64, device=self.device)
                 for _ in range(self.size)]
        self.dist.all_gather(parts, torch.tensor([int(n)], device=self.device))
        parts = [int(p.item()) for p in parts]
        if self.lead:
            print(f"world: maps by rank {parts}", file=sys.stderr, flush=True)
        return sum(parts)

    def highest(self, n):
        return self._reduce(n, self.dist.ReduceOp.MAX)

    def collect(self, records):
        """Every rank's ``records`` ([(unit, record)], each record with what
        the check keeps of its unit under ``kept``, a dict of tensors) on
        rank 0, in unit order, each with the rank that held it; None on the
        other ranks.  The record's own tensors travel on the host; each
        rank's distinct kept tensors once, card to card."""
        dist = self.dist
        kept, meta = {}, []
        for k, rec in records:
            refs = {n: kept.setdefault(id(t), (len(kept), t))[0]
                    for n, t in rec["kept"].items()}
            rest = {n: v.cpu() if torch.is_tensor(v) else v
                    for n, v in rec.items() if n != "kept"}
            meta.append((k, rest, refs))
        mine = [t for _, t in sorted(kept.values(), key=lambda jt: jt[0])]
        every = [None] * self.size
        dist.all_gather_object(every, (meta, [(tuple(t.shape), t.dtype) for t in mine]))
        got = {0: mine}
        for h in range(1, self.size):
            if self.rank == h:
                for t in mine:
                    dist.send(t.contiguous(), dst=0)
            elif self.lead:
                got[h] = [torch.empty(shape, dtype=dtype, device=self.device)
                          for shape, dtype in every[h][1]]
                for buf in got[h]:
                    dist.recv(buf, src=h)
        if not self.lead:
            return None
        out = sorted(((k, h, dict(rec, kept={n: got[h][j] for n, j in refs.items()}))
                      for h, (meta_h, _) in enumerate(every) for k, rec, refs in meta_h),
                     key=lambda khr: khr[0])
        for k, h, rec in out:
            z = rec["z_lo"]
            print(f"world: unit {k}, channels {z}-{z + rec['channels'] - 1} "
                  f"checked from rank {h}", file=sys.stderr, flush=True)
        return [rec for _, _, rec in out]

    def leave(self):
        """Leave the process group, all ranks together, after the last
        collective."""
        _sync(self.device)
        self.dist.destroy_process_group()


def _die_with(pid):
    """Have the kernel end this process when its parent does (Linux), and
    end it now if rank ``pid`` is already gone."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != pid:
        os._exit(3)


def _load_kernels():
    """Build (where the checkout has none yet) and load every kernel of the
    program, so that the ranks started next never build at once."""
    from cora_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    _build.build(names)
    for name in names:
        _build.load(name)

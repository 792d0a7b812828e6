"""One run of one cell: set-up, the measured window, the check, the metrics.

In a world of several processes (:mod:`harness.world`) every rank runs
this, its own card: the same units in lockstep, each rank's own rows of
every unit; rank 0 alone profiles, checks and reports."""

from __future__ import annotations

import contextlib
import subprocess
import time
import types

import numpy as np
import torch

from reference.rings import ring_pixels, sample_rings

from . import check, config, stats
from .trace import profiled
from .world import Solo, _sync

GIB = 1024.0**3


def power_limit_w():
    """The card's power limit in W by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """A run of ``cell`` (:class:`harness.spec.Cell`) from ``seed`` for
    ``seconds``, traced or not, on ``device``; ``t_start`` is the process's
    start on the ``time.perf_counter`` clock; ``world``: the run's processes
    (:mod:`harness.world`), by default this one alone."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, world=None):
        self.cell = cell
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.world = world or Solo(device)
        self.device = torch.device(device)
        self.t_start = t_start
        self.cfg = config.resolve(cell.config)
        self.traffic = cell.traffic
        self.fchunk = min(int(self.traffic["fchunk"]), self.cfg["nz"])
        self.sample(seed)

    def sample(self, seed):
        """Draw from ``seed`` what the check samples: rings, multipoles, the
        units whose roots are kept; forget the units run so far."""
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        chk = self.traffic["check"]
        self.rings = sample_rings(self.cfg["nside"], int(chk["rings"]), rng)
        self.ells = check.sample_ells(self.cfg["lmax"], int(chk["ells"]), rng)
        self.keep = set(rng.choice(int(chk["pool"]), size=int(chk["units"]),
                                   replace=False).tolist())
        self.pix = None
        self.units = 0
        self.kept = {}
        self.last = None
        self.maps = 0

    # --- the window -----------------------------------------------------

    def _checked_chunk(self, k):
        """z_lo of the chunk of unit k whose pixels are kept for the check."""
        nblk = self.cfg["nz"] // self.fchunk
        pick = np.random.default_rng([self.seed, k]).integers(nblk)
        return int(pick) * self.fchunk

    def run_unit(self, k, chunk_ms, limit=None):
        """Run unit k (None: the warm-up) to its end, or its first ``limit``
        chunks; every chunk ends in a synchronise."""
        seed = self.seed if k is None else self.seed + 1 + k
        z_check = -1 if k is None else self._checked_chunk(k)
        rec = None
        gen = self.entry.unit(self.state, seed)
        n = 0
        while limit is None or n < limit:
            t0 = time.perf_counter()
            try:
                z_lo, maps = next(gen)
            except StopIteration:
                break
            if self.pix is None:
                self.pix = torch.from_numpy(
                    ring_pixels(self.cfg["nside"], self.rings)).to(maps.device)
            if z_lo <= z_check < z_lo + maps.shape[0]:
                i = z_check - z_lo
                rec = dict(seed=seed, z_lo=z_check, rings=self.rings,
                           pixels=maps[i:i + self.fchunk].index_select(-1, self.pix))
            _sync(self.device)
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            self.maps += maps.shape[0]
            n += 1
        gen.close()
        return rec

    def _window(self, seconds, chunk_ms):
        """Whole units until ``seconds`` have passed on rank 0's clock; this
        rank's (maps, start, end).  A rank keeps the record of a unit only
        where it holds the checked chunk."""
        maps0 = self.maps
        t0 = self.world.meet(time.perf_counter())
        while True:
            k = self.units
            self.last = self.run_unit(k, chunk_ms)
            if k in self.keep and self.last is not None:
                self.kept[k] = dict(self.last, roots=self.entry.keep_roots(self.state))
            self.units += 1
            t1 = time.perf_counter()
            if not self.world.go_on(t1 - t0 < seconds):
                return self.maps - maps0, t0, self.world.meet(t1)

    # --- the run --------------------------------------------------------

    def setup(self):
        """The entry's set-up and one warm-up unit (or its first chunks)."""
        self.entry = self.cell.entry()
        self.state = self.entry.setup(types.SimpleNamespace(
            cfg=self.cfg, traffic=self.traffic, device=self.device))
        self.run_unit(None, [], limit=self.traffic.get("warmup_chunks"))
        _sync(self.device)
        self.maps = 0

    def execute(self):
        """The run; its result on rank 0, None on the other ranks."""
        world = self.world
        self.setup()
        setup_s = world.meet(time.perf_counter()) - self.t_start

        chunk_ms = []
        layer = {}
        if self.trace:
            from cora_tpu_torch.util import profiling

            holder = {}
            with profiled(holder) if world.lead else contextlib.nullcontext():
                maps_a, a0, a1 = self._window(self.seconds / 2, chunk_ms)
            profiling.enable(world.lead)
            maps_b, b0, b1 = self._window(self.seconds / 2, chunk_ms)
            stage_times = dict(profiling.stage_times)
            profiling.enable(False)
            maps_a, maps_b = world.total(maps_a), world.total(maps_b)
            layer = dict(trace=holder.get("trace"), maps_traced=maps_a, maps_staged=maps_b,
                         stage_times=stage_times, chips=self.cell.chips)
            maps, w0, w1 = maps_a + maps_b, a0, b1
        else:
            maps, w0, w1 = self._window(self.seconds, chunk_ms)
            maps = world.total(maps)
        _sync(self.device)
        cuda = self.device.type == "cuda"
        peak = world.highest(torch.cuda.max_memory_allocated(self.device) if cuda else 0)
        attempted = maps

        if self.last is not None:
            self.last["roots"] = self.entry.keep_roots(self.state, last=True)
        self.entry.release(self.state)
        self.state = None
        if cuda:
            torch.cuda.empty_cache()
        # this rank's checked units: the kept ones but the last, and the last
        mine = [(k, self.kept[k]) for k in sorted(self.kept) if k < self.units - 1]
        if self.last is not None:
            mine.append((self.units - 1, self.last))
        checked = world.collect(mine)
        world.leave()
        if not world.lead:
            return None
        numbers = check.compare(self.cfg, checked, lambda u: u["roots"], self.ells,
                                self.device)
        correct, rows = check.judge(numbers, self.cell.limits)

        e2e = dict(maps_per_s=stats.rate(maps, w0, w1),
                   chunk_p95_ms=stats.percentile(chunk_ms, 95),
                   peak_mem_gib=peak / GIB, setup_s=setup_s)
        metrics = {}
        if self.trace:
            rctx = types.SimpleNamespace(cfg=self.cfg, traffic=self.traffic,
                                         fchunk=self.fchunk, **layer)
            for m in self.cell.per_layer:
                v = self.cell.reader(m).read(rctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in self.cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

        device = dict(platform="gpu" if cuda else self.device.type,
                      kind=torch.cuda.get_device_name(self.device) if cuda else "cpu",
                      count=self.cell.chips, memory_peak_bytes=int(peak),
                      power_limit_w=power_limit_w() if cuda else None)
        out = dict(correct=correct, attempted=attempted, failed=0, metrics=metrics,
                   device=device)
        if self.trace:
            tr = layer["trace"]
            device.update(busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = dict(device_ops=tr.top_device_ops(),
                                    idle_gaps=tr.top_idle_gaps())
        out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
        return out

"""Open loop: single-subject requests, due on the mix's schedule
(``generate.arrivals``), grouped FIFO up to ``group_max`` into one
``repro_torch.estimator.fit_batch`` call.

Each request names a subject of the pool made in set-up, its lam1 and
its lam2 (``generate.solve_requests``).  Requests due in the window are
all served, after the close too (for at most ``DRAIN_S``); a backlog
(every request due at 0) starts no group after the close.  The check
compares the seed's sample among the first ``check_among`` requests due
(among all, without it).
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from hpbench.harness import generate
from hpbench.harness.trace import WINDOW_RANGE
from hpbench.harness.window import (DRAIN_S, clock, program_data,
                                    program_input, report_row,
                                    solver_config, sync)


class Driver:

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.cfg = solver_config(config, device)
        self.key = program_input(config)

    def setup(self, seconds: float) -> None:
        self.make_inputs(seconds)
        self.warm()

    def make_inputs(self, seconds: float) -> None:
        from repro_torch.estimator import fit_batch
        self.fit_batch = fit_batch
        t = self.traffic
        self.x = generate.datasets(self.config, t["pool"], self.seed,
                                   self.device)
        self.data = program_data(self.config, self.x)
        self.due = generate.arrivals(t, seconds, self.seed)
        self.req = generate.solve_requests(t, len(self.due), self.seed)
        among = min(len(self.due), t.get("check_among", len(self.due)))
        self.sample = set(generate.rng(self.seed, 5).choice(
            among, size=min(t["check_sample"], among), replace=False).tolist())

    def warm(self) -> None:
        """The window's calls, and the copy it keeps for the check."""
        t = self.traffic
        g = t["group_max"]
        lo, hi = t["lam1_range"]
        for rep in self._group(list(range(g)), np.full(g, 0.5 * (lo + hi)),
                               np.full(g, t["lam2_values"][0])):
            rep.omega.to_sparse()
        sync(self.device)

    def _group(self, subjects, lam1, lam2):
        idx = torch.as_tensor(subjects, device=self.data.device)
        return self.fit_batch(lam1=lam1, lam2=lam2, config=self.cfg,
                              **{self.key: self.data.index_select(0, idx)})

    def window(self, seconds: float) -> dict:
        t = self.traffic
        backlog = t["arrivals"] == "backlog"
        due, req, gmax = self.due, self.req, t["group_max"]
        requests = [{"id": i, "due": float(due[i])} for i in range(len(due))]
        groups, kept = [], {}
        pending = collections.deque()
        nxt = 0
        with record_function(WINDOW_RANGE):
            t0 = clock()
            while True:
                now = clock() - t0
                while nxt < len(due) and due[nxt] <= now:
                    pending.append(nxt)
                    nxt += 1
                if backlog and now >= seconds:
                    break
                if not pending:
                    if nxt >= len(due):
                        break
                    with record_function("hpbench.wait_for_arrival"):
                        time.sleep(max(0.0, due[nxt] - now))
                    continue
                if now >= seconds + DRAIN_S:
                    break
                ids = [pending.popleft()
                       for _ in range(min(gmax, len(pending)))]
                start = clock() - t0
                with record_function("hpbench.group"):
                    rep = self._group(req["subject"][ids], req["lam1"][ids],
                                      req["lam2"][ids])
                end = clock() - t0
                st = rep.stats
                groups.append({"start": start, "end": end, "ids": ids,
                               "occupancy": list(st.occupancy),
                               "capacities": list(st.capacities),
                               "segments": st.segments,
                               "reports": [report_row(r) for r in rep]})
                for lane, i in enumerate(ids):
                    requests[i].update(start=start, end=end)
                    if i in self.sample:
                        kept[i] = rep.reports[lane].omega.to_sparse()
                del rep
        served = [r for r in requests if "end" in r]
        return {"groups": groups, "kept": kept,
                "requests": served if backlog else requests,
                "failed": 0 if backlog else len(requests) - len(served),
                "window_s": groups[-1]["end"] if groups else clock() - t0}

    def _item(self, i: int) -> dict:
        return {"dataset": int(self.req["subject"][i]),
                "lam1": float(self.req["lam1"][i]),
                "lam2": float(self.req["lam2"][i])}

    def checked(self, run: dict) -> list[dict]:
        """The requests the check compares: the seed's sample, those of
        them that were served."""
        return [{**self._item(i), "omega": run["kept"][i]}
                for i in sorted(run["kept"])]

    def planned(self) -> list[dict]:
        """The requests the check would compare, as the reference needs
        them."""
        return [self._item(i) for i in sorted(self.sample)]

    def release(self) -> None:
        del self.fit_batch, self.data

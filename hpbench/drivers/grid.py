"""Closed loop, one client: one subject's model selection over Section
5's (lam1, lam2) grid, one subject after another, through
``ConcordEstimator.fit_grid``.

Grid k runs on subject ``k % pool`` over the mix's fixed ``lam1_grid``
(warm, descending) and ``lam2_grid`` (one path each, from the identity),
every point scored by the BIC.  A new grid starts only while the window
is open; the one running at the close completes and counts.  Each grid
is one entry of the run's ``paths``, its points under ``reports``, so
``path_s`` reads seconds per grid.  The check compares the seed's pick
among the first ``check_among`` grids: one item per lam2 path.

A program without ``fit_grid`` cannot run the mix: the run stops at
once, before any input is made.
"""
from __future__ import annotations

from torch.profiler import record_function

from hpbench.harness import generate
from hpbench.harness.trace import WINDOW_RANGE
from hpbench.harness.window import (clock, program_data, program_input,
                                    report_row, solver_config, sync)


class Driver:

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from repro_torch.estimator import ConcordEstimator
        if not hasattr(ConcordEstimator, "fit_grid"):
            raise RuntimeError("the program has no ConcordEstimator.fit_grid;"
                               " the grid mix cannot run")
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.cfg = solver_config(config, device)
        self.key = program_input(config)

    def setup(self, seconds: float) -> None:
        self.make_inputs(seconds)
        self.warm()

    def make_inputs(self, seconds: float) -> None:
        t = self.traffic
        self.x = generate.datasets(self.config, t["pool"], self.seed,
                                   self.device)
        self.data = program_data(self.config, self.x)
        self.check_grid = int(generate.rng(self.seed, 5).integers(
            t["check_among"]))

    def warm(self) -> None:
        """The window's calls, and the copy it keeps for the check."""
        for rep in self._grid(0, self.traffic["warmup_lam1"]):
            rep.omega.to_sparse()
        sync(self.device)

    def _grid(self, k: int, lam1_grid):
        from repro_torch.estimator import ConcordEstimator
        est = ConcordEstimator(config=self.cfg)
        return est.fit_grid(lam1_grid=lam1_grid,
                            lam2_grid=self.traffic["lam2_grid"],
                            n_samples=self.config["n"],
                            **{self.key: self.data[k]})

    def window(self, seconds: float) -> dict:
        t = self.traffic
        pool, lam1_grid = t["pool"], t["lam1_grid"]
        paths, kept = [], {}
        with record_function(WINDOW_RANGE):
            t0 = clock()
            k = 0
            while clock() - t0 < seconds and k < t["max_grids"]:
                start = clock() - t0
                with record_function("hpbench.grid"):
                    res = self._grid(k % pool, lam1_grid)
                    sync(self.device)
                end = clock() - t0
                paths.append({"start": start, "end": end,
                              "dataset": k % pool, "grid": lam1_grid,
                              "reports": [report_row(r) for r in res]})
                if k in (0, self.check_grid):
                    kept[k] = {lam2: [r.omega.to_sparse() for r in path]
                               for lam2, path in res.paths.items()}
                    if k == self.check_grid:
                        kept = {k: kept[k]}
                del res
                k += 1
        return {"paths": paths, "kept": kept, "window_s": paths[-1]["end"]}

    def _items(self, k: int) -> list[dict]:
        return [{"dataset": k % self.traffic["pool"],
                 "grid": self.traffic["lam1_grid"], "lam2": lam2}
                for lam2 in self.traffic["lam2_grid"]]

    def checked(self, run: dict) -> list[dict]:
        """The grid the check compares, one item per lam2 path: the seed's
        pick among the first ``check_among`` grids, or the first where
        the window held fewer."""
        k = max(run["kept"])
        reports = run["paths"][k]["reports"]
        return [{**item, "omegas": run["kept"][k][item["lam2"]],
                 "bics": [r["bic"] for r in reports
                          if r["lam2"] == item["lam2"]]}
                for item in self._items(k)]

    def planned(self) -> list[dict]:
        """The grid the check would compare, as the reference needs it."""
        return self._items(self.check_grid)

    def release(self) -> None:
        del self.data

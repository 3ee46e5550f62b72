"""Closed loop, one client: warm-started regularization paths (the
model-selection sweep), one after another, through
``ConcordEstimator.fit_path(mode="sequential")``.

Path k runs on data set ``k % pool`` over its own descending lam1 grid
(``generate.path_grids``).  A new path starts only while the window is
open; the one running at the close completes and counts.  The check
compares one path, the seed's pick among the first ``check_among``.
"""
from __future__ import annotations

from torch.profiler import record_function

from hpbench.harness import generate
from hpbench.harness.trace import WINDOW_RANGE
from hpbench.harness.window import (clock, program_data, program_input,
                                    report_row, solver_config, sync)


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
        t = self.traffic
        self.x = generate.datasets(self.config, t["pool"], self.seed,
                                   self.device)
        self.data = program_data(self.config, self.x)
        self.grids = generate.path_grids(t, t["max_paths"], self.seed)
        self.check_path = int(generate.rng(self.seed, 5).integers(
            t["check_among"]))

    def warm(self) -> None:
        """The window's calls, and the copy it keeps for the check."""
        for rep in self._path(0, self.traffic["warmup_lam1"]):
            rep.omega.to_sparse()
        sync(self.device)

    def _path(self, k: int, grid):
        from repro_torch.core.penalty import PenaltySpec
        from repro_torch.estimator import ConcordEstimator
        est = ConcordEstimator(
            penalty=PenaltySpec.l1(grid[0], self.traffic["lam2"]),
            config=self.cfg)
        return est.fit_path(lam1_grid=grid, n_samples=self.config["n"],
                            mode="sequential", **{self.key: self.data[k]})

    def window(self, seconds: float) -> dict:
        pool = self.traffic["pool"]
        paths, kept = [], {}
        with record_function(WINDOW_RANGE):
            t0 = clock()
            k = 0
            while clock() - t0 < seconds and k < len(self.grids):
                start = clock() - t0
                with record_function("hpbench.path"):
                    res = self._path(k % pool, self.grids[k])
                    sync(self.device)
                end = clock() - t0
                paths.append({"start": start, "end": end,
                              "dataset": k % pool, "grid": self.grids[k],
                              "reports": [report_row(r) for r in res]})
                if k in (0, self.check_path):
                    kept[k] = [r.omega.to_sparse() for r in res]
                    if k == self.check_path:
                        kept = {k: kept[k]}
                del res
                k += 1
        return {"paths": paths, "kept": kept, "window_s": paths[-1]["end"]}

    def checked(self, run: dict) -> list[dict]:
        """The path the check compares: the seed's pick among the first
        ``check_among`` paths, or the first where the window held fewer."""
        k = max(run["kept"])
        path = run["paths"][k]
        return [{"dataset": path["dataset"], "grid": path["grid"],
                 "lam2": self.traffic["lam2"], "omegas": run["kept"][k],
                 "bics": [r["bic"] for r in path["reports"]]}]

    def planned(self) -> list[dict]:
        """The path the check would compare, as the reference needs it."""
        k = self.check_path
        return [{"dataset": k % self.traffic["pool"], "grid": self.grids[k],
                 "lam2": self.traffic["lam2"]}]

    def release(self) -> None:
        del self.data

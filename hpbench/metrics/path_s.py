"""path_s: the window's start to the end of its last completed path,
over the paths completed (host clock; each path ends in a device sync)."""
UNIT = "s"
LAYER = "estimator facade"
SOURCE = "host_clock"


def read(run):
    paths = run.get("paths")
    if not paths:
        return None
    return paths[-1]["end"] / len(paths)

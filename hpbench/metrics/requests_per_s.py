"""requests_per_s: requests completed over the window's start to the end
of its last group (host clock after the group's sync)."""
UNIT = "req/s"
LAYER = "batched engine"
SOURCE = "host_clock"


def read(run):
    groups = run.get("groups")
    if not groups:
        return None
    return sum(len(g["ids"]) for g in groups) / groups[-1]["end"]

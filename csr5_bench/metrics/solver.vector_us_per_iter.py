"""Device microseconds per solver iteration in every graph node of the
traced replays outside the calls of the solver's operator: the solver's
vector work (axpys, dots, fills), placed by the program's spans and
capture records."""

from csr5_bench import replays


def read(t):
    reps = replays.replays(t)
    parts = replays.split(reps) if reps else None
    if not parts or not t.iters:
        return None
    return sum(e - s for _, s, e in parts[1]) / (len(reps) * t.iters)

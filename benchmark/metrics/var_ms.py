"""Milliseconds of posterior variance per query point: the whole window
divided by the query points whose variance it computed."""


def read(rec):
    return 1e3 * rec.window_s / sum(s["work"] for s in rec.steps)

"""Query points answered (mean and std), divided by the whole window."""


def read(rec):
    return sum(s["work"] for s in rec.steps) / rec.window_s

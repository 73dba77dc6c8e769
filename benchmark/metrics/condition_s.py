"""Seconds per conditioning: the whole window divided by the data sets
conditioned in it (each with its posterior mean at the step's queries)."""


def read(rec):
    return rec.window_s / len(rec.steps)

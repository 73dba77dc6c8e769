"""Seconds from the process's start to the first timed step: import, the
card's context, data, the warm-up, and any kernel build of a first run."""


def read(rec):
    return rec.setup_s

"""Seconds from the process's start to the first timed step: imports, the
kernel library, batches, weights, model, train state, the check steps and
the warm-up steps."""


def read(rec):
    return rec.get("setup_s")

"""Seconds from the process's start to the window's start: imports, the
graph drawn on the card, host preprocessing, uploads, warm-up."""


def read(run):
    return run.setup_s

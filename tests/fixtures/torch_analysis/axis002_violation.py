"""Seeded AXIS002 violations: spawn's arguments against the rank
function's (rank, world, *args) parameters."""
from axis002_ranks import sibling_rank

from repro_torch.dist.launch import spawn


def two_args_rank(rank, world, a, b):
    return a + b


def defaults_rank(rank, world, a, b=1, c=2):
    return a + b + c


def run_short():
    return spawn(two_args_rank, 2, 1)                # VIOLATION AXIS002


def run_long():
    return spawn(defaults_rank, 2, 1, 2, 3, 4)       # VIOLATION AXIS002


def run_sibling():
    return spawn(sibling_rank, 4)                    # VIOLATION AXIS002

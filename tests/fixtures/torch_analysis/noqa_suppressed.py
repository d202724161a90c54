"""noqa escape-hatch fixture: each suppression style, plus one live
violation showing that a mismatched rule id does NOT suppress."""
import time

import torch


def targeted(gen):
    return gen.manual_seed(int(time.time()))  # repro: noqa[PRNG003] demo


def bare(mesh):
    return mesh.axis("batch")  # repro: noqa


def wrong_rule():
    torch.manual_seed(hash("x"))  # repro: noqa[AXIS001] VIOLATION PRNG003

"""Seeded PRNG003 violations: nondeterministic values feeding seeds."""
import random
import time

import numpy as np
import torch


def hash_seed(name):
    return torch.manual_seed(hash(name))             # VIOLATION PRNG003


def time_seed(gen):
    return gen.manual_seed(int(time.time()))         # VIOLATION PRNG003


def cuda_seed():
    torch.cuda.manual_seed_all(random.randint(0, 9))  # VIOLATION PRNG003


def generator_seed(device):
    return torch.Generator(device=device).manual_seed(
        np.random.randint(1 << 30))                  # VIOLATION PRNG003


def kwarg_seed(make_dataset, obj):
    return make_dataset(seed=id(obj))                # VIOLATION PRNG003

"""Clean twin of prng003_violation.py: seeds threaded from the caller or
derived from stable data."""
import zlib

import torch


def path_seed(gen, path, seed):
    return gen.manual_seed(seed + (zlib.crc32(path.encode()) & 0x7FFFFFFF))


def threaded(seed):
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed + 1)


def kwarg_seed(make_dataset, seed):
    return make_dataset(seed=seed)

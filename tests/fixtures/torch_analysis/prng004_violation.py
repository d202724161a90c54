"""Seeded PRNG004 violations: constant seeds (checked as library code)."""
import torch

SEED = 1234


def constant_global():
    torch.manual_seed(0)                             # VIOLATION PRNG004


def constant_generator(device):
    return torch.Generator(device=device).manual_seed(1234)  # VIOLATION PRNG004


def module_constant():
    torch.cuda.manual_seed(SEED)                     # VIOLATION PRNG004

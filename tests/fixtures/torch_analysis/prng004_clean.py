"""Clean twin of prng004_violation.py: every seed is threaded in."""
import torch


def threaded(seed, device):
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed + 1000)

"""Seeded PALLAS002 violations: kernel caps assigned outside their owners."""
from repro_torch.kernels.build import MAX_M

WARP_SORT_MAX_M = 2048                               # VIOLATION PALLAS002
BLOCK_TOKENS: int = 32                               # VIOLATION PALLAS002
CAPS = dict(MAX_M)

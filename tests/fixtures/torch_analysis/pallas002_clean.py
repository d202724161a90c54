"""Clean twin of pallas002_violation.py: caps imported from their owners;
a local of the same name is not a module-level cap."""
from repro_torch.kernels.build import GRAM_TILE, WARP_SORT_MAX_M
from repro_torch.serve.cache import BLOCK_TOKENS


def tiles(d):
    STAGE_BYTES = 4 * d
    return -(-d // GRAM_TILE), WARP_SORT_MAX_M, BLOCK_TOKENS, STAGE_BYTES

"""Deterministic synthetic data (the paper's classification substrate)."""
from repro_torch.data.pipeline import (ClassificationData,  # noqa: F401
                                       TokenStream, make_worker_batches)

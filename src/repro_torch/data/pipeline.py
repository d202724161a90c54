"""Data pipeline: the paper's MNIST/CIFAR stand-in.

Port of ``repro/data/pipeline.py::ClassificationData``: a Gaussian-mixture
multiclass problem (10 classes, configurable dim).  Every batch is a
deterministic function of (seed, step), drawn on the target device from a
``torch.Generator`` seeded per step.  The draws differ from the reference's
``jax.random`` ones; tests that compare the two packages feed both the same
numpy batches.
"""
from __future__ import annotations

import dataclasses

import torch

# Step index of the held-out test set (the reference's test_set step).
TEST_STEP = 10_000_019


@dataclasses.dataclass
class ClassificationData:
    """Gaussian-mixture classification (paper experiment substrate)."""
    num_classes: int = 10
    dim: int = 784                    # MNIST-like
    noise: float = 1.0
    seed: int = 0
    device: str = "cpu"

    def __post_init__(self):
        gen = self._gen(self.seed)
        self.means = 2.0 * torch.randn((self.num_classes, self.dim),
                                       generator=gen, device=self.device)

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def batch(self, step: int, batch_size: int) -> dict:
        gen = self._gen((self.seed + 1) * 1_000_003 + step)
        y = torch.randint(0, self.num_classes, (batch_size,), generator=gen,
                          device=self.device)
        x = self.means[y] + self.noise * torch.randn(
            (batch_size, self.dim), generator=gen, device=self.device)
        return {"x": x, "y": y}

    def test_set(self, n: int = 2048) -> dict:
        return self.batch(TEST_STEP, n)


def make_worker_batches(batch: dict, m: int) -> dict:
    """Reshape a global batch to (m, B/m, ...) worker groups (the paper's m
    workers)."""
    def split(x):
        B = x.shape[0]
        if B % m:
            raise ValueError(f"global batch {B} not divisible by m={m}")
        return x.reshape(m, B // m, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}

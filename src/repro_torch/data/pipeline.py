"""Data pipeline: deterministic synthetic streams.

Port of ``repro/data/pipeline.py``:

``TokenStream`` — the LM pretraining stand-in with learnable structure: a
fixed random mode-bigram table generates token sequences, so the loss has
real signal.

``ClassificationData`` — the paper's MNIST/CIFAR stand-in: a
Gaussian-mixture multiclass problem (10 classes, configurable dim).

Every batch is a deterministic function of (seed, step), drawn on the target
device from a ``torch.Generator`` seeded per step.  The draws differ from the
reference's ``jax.random`` ones; tests that compare the two packages feed
both the same numpy batches.
"""
from __future__ import annotations

import dataclasses

import torch

# Step index of the held-out test set (the reference's test_set step).
TEST_STEP = 10_000_019


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _step_seed(seed: int, step: int) -> int:
    return (seed + 1) * 1_000_003 + step


@dataclasses.dataclass
class TokenStream:
    """Token sequences from a random bigram table of rank ``num_modes``:
    each token of the active vocabulary min(vocab_size, 4096) belongs to a
    mode, each mode has a next-token distribution softmax(2.5 N(0, 1)), and
    a sequence starts at a uniform token and draws each next token from the
    distribution of the current token's mode."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_modes: int = 64
    device: str = "cpu"

    def __post_init__(self):
        gen = _gen(self.seed, self.device)
        v = min(self.vocab_size, 4096)                  # active vocab
        logits = 2.5 * torch.randn((self.num_modes, v), generator=gen,
                                   device=self.device)
        self._table = torch.softmax(logits, dim=-1)     # (modes, v)
        self._mode_of = torch.randint(0, self.num_modes, (v,), generator=gen,
                                      device=self.device)
        self._active = v

    def batch(self, step: int) -> dict:
        """{'tokens': (B, S), 'labels': (B, S)} int32; the labels are the
        next-token targets (the sequence shifted by one)."""
        gen = _gen(_step_seed(self.seed, step), self.device)
        B, S = self.global_batch, self.seq_len
        tok = torch.randint(0, self._active, (B,), generator=gen,
                            device=self.device)
        toks = [tok]
        for _ in range(S):
            probs = self._table[self._mode_of[tok]] + 1e-9
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            toks.append(tok)
        toks = torch.stack(toks, dim=1).to(torch.int32)  # (B, S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class ClassificationData:
    """Gaussian-mixture classification (paper experiment substrate)."""
    num_classes: int = 10
    dim: int = 784                    # MNIST-like
    noise: float = 1.0
    seed: int = 0
    device: str = "cpu"

    def __post_init__(self):
        gen = _gen(self.seed, self.device)
        self.means = 2.0 * torch.randn((self.num_classes, self.dim),
                                       generator=gen, device=self.device)

    def batch(self, step: int, batch_size: int) -> dict:
        gen = _gen(_step_seed(self.seed, step), self.device)
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

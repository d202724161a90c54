"""The paper's MNIST MLP (Table 2): 784-128-128-10, ReLU, softmax output.

Weights are stored in the reference's layout, ``w`` as (din, dout), so a
parameter tree converts to and from ``repro.models.mlp`` as an identity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.registry import Model


def init_mlp_classifier(gen: torch.Generator, dims=(784, 128, 128, 10)
                        ) -> dict:
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=gen, device=gen.device)
        params[f"fc{i + 1}"] = {
            "w": w / math.sqrt(din),
            "b": torch.zeros((dout,), device=gen.device),
        }
    return params


def mlp_logits(params, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    n = len(params)
    for i in range(1, n + 1):
        h = h @ params[f"fc{i}"]["w"] + params[f"fc{i}"]["b"]
        if i < n:
            h = F.relu(h)
    return h


def nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y[:, None]).mean()


def mlp_loss(params, batch) -> torch.Tensor:
    return nll(mlp_logits(params, batch["x"]), batch["y"])


def mlp_accuracy(params, batch) -> torch.Tensor:
    pred = mlp_logits(params, batch["x"]).argmax(dim=-1)
    return (pred == batch["y"]).float().mean()


def build_mlp_model(dims=(784, 128, 128, 10)) -> Model:
    return Model(
        cfg=None,
        init=lambda gen: init_mlp_classifier(gen, dims),
        forward=lambda p, b: (mlp_logits(p, b["x"]), torch.zeros(())),
        loss=mlp_loss,
    )

"""The paper's CIFAR10 CNN (Table 3): 4 conv (32,32,64,64) + 2 dense (512) +
10-way softmax.  Dropout omitted, as in the reference.

Parameters are stored in the reference's layout: conv ``w`` as HWIO, fc ``w``
as (din, dout); inputs are NHWC.  The forward pass permutes to PyTorch's
NCHW/OIHW around each convolution and back to NHWC before the flatten, so the
fc1 rows line up with the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.mlp import nll
from repro_torch.models.registry import Model


def _conv_init(gen, kh, kw, cin, cout):
    scale = 1.0 / math.sqrt(kh * kw * cin)
    return scale * torch.randn((kh, kw, cin, cout), generator=gen,
                               device=gen.device)


def init_cnn(gen: torch.Generator, *, in_ch=3, num_classes=10, size=32
             ) -> dict:
    flat = (size // 4) * (size // 4) * 64
    dev = gen.device

    def dense(din, dout, scale):
        return {"w": torch.randn((din, dout), generator=gen, device=dev)
                / scale,
                "b": torch.zeros((dout,), device=dev)}

    return {
        "conv1": {"w": _conv_init(gen, 3, 3, in_ch, 32)},
        "conv2": {"w": _conv_init(gen, 3, 3, 32, 32)},
        "conv3": {"w": _conv_init(gen, 3, 3, 32, 64)},
        "conv4": {"w": _conv_init(gen, 3, 3, 64, 64)},
        "fc1": dense(flat, 512, math.sqrt(flat)),
        "fc2": dense(512, 512, math.sqrt(512.0)),
        "fc3": dense(512, num_classes, 22.6),
    }


def _conv(h, w):
    """'SAME' 3x3 convolution of NCHW ``h`` with an HWIO kernel."""
    return F.conv2d(h, w.permute(3, 2, 0, 1), padding="same")


def cnn_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_conv(h, params["conv1"]["w"]))
    h = F.relu(_conv(h, params["conv2"]["w"]))
    h = F.max_pool2d(h, 2, 2)
    h = F.relu(_conv(h, params["conv3"]["w"]))
    h = F.relu(_conv(h, params["conv4"]["w"]))
    h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    h = F.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])
    return h @ params["fc3"]["w"] + params["fc3"]["b"]


def cnn_loss(params, batch) -> torch.Tensor:
    return nll(cnn_logits(params, batch["x"]), batch["y"])


def cnn_topk_accuracy(params, batch, k: int = 3) -> torch.Tensor:
    topk = cnn_logits(params, batch["x"]).topk(k, dim=-1).indices
    return (topk == batch["y"][:, None]).any(dim=1).float().mean()


def build_cnn_model(**kw) -> Model:
    return Model(
        cfg=None,
        init=lambda gen: init_cnn(gen, **kw),
        forward=lambda p, b: (cnn_logits(p, b["x"]), torch.zeros(())),
        loss=cnn_loss,
    )

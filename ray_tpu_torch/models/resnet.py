"""Basic-block ResNet for CIFAR and ImageNet (counterpart of
ray_tpu/models/resnet.py).

Functional with explicit batch-norm state, as the JAX model: ``init``
returns ``(params, state)``, two flat dicts keyed by the reference's
layer paths (``stem/w``, ``s1b0/c1``, ``s1b0/bn1/g``, ``s1b0/bn1/mean``,
...); ``apply(params, state, images, train)`` returns ``(logits,
new_state)``. Convolution weights stay HWIO in params and are permuted
at use; images are NHWC at the API and run NCHW inside (the permuted
view of an NHWC tensor is channels-last memory).

Two details of the reference that a line-by-line port gets wrong:
- XLA's ``SAME`` padding is asymmetric at stride 2: the total padding
  max((ceil(n/s) - 1) s + k - n, 0) is split with the smaller half
  before and the rest after, so PyTorch's symmetric ``padding=k//2``
  computes another function. ``_same_pad`` pads explicitly, for the
  convolutions with zeros and for the max pool with -inf.
- Batch-norm statistics are the biased f32 mean and variance over
  (N, H, W) (``jnp.var``), not ``torch.var``'s unbiased default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)   # resnet-18
    width: int = 64
    small_inputs: bool = True   # CIFAR stem (3x3, no maxpool)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def resnet18_cifar(**kw) -> "ResNetConfig":
        return ResNetConfig(**kw)

    @staticmethod
    def resnet50_imagenet(**kw) -> "ResNetConfig":
        # the reference's layout under this name: basic blocks in stages
        # (3, 4, 6, 3), i.e. ResNet-34's, kept as the reference has it
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), small_inputs=False,
                            num_classes=1000, **kw)


def _same_pad(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """x [B, C, H, W] padded as XLA's ``SAME`` pads it for a k x k window
    at ``stride``: the smaller half of each dimension's padding before,
    the rest after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad lists W first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class ResNet:
    """Basic-block ResNet. Params/state: flat dicts keyed by layer path."""

    def __init__(self, config: ResNetConfig):
        self.config = config

    def _blocks(self) -> Iterator[Tuple[str, int, int, int]]:
        """(path, ch_in, ch, stride) of each basic block, in order."""
        c = self.config
        ch_in = c.width
        for si, blocks in enumerate(c.stage_sizes):
            ch = c.width * (2 ** si)
            for bi in range(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                yield f"s{si}b{bi}", ch_in, ch, stride
                ch_in = ch

    def shapes(self) -> Tuple[Dict[str, Tuple[int, ...]],
                              Dict[str, Tuple[int, ...]]]:
        """(param shapes, state shapes), in the reference's init order."""
        c = self.config
        params: Dict[str, Tuple[int, ...]] = {}
        state: Dict[str, Tuple[int, ...]] = {}

        def bn(path, ch):
            params[path + "/g"] = params[path + "/b"] = (ch,)
            state[path + "/mean"] = state[path + "/var"] = (ch,)

        stem = 3 if c.small_inputs else 7
        params["stem/w"] = (stem, stem, 3, c.width)
        bn("stem/bn", c.width)
        ch = c.width
        for p, ch_in, ch, stride in self._blocks():
            params[p + "/c1"] = (3, 3, ch_in, ch)
            bn(p + "/bn1", ch)
            params[p + "/c2"] = (3, 3, ch, ch)
            bn(p + "/bn2", ch)
            if stride != 1 or ch_in != ch:
                params[p + "/proj"] = (1, 1, ch_in, ch)
                bn(p + "/bnp", ch)
        params["head/w"] = (ch, c.num_classes)
        params["head/b"] = (c.num_classes,)
        return params, state

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return self.shapes()[0]

    def init(self, generator: torch.Generator) -> Tuple[Params, State]:
        """(params, state) on ``generator.device``, distributed as the JAX
        init's (not the same numbers): convolutions He-normal (std
        sqrt(2 / fan_in), fan_in = kh kw ch_in), the head normal of std
        0.01, batch-norm gains one and biases zero; running means zero
        and variances one (f32)."""
        c = self.config
        dev = generator.device
        param_shapes, state_shapes = self.shapes()
        params = {}
        for name, shape in param_shapes.items():
            if len(shape) == 4:
                std = math.sqrt(2.0 / math.prod(shape[:3]))
            elif name == "head/w":
                std = 0.01
            else:
                fill = torch.ones if name.endswith("/g") else torch.zeros
                params[name] = fill(shape, dtype=c.param_dtype, device=dev)
                continue
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=c.param_dtype,
                                       device=dev).mul_(std)
        state = {name: (torch.zeros if name.endswith("/mean") else
                        torch.ones)(shape, dtype=torch.float32, device=dev)
                 for name, shape in state_shapes.items()}
        return params, state

    def _bn(self, x: torch.Tensor, params: Params, state: State, path: str,
            train: bool, updates: State) -> torch.Tensor:
        """Batch norm over (N, H, W) in f32. In training, the batch's
        biased statistics, and the running ones moved toward them (as
        values: the state takes no gradient)."""
        g = params[path + "/g"].float()[:, None, None]
        b = params[path + "/b"].float()[:, None, None]
        xf = x.float()
        if train:
            mu = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            m = BN_MOMENTUM
            updates[path + "/mean"] = m * state[path + "/mean"] \
                + (1 - m) * mu.detach()
            updates[path + "/var"] = m * state[path + "/var"] \
                + (1 - m) * var.detach()
        else:
            mu = state[path + "/mean"]
            var = state[path + "/var"]
        rstd = torch.rsqrt(var + BN_EPS)[:, None, None]
        y = (xf - mu[:, None, None]) * rstd * g + b
        return y.to(x.dtype)

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
        """x [B, C, H, W], w HWIO, ``SAME`` padding."""
        k = w.shape[0]
        return F.conv2d(_same_pad(x, k, stride),
                        w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)

    def apply(self, params: Params, state: State, images: torch.Tensor,
              train: bool = False) -> Tuple[torch.Tensor, State]:
        """images [B, H, W, 3] -> (logits [B, classes] f32, new_state)."""
        c = self.config
        x = images.to(c.dtype).permute(0, 3, 1, 2)
        updates = dict(state)
        x = self._conv(x, params["stem/w"], 1 if c.small_inputs else 2)
        x = F.relu(self._bn(x, params, state, "stem/bn", train, updates))
        if not c.small_inputs:
            x = F.max_pool2d(_same_pad(x, 3, 2, float("-inf")), 3, 2)
        for p, _, _, stride in self._blocks():
            res = x
            y = self._conv(x, params[p + "/c1"], stride)
            y = F.relu(self._bn(y, params, state, p + "/bn1", train, updates))
            y = self._conv(y, params[p + "/c2"], 1)
            y = self._bn(y, params, state, p + "/bn2", train, updates)
            if p + "/proj" in params:
                res = self._conv(res, params[p + "/proj"], stride)
                res = self._bn(res, params, state, p + "/bnp", train, updates)
            x = F.relu(y + res)
        x = x.float().mean(dim=(2, 3))
        logits = x @ params["head/w"].float() + params["head/b"].float()
        return logits, updates

    def loss(self, params: Params, state: State, images: torch.Tensor,
             labels: torch.Tensor, train: bool = True
             ) -> Tuple[torch.Tensor, State]:
        """(mean cross entropy against one-hot labels, new_state)."""
        logits, new_state = self.apply(params, state, images, train=train)
        onehot = F.one_hot(labels, self.config.num_classes).float()
        loss = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        return loss, new_state

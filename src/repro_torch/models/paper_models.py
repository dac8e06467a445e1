"""The paper's CNN-H model for HAR (§6.1) at its published width, batched
over participants.

The parameters live in the reference's layout so flat vectors compare one
to one: leaves in sorted-name order ``c1, c2, c3, f1_b, f1_w, f2_b, f2_w``
(offsets 0, 1440, 11680, 32160, 32288, 163360, 163366; 164,134 in all),
conv weights WIO ``[kernel, in, out]`` for NWC inputs and dense weights
``[in, out]``. The apply permutes views into PyTorch's NCW/OIW layout at
call time and never stores them that way.

`cnn_har_apply` runs ``c`` independent models at once — one per
participant of a tier chunk — from params with a leading ``[c]`` axis: the
convolutions are one grouped ``conv1d`` (groups = c) and the dense layers
``torch.bmm``. Each participant's loss depends only on its own parameters,
so one backward of the summed losses yields every row's gradient.

The other paper models (ResNet-18 / cnn_cifar, CNN-S, LR) are not ported
yet; `MODELS` names only cnn_har.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression as C

CNN_HAR_SHAPES = {
    "c1": (5, 9, 32),
    "c2": (5, 32, 64),
    "c3": (5, 64, 64),
    "f1_w": (64 * 16, 128),
    "f1_b": (128,),
    "f2_w": (128, 6),
    "f2_b": (6,),
}
# fan-ins of the He-normal init (the reference's _kinit arguments)
_FAN_IN = {"c1": 45, "c2": 160, "c3": 320, "f1_w": 64 * 16, "f2_w": 128}
_STRIDE = 2
# JAX "SAME" for kernel 5, stride 2 on an even length L: out = L/2, total
# padding (L/2 − 1)·2 + 5 − L = 3, split (1, 2) — at every cnn_har conv.
_SAME_PAD = (1, 2)


def cnn_har_spec(n_classes: int = 6) -> C.FlatSpec:
    shapes = dict(CNN_HAR_SHAPES)
    shapes["f2_w"] = (128, n_classes)
    shapes["f2_b"] = (n_classes,)
    return C.flat_spec(shapes)


def cnn_har_init(generator: torch.Generator, n_classes: int = 6
                 ) -> torch.Tensor:
    """The port's own init: He-normal weights and zero biases, drawn from
    ``generator`` on the CPU, as one flat [n_params] f32 vector. It cannot
    reproduce ``jax.random`` draws; parity runs load the reference's vector
    through `from_reference` instead."""
    spec = cnn_har_spec(n_classes)
    flat = torch.zeros(spec.n_params, dtype=torch.float32)
    views = C.unflatten_vector(flat, spec)
    for name in spec.names:
        if name in _FAN_IN:
            std = (2.0 / _FAN_IN[name]) ** 0.5
            views[name].copy_(torch.randn(views[name].shape,
                                          generator=generator) * std)
    return flat


def from_reference(flat_or_params, n_classes: int = 6) -> torch.Tensor:
    """The reference's cnn_har parameters → the port's flat f32 vector.

    Accepts the reference's flat vector (``Simulator.flat0``, any array
    convertible by numpy) or its parameter dict of arrays. The layouts are
    identical, so this is a copy with shape checks."""
    spec = cnn_har_spec(n_classes)
    if isinstance(flat_or_params, dict):
        flat = np.concatenate([
            np.asarray(flat_or_params[k], np.float32).reshape(-1)
            for k in spec.names])
        for k, s in zip(spec.names, spec.shapes):
            if tuple(np.shape(flat_or_params[k])) != s:
                raise ValueError(f"{k}: shape {np.shape(flat_or_params[k])} "
                                 f"!= {s}")
    else:
        flat = np.asarray(flat_or_params, np.float32).reshape(-1)
    if flat.shape != (spec.n_params,):
        raise ValueError(f"want {spec.n_params} cnn_har parameters, got "
                         f"{flat.shape[0]}")
    return torch.from_numpy(flat.copy())


def _norm(h: torch.Tensor) -> torch.Tensor:
    """Parameter-free norm over the length axis (the reference's ``_norm``
    on NWC: mean/variance over W per sample and channel, population
    variance). ``h`` is [..., W]."""
    mean = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, correction=0)
    return (h - mean) * torch.rsqrt(var + 1e-5)


def _conv_group(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One stride-2 "SAME" conv for c participants at once.

    h [B, c·I, W] (participant-major channels); w [c, K, I, O] (WIO per
    participant) → [B, c·O, W/2]."""
    c, k, i, o = w.shape
    weight = w.permute(0, 3, 2, 1).reshape(c * o, i, k)
    return F.conv1d(F.pad(h, _SAME_PAD), weight, stride=_STRIDE, groups=c)


def cnn_har_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits [c, B, n_classes] of c models on their own batches.

    ``params``: {name: [c, *shape]} (views of a [c, n_params] batch, see
    `repro_torch.core.compression.unflatten_vector`); ``x``: [c, B, 128, 9]
    NWC windows."""
    c, b = x.shape[0], x.shape[1]
    h = x.permute(1, 0, 3, 2).reshape(b, c * x.shape[3], x.shape[2])
    for name in ("c1", "c2", "c3"):
        h = _conv_group(h, params[name])
        w = h.shape[-1]
        h = F.relu(_norm(h.view(b, c, -1, w))).view(b, -1, w)
    # NWC flatten order: the reference reshapes [B, W=16, C=64] → [B, 1024]
    h = h.view(b, c, 64, -1).permute(1, 0, 3, 2).reshape(c, b, -1)
    h = F.relu(torch.bmm(h, params["f1_w"]) + params["f1_b"][:, None, :])
    return torch.bmm(h, params["f2_w"]) + params["f2_b"][:, None, :]


MODELS = {"cnn_har": (cnn_har_spec, cnn_har_init, cnn_har_apply)}
DATASET_MODEL = {"cifar10": "cnn_cifar", "har": "cnn_har",
                 "speech": "cnn_speech", "oppo_ts": "lr"}

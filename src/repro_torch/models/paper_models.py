"""The paper's own model families (§6.1) at their published widths, batched
over participants — the port of ``repro.models.paper_models``:

* ResNet-18 (CIFAR-10, width 64: 11,164,362 parameters) — the basic-block
  ResNet with parameter-free norms; its width-16 variant ``cnn_cifar``
  (699,066) is the simulator's cifar10 default, as in the reference;
* CNN-H (HAR): three stride-2 conv1d layers + two dense (164,134);
* CNN-S (Speech): four stride-4 conv1d layers, a mean over time, one dense
  (62,323);
* LR (OPPO-TS): logistic regression over 1024 features (2,050).

The parameters live in the reference's layout so flat vectors compare one
to one: leaves in ``jax.tree_util`` order, which for these dicts is sorted
key order, with ResNet-18's list of blocks named ``blocks.<i>.<leaf>``
(``blocks.0.c1`` … ``blocks.7.c2``, then ``fc_b``, ``fc_w``, ``stem``: the
same order, as there are 8 blocks). Conv weights are HWIO
``[kh, kw, in, out]`` for NHWC inputs and WIO ``[k, in, out]`` for NWC,
dense weights ``[in, out]``. Each apply permutes views into PyTorch's
OIHW/OIW layout at call time and never stores them that way.

Every ``*_apply`` runs ``c`` independent models at once — one per
participant of a tier chunk — from params with a leading ``[c]`` axis:
convolutions are one grouped ``conv1d``/``conv2d`` (groups = c) over
participant-major channels, dense layers ``torch.bmm``. Each participant's
loss depends only on its own parameters, so one backward of the summed
losses yields every row's gradient. Convolutions pad as JAX's "SAME" does
(`_same_pad`: the odd pad goes after, so a 3×3 stride-2 conv on 32×32 pads
(0, 1), not PyTorch's symmetric ``padding=1``). The norm is the reference's
parameter-free ``_norm``: per sample and channel over the spatial axes,
population variance.

`MODELS` maps a name to ``(spec_fn, init_fn, apply_fn)``; the init
functions draw He-normal weights (the reference's fan-ins) and zero biases
from a ``torch.Generator`` on the CPU, which cannot reproduce
``jax.random``: parity runs load the reference's vector through
`from_reference`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression as C

_RESNET_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)   # per block, as the reference


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX "SAME" padding of one spatial axis: out = ⌈size/stride⌉, total
    = max((out − 1)·stride + k − size, 0), the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _norm(h: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The reference's parameter-free ``_norm``: mean and population
    variance over the spatial ``dims`` per sample and channel."""
    mean = h.mean(dim=dims, keepdim=True)
    var = h.var(dim=dims, keepdim=True, correction=0)
    return (h - mean) * torch.rsqrt(var + 1e-5)


def _conv1d_group(h: torch.Tensor, w: torch.Tensor, stride: int
                  ) -> torch.Tensor:
    """One "SAME" conv1d for c participants: h [B, c·I, W] (participant-
    major channels), w [c, K, I, O] (WIO per participant) → [B, c·O, W']."""
    c, k, i, o = w.shape
    weight = w.permute(0, 3, 2, 1).reshape(c * o, i, k)
    pad = _same_pad(h.shape[-1], k, stride)
    if any(pad):
        h = F.pad(h, pad)
    return F.conv1d(h, weight, stride=stride, groups=c)


def _conv2d_group(h: torch.Tensor, w: torch.Tensor, stride: int
                  ) -> torch.Tensor:
    """One "SAME" conv2d for c participants: h [B, c·I, H, W], w [c, KH,
    KW, I, O] (HWIO per participant) → [B, c·O, H', W']."""
    c, kh, kw, i, o = w.shape
    weight = w.permute(0, 4, 3, 1, 2).reshape(c * o, i, kh, kw)
    ph = _same_pad(h.shape[-2], kh, stride)
    pw = _same_pad(h.shape[-1], kw, stride)
    if any(ph + pw):
        h = F.pad(h, pw + ph)
    return F.conv2d(h, weight, stride=stride, groups=c)


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """[c, B, I] @ [c, I, O] + [c, O] per participant."""
    return torch.bmm(h, w) + b[:, None, :]


def _per_participant(h: torch.Tensor, c: int) -> torch.Tensor:
    """[B, c·F] (participant-major features) → [c, B, F]."""
    return h.view(h.shape[0], c, -1).permute(1, 0, 2)


def _he(fan_in: dict) -> dict:
    """He-normal standard deviations √(2/fan_in) by name."""
    return {name: (2.0 / f) ** 0.5 for name, f in fan_in.items()}


def _normal_init(spec: C.FlatSpec, generator: torch.Generator, std: dict
                 ) -> torch.Tensor:
    """One flat [n_params] f32 vector: N(0, std²) for each name in ``std``,
    zeros elsewhere (the biases), drawn in spec order."""
    flat = torch.zeros(spec.n_params, dtype=torch.float32)
    views = C.unflatten_vector(flat, spec)
    for name in spec.names:
        if name in std:
            views[name].copy_(torch.randn(views[name].shape,
                                          generator=generator) * std[name])
    return flat


def _leaf(params, name: str):
    """A leaf of the reference's pytree by its flat name (``blocks.2.c1``
    → params["blocks"][2]["c1"])."""
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else \
            node[part]
    return node


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR-10) and cnn_cifar: x [c, B, 32, 32, 3] NHWC
# ---------------------------------------------------------------------------

def _resnet_layout(n_classes: int, width: int):
    """({name: shape}, {name: fan_in}) of the reference's resnet18_init."""
    shapes = {"stem": (3, 3, 3, width)}
    fan = {"stem": 27}
    c_in = width
    i = 0
    for stage, c in enumerate((width, width * 2, width * 4, width * 8)):
        for b in range(2):
            stride = 2 if (b == 0 and stage > 0) else 1
            shapes[f"blocks.{i}.c1"] = (3, 3, c_in, c)
            fan[f"blocks.{i}.c1"] = 9 * c_in
            shapes[f"blocks.{i}.c2"] = (3, 3, c, c)
            fan[f"blocks.{i}.c2"] = 9 * c
            if c_in != c or stride != 1:
                shapes[f"blocks.{i}.proj"] = (1, 1, c_in, c)
                fan[f"blocks.{i}.proj"] = c_in
            c_in = c
            i += 1
    shapes["fc_w"] = (c_in, n_classes)
    fan["fc_w"] = c_in
    shapes["fc_b"] = (n_classes,)
    return shapes, fan


def resnet18_spec(n_classes: int = 10, width: int = 64) -> C.FlatSpec:
    return C.flat_spec(_resnet_layout(n_classes, width)[0])


def resnet18_init(generator: torch.Generator, n_classes: int = 10,
                  width: int = 64) -> torch.Tensor:
    return _normal_init(resnet18_spec(n_classes, width), generator,
                        _he(_resnet_layout(n_classes, width)[1]))


def resnet18_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits [c, B, n_classes] of c ResNet-18s (any width) on their own
    batches. ``params``: {name: [c, *shape]}; ``x``: [c, B, H, W, 3]."""
    c, b = x.shape[0], x.shape[1]
    hw = (-2, -1)
    h = x.permute(1, 0, 4, 2, 3).reshape(b, c * x.shape[4], x.shape[2],
                                         x.shape[3])
    h = F.relu(_norm(_conv2d_group(h, params["stem"], 1), hw))
    for i, s in enumerate(_RESNET_STRIDES):
        proj = params.get(f"blocks.{i}.proj")
        r = _conv2d_group(h, proj, s) if proj is not None else h
        h2 = F.relu(_norm(_conv2d_group(h, params[f"blocks.{i}.c1"], s), hw))
        h2 = _norm(_conv2d_group(h2, params[f"blocks.{i}.c2"], 1), hw)
        h = F.relu(h2 + r)
    h = _per_participant(h.mean(dim=hw), c)
    return _dense(h, params["fc_w"], params["fc_b"])


cnn_cifar_spec = functools.partial(resnet18_spec, width=16)
cnn_cifar_init = functools.partial(resnet18_init, width=16)


# ---------------------------------------------------------------------------
# CNN-H (HAR): x [c, B, 128, 9] NWC
# ---------------------------------------------------------------------------

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
_HAR_FAN_IN = {"c1": 45, "c2": 160, "c3": 320, "f1_w": 64 * 16, "f2_w": 128}


def cnn_har_spec(n_classes: int = 6) -> C.FlatSpec:
    shapes = dict(CNN_HAR_SHAPES)
    shapes["f2_w"] = (128, n_classes)
    shapes["f2_b"] = (n_classes,)
    return C.flat_spec(shapes)


def cnn_har_init(generator: torch.Generator, n_classes: int = 6
                 ) -> torch.Tensor:
    return _normal_init(cnn_har_spec(n_classes), generator,
                        _he(_HAR_FAN_IN))


def cnn_har_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits [c, B, n_classes] of c models on their own batches.

    ``params``: {name: [c, *shape]} (views of a [c, n_params] batch, see
    `repro_torch.core.compression.unflatten_vector`); ``x``: [c, B, 128, 9]
    NWC windows."""
    c, b = x.shape[0], x.shape[1]
    h = x.permute(1, 0, 3, 2).reshape(b, c * x.shape[3], x.shape[2])
    for name in ("c1", "c2", "c3"):
        h = F.relu(_norm(_conv1d_group(h, params[name], 2), (-1,)))
    # NWC flatten order: the reference reshapes [B, W=16, C=64] → [B, 1024]
    h = h.view(b, c, 64, -1).permute(1, 0, 3, 2).reshape(c, b, -1)
    h = F.relu(_dense(h, params["f1_w"], params["f1_b"]))
    return _dense(h, params["f2_w"], params["f2_b"])


# ---------------------------------------------------------------------------
# CNN-S (Speech): x [c, B, 4000, 1] NWC
# ---------------------------------------------------------------------------

_SPEECH_CONVS = (("c1", 1, 16), ("c2", 16, 32), ("c3", 32, 64),
                 ("c4", 64, 64))
_SPEECH_K, _SPEECH_STRIDE = 9, 4


def cnn_speech_spec(n_classes: int = 35) -> C.FlatSpec:
    shapes = {name: (_SPEECH_K, i, o) for name, i, o in _SPEECH_CONVS}
    shapes["f_w"] = (64, n_classes)
    shapes["f_b"] = (n_classes,)
    return C.flat_spec(shapes)


def cnn_speech_init(generator: torch.Generator, n_classes: int = 35
                    ) -> torch.Tensor:
    fan = {name: _SPEECH_K * i for name, i, _ in _SPEECH_CONVS}
    fan["f_w"] = 64
    return _normal_init(cnn_speech_spec(n_classes), generator, _he(fan))


def cnn_speech_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits [c, B, n_classes]; ``x``: [c, B, 4000, 1] NWC clips (lengths
    4000 → 1000 → 250 → 63 → 16, SAME pads (2,3), (2,3), (3,4), (3,3))."""
    c, b = x.shape[0], x.shape[1]
    h = x.permute(1, 0, 3, 2).reshape(b, c * x.shape[3], x.shape[2])
    for name, _, _ in _SPEECH_CONVS:
        h = F.relu(_norm(_conv1d_group(h, params[name], _SPEECH_STRIDE),
                         (-1,)))
    h = _per_participant(h.mean(dim=-1), c)
    return _dense(h, params["f_w"], params["f_b"])


# ---------------------------------------------------------------------------
# LR (OPPO-TS): x [c, B, F]
# ---------------------------------------------------------------------------

def lr_spec(n_classes: int = 2, n_features: int = 1024) -> C.FlatSpec:
    return C.flat_spec({"w": (n_features, n_classes), "b": (n_classes,)})


def lr_init(generator: torch.Generator, n_classes: int = 2,
            n_features: int = 1024) -> torch.Tensor:
    """w ~ N(0, 0.01²), b = 0 (the reference's lr_init)."""
    return _normal_init(lr_spec(n_classes, n_features), generator,
                        {"w": 0.01})


def lr_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return _dense(x, params["w"], params["b"])


MODELS = {
    "resnet18": (resnet18_spec, resnet18_init, resnet18_apply),
    "cnn_cifar": (cnn_cifar_spec, cnn_cifar_init, resnet18_apply),
    "cnn_har": (cnn_har_spec, cnn_har_init, cnn_har_apply),
    "cnn_speech": (cnn_speech_spec, cnn_speech_init, cnn_speech_apply),
    "lr": (lr_spec, lr_init, lr_apply),
}
DATASET_MODEL = {"cifar10": "cnn_cifar", "har": "cnn_har",
                 "speech": "cnn_speech", "oppo_ts": "lr"}


def from_reference(flat_or_params, model: str = "cnn_har", **spec_kw
                   ) -> torch.Tensor:
    """The reference's parameters of ``model`` → the port's flat f32 vector
    on the CPU (the simulator's ``init_flat``), for every model of `MODELS`.

    Accepts the reference's flat vector (``Simulator.flat0``, any array
    convertible by numpy) or its parameter pytree of arrays. The layouts are
    identical, so this is a copy with shape checks. ``spec_kw`` are the
    model's spec arguments (``n_classes``; ``width`` for resnet18;
    ``n_features`` for lr)."""
    spec = MODELS[model][0](**spec_kw)
    if isinstance(flat_or_params, dict):
        leaves = [np.asarray(_leaf(flat_or_params, k), np.float32)
                  for k in spec.names]
        for k, a, s in zip(spec.names, leaves, spec.shapes):
            if a.shape != s:
                raise ValueError(f"{k}: shape {a.shape} != {s}")
        flat = np.concatenate([a.reshape(-1) for a in leaves])
    else:
        flat = np.asarray(flat_or_params, np.float32).reshape(-1)
    if flat.shape != (spec.n_params,):
        raise ValueError(f"want {spec.n_params} {model} parameters, got "
                         f"{flat.shape[0]}")
    return torch.from_numpy(flat.copy())

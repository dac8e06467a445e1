"""Shape stand-ins and partition specs for every (arch × input shape)
cell — the port of ``repro.launch.specs``. Pure functions: the stand-ins
are tensors on the ``meta`` device (shapes and dtypes, no memory) and the
specs are tuples, one entry per dim (None, an axis name or a tuple of
names), over any mesh with ``axis_names`` and ``shape`` (`launch.mesh`'s
`Mesh` or `abstract_mesh`).

Shapes:
    train_4k     seq=4096   global_batch=256   (training: train_step)
    prefill_32k  seq=32768  global_batch=32    (inference prefill: forward)
    decode_32k   seq=32768  global_batch=128   (one new token, KV cache @32k)
    long_500k    seq=524288 global_batch=1     (long-context decode)

Skips: decode/long for encoder-only; long_500k for full-attention archs
(needs sub-quadratic mixing).
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
_META = torch.device("meta")


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    kind = SHAPES[shape]["kind"]
    if kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention at 500k ctx (per-spec skip)"
    return True, ""


def _axes(mesh, cfg=None) -> tuple:
    if cfg is not None and cfg.dp_only:
        return tuple(mesh.axis_names)
    return tuple(a for a in mesh.axis_names if a != "model")


def _dp(mesh, cfg=None):
    """The batch axes as one spec entry."""
    return M.spec_entry(_axes(mesh, cfg))


def _n_dp(mesh, cfg=None) -> int:
    return math.prod(mesh.shape[a] for a in _axes(mesh, cfg))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Training/prefill batch stand-ins for this arch."""
    i32 = torch.int32
    if cfg.frontend == "audio":
        return {"frames": _meta((batch, seq, cfg.frontend_dim),
                                torch.bfloat16),
                "labels": _meta((batch, seq), i32)}
    if cfg.frontend == "vision":
        s_text = seq - cfg.n_patches
        return {"tokens": _meta((batch, s_text), i32),
                "patches": _meta((batch, cfg.n_patches, cfg.frontend_dim),
                                 torch.bfloat16),
                "labels": _meta((batch, s_text), i32)}
    return {"tokens": _meta((batch, seq), i32),
            "labels": _meta((batch, seq), i32)}


def batch_shardings(cfg: ModelConfig, mesh, batch: int) -> dict:
    dp = _dp(mesh, cfg)
    spec = (dp,) if batch % _n_dp(mesh, cfg) == 0 else ()
    names = ["tokens", "labels"]
    if cfg.frontend == "audio":
        names = ["frames", "labels"]
    elif cfg.frontend == "vision":
        names = ["tokens", "patches", "labels"]
    return {k: spec for k in names}


# ---------------------------------------------------------------------------
# Decode cache specs
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, seq: int):
    """`models.model.init_cache`'s tree on the ``meta`` device."""
    M._no_decode(cfg)
    return M._init_cache(cfg, batch, seq, _META)


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq: int):
    """Spec tree matching init_cache. Shard B over dp when divisible (else
    S — sequence parallelism for the B=1 long-context cell); shard
    kv-heads / ssm-heads / channels over "model" when divisible."""
    dp = _dp(mesh)
    n_dp = _n_dp(mesh)
    tp_size = mesh.shape["model"]
    b_ok = batch % n_dp == 0

    def div(dim, axis, size):
        return axis if dim % size == 0 and size > 1 else None

    def spec_for(names, leaf):
        nm = names[-1]
        sh = tuple(leaf.shape)   # leading L (or n_shared) axis everywhere
        if nm in ("k", "v"):     # [L, B, S, Hkv, Dh]
            bspec = dp if b_ok else None
            sspec = None if b_ok else (dp if sh[2] % n_dp == 0 else None)
            if sh[3] % tp_size == 0:          # kv-heads over model
                return (None, bspec, sspec, "model", None)
            # non-divisible kv-heads: shard the sequence over model
            # instead of the contracting head_dim
            if sspec is None and sh[2] % tp_size == 0:
                return (None, bspec, "model", None, None)
            return (None, bspec, sspec, None, None)
        if nm in ("c", "k_rope"):  # MLA latent [L, B, S, r]
            bspec = dp if b_ok else None
            sspec = None if b_ok else (dp if sh[2] % n_dp == 0 else None)
            return (None, bspec, sspec, None)
        if nm == "ssm":          # [L, B, H, P, N]
            return (None, dp if b_ok else None,
                    div(sh[2], "model", tp_size), None, None)
        if nm == "conv":         # [L, B, W-1, ch]
            return (None, dp if b_ok else None, None,
                    div(sh[3], "model", tp_size))
        return ()

    return M._map_with_path(spec_for, cache_struct(cfg, batch, seq))


def shard_cache(cache, cfg: ModelConfig, mesh, batch: int, seq: int
                ) -> M.ShardedCache:
    """This rank's blocks of a whole cache of ``batch`` rows and ``seq``
    positions (the tree of ``init_cache(cfg, batch, seq)``), laid out as
    `cache_specs` says: contiguous copies, which `models.model.
    decode_step` writes in place."""
    specs = cache_specs(cfg, mesh, batch, seq)
    return M.ShardedCache(SH.shard_tree(cache, specs, mesh), specs)


def gather_cache(cache: M.ShardedCache, mesh) -> dict:
    """The whole cache from every rank's `ShardedCache` (all-gathers over
    each leaf's split axes, in rank order): a plain dict."""
    return SH.gather_tree(dict(cache), cache.specs, mesh)


def init_sharded_cache(cfg: ModelConfig, mesh, batch: int, seq: int,
                       device="cuda") -> M.ShardedCache:
    """`shard_cache` of ``init_cache(cfg, batch, seq)`` made directly as
    zeros of this rank's block shapes (the whole cache is never held)."""
    dev = M.resolve_device(device)
    specs = cache_specs(cfg, mesh, batch, seq)
    local = SH.shard_tree(cache_struct(cfg, batch, seq), specs, mesh)
    return M.ShardedCache(M._map_with_path(
        lambda _p, t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
        local), specs)


def decode_inputs(cfg: ModelConfig, mesh, batch: int, seq: int):
    """(cache_struct, cache_spec, tokens_struct, tokens_spec,
    length_struct, length_spec)."""
    dp = _dp(mesh)
    b_ok = batch % _n_dp(mesh) == 0
    tok = _meta((batch, 1), torch.int32)
    length = _meta((batch,), torch.int32)
    bspec = (dp,) if b_ok else ()
    return (cache_struct(cfg, batch, seq), cache_specs(cfg, mesh, batch, seq),
            tok, bspec, length, bspec)

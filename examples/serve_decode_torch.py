"""Serving example, PyTorch port: batched greedy decoding with a cache
(GQA K/V, MLA latents, SSM and conv states), GQA decode attention in the
hand-written CUDA flash-decode kernel; the kernel's wrapper is also called
directly at the end.

  python3 examples/serve_decode_torch.py                       # H100, full width
  python3 examples/serve_decode_torch.py --arch zamba2-1.2b    # any family
  python3 examples/serve_decode_torch.py --arch llama4-scout-17b-a16e \
      --layers 2              # full width, depth cut to fit one card
  PYTHONPATH=src python examples/serve_decode_torch.py --smoke --device cpu \
      --arch deepseek-v3-671b

The counterpart of examples/serve_decode.py, with its flags and defaults.
By default it runs ``--arch qwen1.5-4b`` at full width in bf16 (40 layers,
d_model 2560, ~3.95 B parameters, ~7.9 GB) on the card, with random weights
from a seeded generator; ``--smoke`` takes the config's smoke variant,
``--layers`` cuts the depth (DeepSeek-V3 keeps one dense layer) and
``--device cpu`` runs on the CPU. Without a card, the default device
raises. Every family decodes but the encoder (hubert-xlarge), which raises
``ValueError`` as the reference's does; Mamba2 and DeepSeek-V3 (MLA)
decode without the flash-decode kernel.
"""
import argparse
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.core import rng as RNG  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced smoke variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args()

    dev = M.resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  n_dense_layers=min(cfg.n_dense_layers, 1))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    prompt = torch.from_numpy(
        RNG.stream(args.seed, RNG.KIND_DATASET).integers(
            0, cfg.vocab, (args.batch, args.prompt_len))).to(dev, torch.int32)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    t0 = time.perf_counter()
    out = M.generate(params, cfg, prompt, args.new_tokens, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    steps = args.prompt_len + args.new_tokens - 1
    toks_s = args.batch * out.shape[1] / wall
    print(f"[{cfg.name}] generated {out.shape[1]} tokens/seq × {args.batch} "
          f"seqs ({toks_s:.1f} tok/s, {wall / steps * 1e3:.2f} ms per decode "
          f"step incl. the first call's set-up, on {name})")
    print("sample:", out[0, :16].tolist())

    # the flash-decode kernel's wrapper, called directly
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B, H, Hkv, D, S = 2, 8, 4, 64, 2048
    q = torch.randn((B, H, D), generator=gen, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
    o = FA.decode_attention(q, k, v, torch.tensor([S, S // 2],
                                                  dtype=torch.int32,
                                                  device=dev))
    route = "CUDA kernel" if dev.type == "cuda" else "plain twin (CPU)"
    print(f"decode_attention ({route}) output:", tuple(o.shape), "finite:",
          bool(torch.isfinite(o).all()))


if __name__ == "__main__":
    main()

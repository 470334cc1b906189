"""Serving CLI: prefill a batch of random prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 1000 --gen 32           # full width, on CUDA
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 8 --prompt-len 1000 --gen 32           # the hybrid, 13.3 GB bf16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \
        --batch 8 --prompt-len 1000 --gen 32           # the VLM, 39.7 GB bf16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --batch 8 --prompt-len 16 --gen 32             # the enc-dec, 1,500 frames a clip
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --batch 8 --prompt-len 1000 --gen 32           # 128 experts, top-8, 61.1 GB bf16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

Weights are random, drawn from ``--seed``. Unlike the reference CLI, whose
``--smoke`` flag is always on, this one runs the full config unless
``--smoke`` is given. A VLM's prompts sit behind ``num_patch_tokens`` patch
embeddings, zeros in the model's dtype as in the reference CLI (the ViT
frontend is a stub), and the cache's length counts them. An enc-dec's
encoder takes ``encoder_seq`` frame embeddings a prompt, drawn N(0, 1) from
the same seeded generator after the tokens and cast to bf16, as in the
reference CLI (the conv frontend is a stub).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the config with reduce_for_smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = torch.device(args.device)
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    npatch = cfg.num_patch_tokens
    patch_embeds = (torch.zeros((args.batch, npatch, cfg.d_model), dtype=model.dtype,
                                device=device) if npatch else None)
    frames = None
    if cfg.encoder_layers:
        frames = torch.from_numpy(rng.normal(size=(args.batch, cfg.encoder_seq, cfg.d_model))
                                  ).to(torch.bfloat16).to(device)
    prefill = build_prefill_step(model)
    decode = build_decode_step(model)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(tokens, npatch + args.prompt_len + args.gen, patch_embeds, frames)
    _sync(device)
    print(f"prefill: {args.batch}x{args.prompt_len} in {time.perf_counter() - t0:.2f}s")

    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode(cache, tok)
        tok = logits.argmax(-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    seqs = torch.stack(out, dim=1).cpu().numpy()
    print(f"decoded {args.gen} tokens/seq ({args.gen - 1} decode steps) in {dt:.2f}s "
          f"({args.batch * (args.gen - 1) / max(dt, 1e-9):.1f} tok/s)")
    print("first sequence:", seqs[0].tolist())
    return seqs


if __name__ == "__main__":
    main()

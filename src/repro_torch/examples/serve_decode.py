"""Serve a small model with batched requests: prefill + KV-cache greedy
decode, including a Mamba2 (attention-free) model whose decode state is O(1).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode               # CUDA
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

The port of the reference's ``examples/serve_decode.py``: the same two
models at smoke scale, 4 prompts of 12 tokens, 12 greedy tokens each.
Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    device = torch.device(args.device)
    for arch in ("qwen3-0.6b", "mamba2-2.7b"):
        cfg = reduce_for_smoke(get_arch(arch))
        model = build_model(cfg, device=device)
        model.init(torch.Generator(device=device).manual_seed(0))
        rng = np.random.default_rng(0)
        b, prompt, gen = 4, 12, 12

        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt))).to(device)
        logits, cache = build_prefill_step(model)(tokens, prompt + gen)
        decode = build_decode_step(model)
        tok = logits.argmax(-1)
        toks = [tok]
        # simlint: disable=SIM001 -- the example's own host-side duration, printed
        t0 = time.time()
        for _ in range(gen - 1):
            logits, cache = decode(cache, tok)
            tok = logits.argmax(-1)
            toks.append(tok)
        out = torch.stack(toks, 1).cpu().numpy()
        state_kind = "KV cache" if "k" in cache else "SSM state (O(1) in seq!)"
        # simlint: disable=SIM001 -- the example's own host-side duration, printed
        seconds = time.time() - t0
        print(f"{arch}: generated {out.shape} tokens in {seconds:.2f}s via {state_kind}")
        print("  seq0:", out[0].tolist())


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line; any failure exits non-zero at once. The
slices and the serve runs come before any phase that opens torch.profiler:

1. device    -- a CUDA device is required; prints nvidia-smi's name and power limit.
2. build     -- compiles the CUDA kernels from src/repro_torch/csrc with nvcc;
                registers and spills of every kernel, and the HGMMA (wgmma)
                instructions in the SASS (cuobjdump) of the bf16 flash and SSD
                kernels, which must be there.
3. slice     -- qwen3-0.6b at full width, 2 layers, fp32: the same weights on the
                CPU (plain versions) and on the card (kernels), B=2, prompt 128,
                4 decode steps; logits compared.
4. serve     -- full qwen3-0.6b (28 layers, bf16, seeded random weights): 8
                requests of 1000 prompt tokens, 32 greedy tokens each, through
                the port's prefill and decode steps. Launch counts are zeroed
                just before and read just after: 28 prefill-kernel and 28 x 31
                decode-kernel launches, no SSD launch.
5. slice_ssm -- mamba2-2.7b at full width, 2 layers, fp32, CPU against card:
                B=2, prompt 600 (3 chunks, the last ragged), 4 decode steps;
                logits at every step and the final decode state compared; 2
                SSD launches, both on the fp32 route.
6. serve_ssm -- full mamba2-2.7b (64 layers, bf16, seeded random weights), the
                same 8 x 1000 prompts and 32 greedy tokens: 64 SSD launches, all
                on the wgmma route, no attention-kernel launch.
6b. serve_hybrid -- full zamba2-7b (81 Mamba2 layers, the shared attention block
                after 13 of them, head_dim 112, bf16, random weights drawn on the
                card from a seed), the same requests: 13 flash launches on wgmma
                at head_dim 112, 13 x 31 decode launches, 81 SSD launches on
                wgmma; prefill and decode times beside their bounds. Freed after.
6c. slice_moe -- qwen2-moe-a2.7b at full width, 2 layers, fp32, CPU against card:
                prefill of 1 x 576 tokens, 8 decode steps, the loss of 1 x 577
                tokens with its balance term and every gradient, at 2e-4; first
                the routing of every MoE call (top_e and the capacity verdicts,
                exactly, and the smallest gap between a token's k-th and
                (k+1)-th gate probability) is compared and printed; 4 flash and
                16 decode launches.
6d. serve_moe -- full qwen2-moe-a2.7b (24 layers, 60 routed experts padded to
                64, top-4, the shared expert, MHA 16/16 at head_dim 128, bf16,
                random weights drawn on the card from a seed), the same
                requests served twice (the repeat must equal the warm-up, whose
                routing gives the share of prefill assignments that capacity
                dropped and the experts a decode step picks): 24 flash launches
                on wgmma, 24 x 31 decode launches, no SSD launch; prefill and
                decode times beside their bounds (prefill by routed assignments
                and by the reference's dispatch slots, decode with every expert
                read and with the experts picked). Freed after.
7. train_grad -- the flash kernel under autograd (FlashAttention) against the
                plain blockwise_attention under autograd: output, dq, dk, dv at
                the training shape (bf16, B=8, S=1024, H=16, K=8, hd=128), at
                a small fp32 shape and at the scenario corpus's fp32 shapes
                (B=8 and 16, S=16, H=4, K=2, hd=16). Then DecoderLM.loss of qwen3-0.6b at full
                width, 2 layers, fp32: loss, every gradient and one AdamW step
                on the card against the same port on the CPU from the same
                weights; every attention projection's gradient finite and not 0.
                The SSD under autograd (SSD: kernel forward, ssd_chunked recompute
                backward) against autograd through ssd_chunked, bf16 and fp32: y,
                the final state and the gradients of x, dt, a, B and C. The smoke
                zamba2-7b at head_dim 112, 2 layers, fp32: loss and every gradient
                (the shared block's included) card vs CPU.
7b. train_mesh -- the sharded multi-rank train step (train.step.build_train_step)
                as four gloo ranks sharing the card, each a spawned process
                (file:// rendezvous in a temporary directory), all exited before
                the next phase. (a) Full qwen3-0.6b, bf16, FSDP and the instant
                backup, 8 x 1024 tokens a step (2 x 1024 a rank), 3 steps: each
                rank's backup bit for bit its predecessor's new optimizer blocks,
                the bytes the ring sent equal to the razor's unique bytes per
                rank, the neighbour drill (after step 2 rank 1's optimizer blocks
                are dropped and rebuilt from rank 2's backup; step 3 from there
                equals the uninterrupted step 3 bit for bit on every rank), flash
                launches in every rank (all wgmma; counts zeroed in each rank just
                before its steps) and none of decode or SSD, and the first batch
                scored again lower. Prints per step the median over ranks of the
                step time and of its gradient reduce, param gathers and
                neighbor_backup, the device memory per rank (and one step with
                fsdp_params=False beside it) and each child's peak host RSS, all
                labelled as gloo through the host on one shared card. (b) Full
                width cut to 2 layers, fp32, 2 steps: the 4-rank step against
                one rank of the same step over NCCL from the same weights and
                batches: the losses and the master of step 1 (lr 0 under the
                warmup) within 1e-5 relative, m (0.1 of the gradient) of every
                step within the slice's 2e-4, each against its leaf's largest
                magnitude; v and step 2's master are reported.
8. scenarios -- the port's adversarial scenario fleet (runtime/scenarios.py).
                First all 15 corpus scenarios at the reference's scale (qwen3
                reduced, fp32, seq 16), each built and replayed as run_scenario
                does, on the card and again on the CPU: the two verdicts must be
                equal field for field and every step's loss equal within the
                fp32 slice tolerance, with the counts zeroed just before the
                card runs every flash launch on the fp32 route and no decode or
                SSD launch. Then the events of
                clean_software_failure (a software failure of worker 1 before
                step 5, 10 steps) replayed by the port's _Runner on full
                qwen3-0.6b (28 layers, bf16, dp=4 simulated workers, 8 x 1024
                tokens a step) with the scenario's fabric and reliability values:
                10 steps, one recovery from the neighbour, 0 rollbacks, 1
                detection within one heartbeat of the analytic bound, finite
                losses, 28 x 10 flash launches all on wgmma. Prints the verdict
                beside the fields in which it differs from the reference-scale
                pin, the step split, tokens/s (by the median step and by the
                replay's whole window), the steps and host RSS before and after
                the recovery, recover()'s wall time beside its
                simulated time, peak memory and host RSS, and this run's FCR
                beside the measured host checkpoint share of the step.
8b. train_ssm -- mamba2-2.7b at full width cut to 8 of 64 layers, bf16, trained
                by SimCluster as train below (dp=4, 8 x 1024 tokens, 2 steps, a
                failure of worker 2, recover(), 2 steps): a neighbour recovery,
                0 rollbacks, the opt vector bitwise equal across recover(), 8
                SSD launches a step all on wgmma, finite losses, and the first
                step's batch scoring lower after the run; the step split, tokens/s
                and bound as train. Placed after the replay's heap trim and before
                the first profiler session; trims the heap again after.
9. train     -- the slice: full qwen3-0.6b (28 layers, bf16) trained by the
                port's SimCluster, dp=4 simulated workers on the one card, 8 x
                1024 tokens a step: 2 steps, a software failure of worker 2,
                recover() with the stream policy, 2 more steps. Requires recovery
                from the neighbour with no rollback, the optimizer vector after
                recovery bitwise equal to a host copy taken before the failure,
                finite losses, and, with the counts zeroed just before, 28 x 4
                flash launches (all wgmma) and no decode or SSD launch. Prints
                the step split (device by CUDA events, host checkpoint by the
                host clock), tokens/s, the step's bound, peak device memory, peak
                host RSS and recover()'s wall time beside its simulated time;
                then one more device step under torch.profiler (the script's
                first profiler session): busy share and the largest kernels.
10. kernels  -- each kernel against its plain PyTorch version on the card at the
                serve shapes, zamba2-7b's at head_dim 112 too (prefill B=8,
                S=1000, H=K=32; decode T=1032, cur_len 1032; its SSD, 112 heads,
                N 64, bf16), qwen2-moe-a2.7b's in bf16 (prefill B=8, S=1000,
                H=K=16, hd 128; decode T=1032, cur_len 1032) (prefill B=8, S=1000, H=16, K=8, hd=128, causal, with
                the wrapper's route: wgmma for bf16, fp32 for fp32; bf16 also at
                the training step's S=1024; decode B=8,
                T=1032, cur_len 1 / 129 / 777 / 1032 with the planned n_split;
                SSD B=8, S=1000 (ragged last chunk) and 1024, H=80, P=64, N=128,
                chunk 256: the full ops.ssd against ssd_chunked, bf16 on the
                wgmma route, once more with an initial state, and fp32, whose
                intra-chunk kernel is also held to its three outputs), with the
                kernel's, the plain version's and (for attention) the library
                call's times
                (F.scaled_dot_product_attention, a yardstick only), the card's
                bound for the same work and the wrapper's host time per launch.
                Times are CUPTI device times from torch.profiler; where no
                profiler session sees device activity, CUDA events time the
                calls instead. Each kernel is also timed by events
                (``event_ms``), a check of that fallback.
11. trace    -- torch.profiler over one prefill and over 4 decode steps of each
                model: device busy share and the kernels that take the device time.
12. serve    -- qwen3-0.6b served again, as in 4, now after the profiler
                sessions (``after_profiler``: true).

Then a ``timing`` line (kernel timings taken by CUPTI and by CUDA events, the
host seconds of each phase),
one {"kernels": [...]} line (each kernel's launches in every serve and training
phase, ``moe_launches`` among them, and its rows at the other shapes), the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PREFILL = dict(b=8, s=1000, h=16, kh=8, hd=128)
DECODE = dict(b=8, t=1032, h=16, kh=8, hd=128, cur_lens=(1, 129, 777, 1032))
SSD = dict(b=8, h=80, p=64, n=128, chunk=256, seqs=(1000, 1024))
# zamba2-7b's serve shapes: MHA of 32 heads at head_dim 112 (the hd-128
# instantiations, zero-padded), and its SSD (112 heads, N 64)
PREFILL_HD112 = dict(b=8, s=1000, h=32, kh=32, hd=112)
DECODE_HD112 = dict(b=8, t=1032, h=32, kh=32, hd=112, cur_lens=(1032,))
SSD_HYBRID = dict(b=8, h=112, p=64, n=64, chunk=256, seqs=(1000,))
# qwen2-moe-a2.7b's serve shapes: MHA of 16 heads at head_dim 128 (group 1),
# bf16
PREFILL_MOE = dict(b=8, s=1000, h=16, kh=16, hd=128)
DECODE_MOE = dict(b=8, t=1032, h=16, kh=16, hd=128, cur_lens=(1032,))
SERVE = dict(batch=8, prompt=1000, gen=32)
SSM_SLICE = dict(batch=2, prompt=600, steps=4)
# the SSD kernel's chunk states and decay against the plain version: the
# state tolerance of tests/test_kernels.py
STATE_TOL = 1e-3
# kernel against plain: the tolerances of tests/test_kernels.py
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the flash wrapper's route by dtype: bf16 on the tensor cores, fp32 on the
# CUDA cores
EXPECTED_ROUTE = {"bfloat16": "wgmma", "float32": "fp32"}
# whole slice, card against CPU, fp32: the tolerance of the reference's
# test_prefill_decode_matches_forward
SLICE_TOL = 2e-4
# the training slice (ISSUE's cell): qwen3-0.6b, dp=4 simulated workers,
# 8 x 1024 tokens a step, 2 steps, a failure of worker 2, 2 more steps
TRAIN = dict(dp=4, global_batch=8, seq_len=1024, steps_before=2, steps_after=2,
             failed=2)
# flash gradients, kernel under autograd against the plain version: bf16 at
# the training shape, fp32 (TF32 off) at a small one and at the scenario
# corpus's two shapes (the reduced qwen3-0.6b, global batch 8 and 16)
GRAD = dict(bf16=dict(b=8, s=1024, h=16, kh=8, hd=128, tol=2e-2),
            fp32=dict(b=2, s=200, h=4, kh=2, hd=64, tol=1e-4),
            fp32_corpus_b8=dict(b=8, s=16, h=4, kh=2, hd=16, tol=1e-4),
            fp32_corpus_b16=dict(b=16, s=16, h=4, kh=2, hd=16, tol=1e-4))
# DecoderLM.loss at full width, 2 layers, fp32, card against CPU: 1 x 576
# tokens (a 512-position xent chunk and a ragged one of 64)
LOSS = dict(batch=1, seq=576, tol=2e-4)
# the SSD under autograd (SSD.apply: kernel forward, plain recompute
# backward) against autograd through ssd_chunked, a small shape per route
SSD_GRAD = dict(bf16=dict(b=2, s=300, h=4, p=64, n=128, chunk=256, tol=2e-2),
                fp32=dict(b=2, s=200, h=4, p=64, n=64, chunk=64, tol=1e-4))
# the hybrid's loss and gradients, card against CPU: the smoke zamba2-7b at
# head_dim 112, 2 layers (one shared-block application), fp32
HYBRID_LOSS = dict(batch=2, seq=64, tol=2e-4)
# the MoE slice, card against CPU: qwen2-moe-a2.7b at full width cut to 2
# layers (a CPU copy of 24 fp32 layers would be 60 GB; 2 layers with the head
# and the embedding are 1.83 B parameters, 7.3 GB), fp32, the tokens of LOSS:
# prefill of 1 x 576, 8 decode steps, the loss of 1 x 577 and every gradient
MOE_SLICE = dict(layers=2, batch=LOSS["batch"], seq=LOSS["seq"], steps=8, tol=2e-4)
# the SSM training cell: mamba2-2.7b at full width cut to 8 of 64 layers (the
# host copies of the full 32.4 GB opt state would not fit the host), dp=4
# simulated workers, 8 x 1024 tokens a step, 2 steps, a failure, 2 steps
TRAIN_SSM = dict(layers=8, dp=4, global_batch=8, seq_len=1024, steps_before=2,
                 steps_after=2, failed=2)
L2_BYTES = 50 * 10**6
T_START = time.perf_counter()
PROFILER_SESSIONS = [0]     # torch.profiler sessions opened so far in this process
TIMING = {"cupti": 0, "cuda_events": 0}     # kernel timings taken by each method
PHASE_S: dict = {}          # host seconds of each phase, for the timing line


def timed(name: str, fn, *args):
    """``fn(*args)``, its host seconds added to ``PHASE_S[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_events(torch, prof) -> list:
    """(name, microseconds) of every activity the device ran (kernels,
    copies, fills) in a torch.profiler trace, as CUPTI timed it."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
            if ev.device_type == cuda]


def timing_since(before: dict) -> list:
    """The methods that timed calls since the ``TIMING`` snapshot ``before``."""
    return [m for m in TIMING if TIMING[m] > before[m]]


def profiled(torch, fn, tries: int = 2):
    """Run ``fn`` under torch.profiler and return the trace's device
    activities; a session that saw none (CUPTI now and then delivers no
    activity records) is opened again, up to ``tries`` sessions. An empty
    list means that every session saw none."""
    from torch.profiler import ProfilerActivity, profile
    events = []
    for _ in range(tries):
        torch.cuda.synchronize()
        PROFILER_SESSIONS[0] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(torch, prof)
        if events:
            break
        print("chip_smoke: a profiler session saw no device activity", file=sys.stderr,
              flush=True)
    return events


def event_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of one call by CUDA events around ``iters`` calls,
    for when the profiler sees no device activity. A spin kernel ahead of
    the calls keeps the device busy while the host enqueues them, so the
    calls run back to back and the host's launch cost stays out of the
    time; the spin is lengthened (at most twice) until the start event is
    still pending when the host has enqueued the last call. Where it never
    is, the time returned includes host gaps: an upper bound."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * host_s + 1e-3))       # >= 2x the host's time at up to 2 GHz
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
        overlapped = not start.query()
        end.synchronize()
        if overlapped:
            break
        cycles *= 4
    else:
        print("chip_smoke: event timing includes host gaps", file=sys.stderr, flush=True)
    return start.elapsed_time(end) / iters


def time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of one call: the summed durations of the device
    activities it launches, over ``iters`` calls that cycle through
    ``args_list`` (copies of the inputs, together larger than L2, so that
    each call reads its inputs from device memory). Host time between
    launches is not counted. Where the profiler sees no device activity,
    CUDA events time the calls instead (``event_ms``); ``TIMING`` counts
    the timings taken each way."""
    fn(*args_list[0])

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    total_us = sum(us for _, us in profiled(torch, run))
    if total_us > 0:
        TIMING["cupti"] += 1
        return total_us / 1e3 / iters
    TIMING["cuda_events"] += 1
    return event_ms(torch, fn, args_list, iters)


def host_us(torch, fn, args, iters: int = 200) -> float:
    """Host time to enqueue one call (checks, allocation, launch), by the
    host clock around ``iters`` calls, excluding the final synchronize."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def input_copies(tensors) -> list:
    """The inputs and enough clones of them to hold twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, math.ceil(2 * L2_BYTES / nbytes) + 1)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def check_close(name: str, out, ref, tol: float) -> float:
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff > tol + tol * ref.float().abs()).sum().item()
    if not math.isfinite(err) or bad:
        fail(f"{name}: {bad} elements beyond rtol=atol={tol}, max abs err {err}")
    return err


def demangle(names: list) -> list:
    """Short kernel names (``decode_split_kernel<__nv_bfloat16, 128, 2>``)
    by c++filt where the toolchain has it, else the mangled names."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    short = []
    for name, full in zip(names, out):
        m = re.search(r"(\w+_kernel(?:<[^>]*>)?)\(", full)
        short.append(m.group(1) if m else name)
    return short


def ptxas_summary(log: str) -> list:
    """Registers and spill bytes of every kernel in the library, from nvcc's
    ``-Xptxas -v`` output (kept beside the library by the build)."""
    rows = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers", log, re.S)
    names = demangle([name for name, _, _ in rows])
    return [dict(kernel=name, spill_store_bytes=int(sp), registers=int(r))
            for name, (_, sp, r) in zip(names, rows)]


def cuobjdump() -> str:
    """The toolkit's cuobjdump: beside the nvcc that builds the kernels,
    else the copy in Triton's package."""
    from repro_torch.kernels import _build
    path = Path(_build.nvcc()).parent / "cuobjdump"
    if path.exists():
        return str(path)
    try:
        import triton
    except ImportError:
        fail("cuobjdump not found beside nvcc and no triton package")
    path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if not path.exists():
        fail("cuobjdump not found beside nvcc nor in triton's package")
    return str(path)


# tensor-core kernels and their instantiations in the library
WGMMA_KERNELS = {"flash_wgmma_kernel": 5, "ssd_wgmma_kernel": 7}


def sass_hgmma(library: Path) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each instantiation of the
    bf16 flash and SSD kernels; fails unless every one has some."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for kernel, instances in WGMMA_KERNELS.items():
        found = {}
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            if kernel in name:
                found[name] = block.count("HGMMA")
        if len(found) != instances or not all(found.values()):
            fail(f"HGMMA missing from the SASS of {kernel}: {found}")
        counts.update(zip(demangle(list(found)), found.values()))
    return counts


def phase_kernels(torch, F):
    from repro_torch.kernels import decode_attn, flash_attention, ops
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.roofline.hw import bound_seconds

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": {}, "decode_attention": {}}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the serve shape in both dtypes, the training step's (S=1024) in bf16,
    # zamba2-7b's serve shape (hd 112) in both dtypes and qwen2-moe-a2.7b's
    # (MHA at hd 128) in bf16
    for key, dtype, p in (("bfloat16", torch.bfloat16, PREFILL),
                          ("float32", torch.float32, PREFILL),
                          ("bfloat16_train", torch.bfloat16,
                           dict(PREFILL, s=TRAIN["seq_len"])),
                          ("bfloat16_hd112", torch.bfloat16, PREFILL_HD112),
                          ("float32_hd112", torch.float32, PREFILL_HD112),
                          ("bfloat16_moe", torch.bfloat16, PREFILL_MOE)):
        dname = str(dtype).split(".")[-1]
        q = rand((p["b"], p["s"], p["h"], p["hd"]), dtype)
        k = rand((p["b"], p["s"], p["kh"], p["hd"]), dtype)
        v = rand((p["b"], p["s"], p["kh"], p["hd"]), dtype)
        routed = dict(flash_attention.flash_attention.routes)
        out = flash_attention.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        route = [r for r, n in flash_attention.flash_attention.routes.items()
                 if n != routed[r]]
        if route != [EXPECTED_ROUTE[dname]]:
            fail(f"flash_attention {dname}: went by route {route}, "
                 f"expected {EXPECTED_ROUTE[dname]}")
        ref = ops.flash_attention_plain(q, k, v, causal=True)
        err = check_close(f"flash_attention {dname}", out, ref, TOL[dname])
        per_call = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        args = input_copies((q, k, v))
        before = dict(TIMING)
        kernel = lambda a, b_, c: flash_attention.flash_attention(a, b_, c, causal=True)  # noqa: E731
        ms = time_ms(torch, kernel, args, 20)
        ev_ms = event_ms(torch, kernel, args, 20)
        launch_us = host_us(torch, kernel, args[0], 20)
        plain_ms = time_ms(torch, lambda a, b_, c: ops.flash_attention_plain(a, b_, c, causal=True),
                           args, 3)
        library_ms = time_ms(torch, lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2), is_causal=True,
            enable_gqa=True), args, 20)
        pairs = p["s"] * (p["s"] + 1) // 2                   # causal (q, k) pairs
        flops = 4 * p["b"] * p["h"] * p["hd"] * pairs
        bound_s, bound_by = bound_seconds(flops, per_call, dname)
        row = dict(kernel="flash_attention", dtype=dname, route=route[0], shape=p,
                   causal=True, max_abs_err=err, tol=TOL[dname], ms=ms, event_ms=ev_ms,
                   plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
                   host_us_per_launch=launch_us, gflop=flops / 1e9, mbytes=per_call / 1e6,
                   timing=timing_since(before))
        results["flash_attention"][key] = row
        emit("kernels", **row)
        del q, k, v, out, ref, args

    for suffix, d, dtype in (("", DECODE, torch.bfloat16), ("", DECODE, torch.float32),
                             ("_hd112", DECODE_HD112, torch.bfloat16),
                             ("_hd112", DECODE_HD112, torch.float32),
                             ("_moe", DECODE_MOE, torch.bfloat16)):
        dname = str(dtype).split(".")[-1]
        q = rand((d["b"], 1, d["h"], d["hd"]), dtype)
        kc = rand((d["b"], d["t"], d["kh"], d["hd"]), dtype)
        vc = rand((d["b"], d["t"], d["kh"], d["hd"]), dtype)
        args = input_copies((q, kc, vc))
        rows = []
        for cur_len in d["cur_lens"]:
            out = decode_attn.decode_attention(q, kc, vc, cur_len)
            torch.cuda.synchronize()
            n_split, rows_per_split = decode_attn.decode_attention.last_split
            ref = decode_attention_ref(q, kc, vc, cur_len)
            err = check_close(f"decode_attention {dname} cur_len={cur_len}", out, ref,
                              TOL[dname])
            per_call = (2 * q.numel() + 2 * d["b"] * cur_len * d["kh"] * d["hd"]) \
                * q.element_size()
            before = dict(TIMING)
            kernel = lambda a, b_, c: decode_attn.decode_attention(a, b_, c, cur_len)  # noqa: E731
            ms = time_ms(torch, kernel, args, 50)
            ev_ms = event_ms(torch, kernel, args, 50)
            launch_us = host_us(torch, kernel, args[0])
            plain_ms = time_ms(torch, lambda a, b_, c: decode_attention_ref(a, b_, c, cur_len),
                               args, 10)
            library_ms = time_ms(torch, lambda a, b_, c: F.scaled_dot_product_attention(
                a.transpose(1, 2), b_[:, :cur_len].transpose(1, 2),
                c[:, :cur_len].transpose(1, 2), enable_gqa=True), args, 50)
            flops = 4 * d["b"] * d["h"] * d["hd"] * cur_len
            bound_s, bound_by = bound_seconds(flops, per_call, dname)
            row = dict(kernel="decode_attention", dtype=dname,
                       shape={k_: v_ for k_, v_ in d.items() if k_ != "cur_lens"},
                       cur_len=cur_len, n_split=n_split, rows_per_split=rows_per_split,
                       max_abs_err=err, tol=TOL[dname], ms=ms, event_ms=ev_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_s * 1e3, bound_by=bound_by,
                       host_us_per_launch=launch_us, mflop=flops / 1e6,
                       mbytes=per_call / 1e6, timing=timing_since(before))
            rows.append(row)
            emit("kernels", **row)
        results["decode_attention"][dname + suffix] = rows
        del q, kc, vc, args
    torch.cuda.empty_cache()
    return results


def phase_slice(torch):
    """Full width, 2 layers, fp32: CPU (plain versions) against the card
    (kernels), the same weights and the same tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attn, flash_attention
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    import numpy as np
    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=2, dtype="float32")
    b, prompt, steps = 2, 128, 4
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (b, prompt)))
    max_len = prompt + steps + 1

    flash_attention.flash_attention.launches = 0
    decode_attn.decode_attention.launches = 0
    errs = []
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev), max_len)
        outs = [logits.cpu()]
        for step in range(steps):
            # both sides take the CPU's greedy token
            tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            outs.append(logits.cpu())
        runs[name] = outs
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (b, cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice logits card vs cpu", out, ref, SLICE_TOL))
    launches = (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches)
    if launches != (cfg.num_layers, cfg.num_layers * steps):
        fail(f"slice: kernel launches {launches}, expected "
             f"({cfg.num_layers}, {cfg.num_layers * steps})")
    emit("slice", config="qwen3-0.6b full width, 2 layers, fp32", batch=b, prompt=prompt,
         decode_steps=steps, max_abs_err_per_step=errs, tol=SLICE_TOL,
         flash_launches=launches[0], decode_launches=launches[1])
    del cpu, card
    torch.cuda.empty_cache()


def reset_launches() -> None:
    """Set every kernel wrapper's launch count, and the flash and SSD
    counts by route, to 0."""
    from repro_torch.kernels import decode_attn, flash_attention, ssd
    flash_attention.flash_attention.launches = 0
    flash_attention.flash_attention.routes = dict.fromkeys(
        flash_attention.flash_attention.routes, 0)
    decode_attn.decode_attention.launches = 0
    ssd.ssd.launches = 0
    ssd.ssd.routes = dict.fromkeys(ssd.ssd.routes, 0)


def read_launches() -> dict:
    from repro_torch.kernels import decode_attn, flash_attention, ssd
    return {"flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attn.decode_attention.launches,
            "ssd": ssd.ssd.launches, "ssd_routes": dict(ssd.ssd.routes)}



def serve_once(torch, prefill, decode, tokens, max_len, gen):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(tokens, max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(cache, tok)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return torch.stack(out, 1), bool(finite), t_prefill, t_decode, logits.shape


def serve_bounds(cfg, params: int, b: int, prompt: int, gen: int):
    """The card's least time for the serve run's prefill and for its mean
    decode step, bf16: weight bytes read once, KV cache bytes written or
    read once, and the matrix products' and attention's operations."""
    from repro_torch.roofline.hw import bound_seconds
    L, kh, h, hd = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # tied embedding / head
    n_body = params - n_head
    weight_bytes = 2 * params
    kv_bytes_per_pos = 2 * L * b * kh * hd * 2        # K and V, all layers, bf16
    prefill_flops = (2 * n_body * b * prompt + 2 * n_head * b
                     + L * 4 * b * h * hd * prompt * (prompt + 1) // 2)
    prefill = bound_seconds(prefill_flops, weight_bytes + kv_bytes_per_pos * prompt,
                            "bfloat16")
    lens = range(prompt + 1, prompt + gen)             # attended lengths per step
    steps = gen - 1
    decode_flops = 2 * params * b + L * 4 * b * h * hd * sum(lens) / steps
    decode_bytes = weight_bytes + kv_bytes_per_pos * sum(lens) / steps
    return prefill, bound_seconds(decode_flops, decode_bytes, "bfloat16")


def phase_serve(torch, served=None):
    """Full qwen3-0.6b: build it, warm up and serve once; or, given
    ``served`` (what an earlier call returned), serve the same model again,
    as after the profiler phases."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("qwen3-0.6b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    if served is None:
        model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
        warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)
        served = (model, prefill, decode, tokens, warm)
    model, prefill, decode, tokens, warm = served

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"serve: kernel launches {launches}, expected {expected}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve: generated tokens out of range")
    prefill_bound, decode_bound = serve_bounds(cfg, param_count(cfg), b, prompt, gen)
    row = dict(config="qwen3-0.6b full (28 layers, bf16)", params=param_count(cfg),
               batch=b, prompt=prompt, gen=gen, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               after_profiler=PROFILER_SESSIONS[0] > 0,
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve", **row)
    return served, row


def device_share(torch, fn, top: int = 6, classify=None):
    """Profile ``fn``: wall ms (host clock, ending in a synchronize), the
    device's busy ms (summed device activity, one stream) and its share of
    the wall time, and the activities that take the most device time; with
    ``classify`` (activity name -> group), device ms and calls by group too.
    Where no profiler session saw device activity, the device numbers are
    null (not measured)."""
    wall = []

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    events = profiled(torch, run)
    wall_ms = wall[-1]
    if not events:
        return dict(wall_ms=wall_ms, device_busy_ms=None, device_busy_share=None,
                    device_activities=None, top=[],
                    note="not measured: no profiler session saw device activity")
    by_name = {}
    for name, us in events:
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, calls + 1)
    busy_ms = sum(total for total, _ in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
               device_activities=sum(calls for _, calls in by_name.values()),
               top=[dict(name=n[:90], device_ms=t / 1e3, calls=c) for n, (t, c) in ranked])
    if classify is not None:
        groups = {}
        for name, (us, calls) in by_name.items():
            g = groups.setdefault(classify(name), [0.0, 0])
            g[0] += us / 1e3
            g[1] += calls
        out["groups"] = {g: dict(device_ms=ms, calls=c) for g, (ms, c) in
                         sorted(groups.items(), key=lambda kv: -kv[1][0])}
    return out


def train_kernel_group(name: str) -> str:
    """The group of a device activity of the training step, by its name."""
    if "flash_wgmma_kernel" in name or "flash_fwd_kernel" in name:
        return "flash kernel (ours)"
    if "gemm" in name or "nvjet" in name:
        fp32 = any(tag in name for tag in ("f32f32_f32f32", "sgemm", "ffma"))
        return "fp32 matmul (CUDA cores)" if fp32 else "bf16 matmul (tensor cores)"
    return "elementwise, reductions, copies"


def phase_trace(torch, prefill, decode, tokens, model: str):
    prompt, gen = SERVE["prompt"], SERVE["gen"]
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(tokens, prompt + gen)

    def run_decode():
        logits, cache = state["logits"], state["cache"]
        for _ in range(4):
            logits, cache = decode(cache, logits.argmax(-1))

    emit("trace", model=model, part="prefill", **device_share(torch, run_prefill))
    emit("trace", model=model, part="decode x4", **device_share(torch, run_decode))


def ssd_work(b: int, s: int, h: int, p: int, n: int, lc: int, itemsize: int) -> tuple:
    """(operations, bytes) of the SSD chunk kernel's function as the TPU
    kernel defines it: the causal work on the valid rows (C.B^T scores once
    per chunk, the weighted sum into y per head, the end state per head), and
    each input read once and each output written once (x, dt, a, B, C in;
    y_intra in x's dtype, chunk states and decay in fp32 out)."""
    nc = -(-s // lc)
    ops = 0
    for c in range(nc):
        rows = min(lc, s - c * lc)
        pairs = rows * (rows + 1) // 2
        ops += b * (2 * pairs * n + h * (2 * pairs * p + 2 * rows * n * p))
    nbytes = (2 * b * s * h * p * itemsize + b * s * h * 4 + h * 4
              + 2 * b * s * n * itemsize + b * nc * h * n * p * 4 + b * nc * h * 4)
    return ops, nbytes


def ssd_full_work(b: int, s: int, h: int, p: int, n: int, lc: int, itemsize: int) -> tuple:
    """(operations, bytes) of the full SSD (``ops.ssd``): the TPU kernel's
    causal work (``ssd_work``) plus the inter-chunk term C . S_prev on every
    row per head; x, dt, a, B and C read once, y (x's dtype) and the final
    state (fp32) written once."""
    ops, _ = ssd_work(b, s, h, p, n, lc, itemsize)
    ops += 2 * b * s * h * n * p
    nbytes = (2 * b * s * h * p * itemsize + b * s * h * 4 + h * 4 + 2 * b * s * n * itemsize
              + b * h * n * p * 4)
    return ops, nbytes


# The previous design's full bf16 ops.ssd (the CUDA-core chunk kernel of
# ssd.cu in bf16 plus the plain combine), device ms per call at the serve
# shape by sequence length: the ``ssd_ms`` that chip_smoke.py printed at
# commit 811c7eb on an H100 80GB HBM3 with a 700.00 W power limit. Not
# measured by this run: that code is gone.
SSD_BEFORE_MS = {1000: 2.414251599999998, 1024: 2.403853499999999}


def phase_ssd_kernel(torch) -> dict:
    """The full SSD (``ops.ssd``) against ``ssd_chunked`` at mamba2's serve
    shape (S=1000: the last 256-row chunk ragged) and at S=1024: bf16 on the
    tensor-core route (also with an initial state), fp32 on the CUDA-core
    route, whose intra-chunk kernel is also held to its three outputs; and
    bf16 at zamba2-7b's serve shape (112 heads, N 64)."""
    from repro_torch.kernels import ops, ssd
    from repro_torch.kernels.ref import ssd_intra_chunk_ref, ssd_ref
    from repro_torch.roofline.hw import bound_seconds

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    cases = [("mamba2-2.7b", SSD, s, dtype) for s in SSD["seqs"]
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("zamba2-7b", SSD_HYBRID, s, torch.bfloat16) for s in SSD_HYBRID["seqs"]]
    for model, k, s, dtype in cases:
        b, h, p, n, lc = k["b"], k["h"], k["p"], k["n"], k["chunk"]
        dname = str(dtype).split(".")[-1]
        # the distributions of tests/test_kernels.py
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        dt = 0.001 + 0.099 * torch.rand((b, s, h), generator=gen, device="cuda")
        a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device="cuda"))
        bm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
        cm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
        args = (x, dt, a, bm, cm)
        name = f"ssd {model} {dname} S={s}"
        extra = {}
        if dtype == torch.float32:            # the CUDA-core kernel's own outputs
            got = ssd.ssd_intra_chunk(*args, chunk=lc)
            torch.cuda.synchronize()
            want = ssd_intra_chunk_ref(*args, chunk=lc)
            extra = dict(
                y_intra_err=check_close(f"{name} y_intra", got[0], want[0], TOL[dname]),
                states_err=check_close(f"{name} chunk states", got[1], want[1], STATE_TOL),
                decay_err=check_close(f"{name} chunk decay", got[2], want[2], STATE_TOL))
            del got, want
        routed = dict(ssd.ssd.routes)
        y, final = ops.ssd(*args, chunk=lc)
        torch.cuda.synchronize()
        route = [r for r, c in ssd.ssd.routes.items() if c != routed[r]]
        if route != [EXPECTED_ROUTE[dname]]:
            fail(f"{name}: went by route {route}, expected {EXPECTED_ROUTE[dname]}")
        y_ref, final_ref = ssd_ref(*args, chunk=lc)
        if y.shape != x.shape or y.dtype != dtype or final.shape != (b, h, n, p):
            fail(f"{name}: y {tuple(y.shape)} {y.dtype}, final {tuple(final.shape)}")
        y_err = check_close(f"{name} y vs ssd_chunked", y, y_ref, TOL[dname])
        final_err = check_close(f"{name} final state vs ssd_chunked", final, final_ref,
                                STATE_TOL)
        if dtype == torch.bfloat16:           # a carried-in state
            init = torch.randn((b, h, n, p), generator=gen, device="cuda")
            y, final = ops.ssd(*args, chunk=lc, initial_state=init)
            y_ref, final_ref = ssd_ref(*args, chunk=lc, initial_state=init)
            extra = dict(
                initial_state_y_err=check_close(f"{name} y with initial state", y, y_ref,
                                                TOL[dname]),
                initial_state_final_err=check_close(
                    f"{name} final state with initial state", final, final_ref, STATE_TOL))
            del init
        del y, final, y_ref, final_ref
        copies = input_copies(args)
        before = dict(TIMING)
        kernel = lambda *t: ops.ssd(*t, chunk=lc)  # noqa: E731
        ms = time_ms(torch, kernel, copies, 20)
        ev_ms = event_ms(torch, kernel, copies, 20)
        launch_us = host_us(torch, kernel, copies[0], 50)
        plain_ms = time_ms(torch, lambda *t: ssd_ref(*t, chunk=lc), copies, 3)
        if dtype == torch.float32:
            extra["intra_kernel_ms"] = time_ms(
                torch, lambda *t: ssd.ssd_intra_chunk(*t, chunk=lc), copies, 10)
        flops, nbytes = ssd_full_work(b, s, h, p, n, lc, x.element_size())
        bound_s, bound_by = bound_seconds(flops, nbytes, dname)
        tpu_flops, tpu_bytes = ssd_work(b, s, h, p, n, lc, x.element_size())
        tpu_bound_s, tpu_bound_by = bound_seconds(tpu_flops, tpu_bytes, dname)
        row = dict(kernel="ssd", model=model, dtype=dname, route=route[0],
                   shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=lc), ragged=s % lc != 0,
                   max_abs_err=y_err, tol=TOL[dname], final_state_err=final_err,
                   state_tol=STATE_TOL, **extra, ms=ms, event_ms=ev_ms,
                   plain_ms=plain_ms, plain="ssd_chunked",
                   before_ms=(SSD_BEFORE_MS[s] if dtype == torch.bfloat16
                              and model == "mamba2-2.7b" else None),
                   before_note="the previous design's ops.ssd, from SSD_BEFORE_MS: "
                               "not measured in this run",
                   library_ms=None,
                   library_note="no single PyTorch call computes the SSD",
                   bound_ms=bound_s * 1e3, bound_by=bound_by,
                   tpu_kernel_bound_ms=tpu_bound_s * 1e3, tpu_kernel_bound_by=tpu_bound_by,
                   host_us_per_launch=launch_us, gflop=flops / 1e9,
                   mbytes=nbytes / 1e6, timing=timing_since(before))
        rows[(model, s, dname)] = row
        emit("kernels", **row)
        del x, dt, a, bm, cm, args, copies
        torch.cuda.empty_cache()
    return rows


def phase_slice_ssm(torch):
    """mamba2-2.7b at full width, 2 layers, fp32: CPU (plain versions)
    against the card (the SSD kernel), the same weights and tokens; logits
    at every step and the final decode state compared."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = dataclasses.replace(get_arch("mamba2-2.7b"), num_layers=2, dtype="float32")
    b, prompt, steps = SSM_SLICE["batch"], SSM_SLICE["prompt"], SSM_SLICE["steps"]
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, prompt)))

    reset_launches()
    runs, states = {}, {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        logits, cache = prefill(tokens.to(dev))
        outs = [logits.cpu()]
        for step in range(steps):
            tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            outs.append(logits.cpu())
        runs[name] = outs
        states[name] = {k: v.cpu() for k, v in cache["mamba"].items()}
    launches = read_launches()
    errs = []
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (b, cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice_ssm: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice_ssm logits card vs cpu", out, ref, SLICE_TOL))
    state_errs = {k: check_close(f"slice_ssm final {k} card vs cpu", states["cuda"][k],
                                 states["cpu"][k], SLICE_TOL) for k in states["cpu"]}
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": 0, "fp32": cfg.num_layers}}
    if launches != expected:
        fail(f"slice_ssm: kernel launches {launches}, expected {expected}")
    emit("slice_ssm", config="mamba2-2.7b full width, 2 layers, fp32", batch=b,
         prompt=prompt, chunks=-(-prompt // cfg.ssm_chunk), decode_steps=steps,
         max_abs_err_per_step=errs, final_state_err=state_errs, tol=SLICE_TOL,
         launches=launches)
    del cpu, card
    torch.cuda.empty_cache()


def phase_train_grad(torch):
    """The flash kernel under autograd against the plain version under
    autograd; then the loss, gradients and one AdamW step of a full-width
    2-layer fp32 qwen3-0.6b on the card against the same port on the CPU."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cast_params
    from repro_torch.train.state import grad_tree, param_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    gen = torch.Generator(device="cuda").manual_seed(3)
    flash = {}
    for dname, g in GRAD.items():
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        shapes = ((g["b"], g["s"], g["h"], g["hd"]), (g["b"], g["s"], g["kh"], g["hd"]),
                  (g["b"], g["s"], g["kh"], g["hd"]))
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in shapes)
        grad_out = torch.randn(shapes[0], generator=gen, device="cuda").to(dtype)
        runs = {}
        for name, fn in (("kernel", lambda a, b_, c: ops.flash_attention(a, b_, c)),
                         ("plain", lambda a, b_, c: ops.flash_attention_plain(a, b_, c))):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            routed = dict(fa.flash_attention.routes)
            out = fn(*leaves)
            out.backward(grad_out)
            torch.cuda.synchronize()
            runs[name] = [out.detach()] + [t.grad for t in leaves]
            if name == "kernel" and fa.flash_attention.routes == routed:
                fail(f"train_grad flash {dname}: the kernel did not run")
        errs = {part: check_close(f"train_grad flash {dname} {part}", got, want, g["tol"])
                for part, got, want in zip(("out", "dq", "dk", "dv"), runs["kernel"],
                                           runs["plain"])}
        flash[dname] = dict(shape={k_: v_ for k_, v_ in g.items() if k_ != "tol"},
                            tol=g["tol"], max_abs_err=errs)
        del q, k, v, grad_out, runs

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=2, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (LOSS["batch"], LOSS["seq"] + 1)))
    hp = AdamWConfig(warmup_steps=2, total_steps=100)
    results = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        model.requires_grad_(True)
        dev = model.device
        loss, _ = model.loss({"tokens": tokens.to(dev)})
        loss.backward()
        grads = {keystr(p): t for p, t in tree_flatten_with_path(_host_tree(grad_tree(model)))}
        params = param_tree(model)
        opt = adamw_init(params)
        adamw_update(grad_tree(model), opt, torch.tensor(3, dtype=torch.int32, device=dev), hp,
                     torch.tensor(1e-3, device=dev))
        cast_params(opt["master"], params)
        after = {keystr(p): t for p, t in tree_flatten_with_path(
            _host_tree({"opt": opt, "params": params}))}
        results[name] = (loss.detach().cpu(), grads, after)
    loss_err = check_close("train_grad loss card vs cpu", results["cuda"][0],
                           results["cpu"][0], LOSS["tol"])
    grad_err = {k: check_close(f"train_grad grad {k} card vs cpu", results["cuda"][1][k], ref,
                               LOSS["tol"]) for k, ref in results["cpu"][1].items()}
    adamw_err = max(check_close(f"train_grad adamw {k} card vs cpu", results["cuda"][2][k], ref,
                                LOSS["tol"]) for k, ref in results["cpu"][2].items())
    for k, g in results["cuda"][1].items():
        if "|attn|" in k and (not torch.isfinite(g).all() or not (g != 0).any()):
            fail(f"train_grad: attention gradient {k} is not finite or is all 0")
    del cpu, card
    emit("train_grad", flash=flash, config="qwen3-0.6b full width, 2 layers, fp32",
         tokens=list(tokens.shape), loss=float(results["cuda"][0]), loss_err=loss_err,
         grad_leaves=len(grad_err), grad_max_abs_err=max(grad_err.values()),
         attn_grad_err={k: v for k, v in grad_err.items() if "|attn|" in k},
         adamw_max_abs_err=adamw_err, tol=LOSS["tol"], ssd=ssd_grads(torch),
         hybrid=hybrid_loss_grads(torch))
    del results
    torch.cuda.empty_cache()


def ssd_grads(torch) -> dict:
    """``SSD.apply`` on the card (the kernel forward, the ``ssd_chunked``
    recompute backward) against autograd through the plain ``ssd_chunked``,
    one small shape per route: y, the final state and the gradients of x,
    dt, a, B and C, with a cotangent on both outputs."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ref import ssd_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for dname, g in SSD_GRAD.items():
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        b, s, h, p, n, lc = (g[k] for k in ("b", "s", "h", "p", "n", "chunk"))
        args = (torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype),
                0.001 + 0.099 * torch.rand((b, s, h), generator=gen, device="cuda"),
                -(0.5 + 1.5 * torch.rand((h,), generator=gen, device="cuda")),
                torch.randn((b, s, n), generator=gen, device="cuda").to(dtype),
                torch.randn((b, s, n), generator=gen, device="cuda").to(dtype))
        gy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        gf = torch.randn((b, h, n, p), generator=gen, device="cuda")
        runs = {}
        for name, fn in (("kernel", lambda *t: ssd.SSD.apply(*t, lc, None)),
                         ("plain", lambda *t: ssd_ref(*t, chunk=lc))):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            routed = dict(ssd.ssd.routes)
            y, final = fn(*leaves)
            if name == "kernel" and (y.grad_fn is None or ssd.ssd.routes == routed):
                fail(f"train_grad ssd {dname}: the kernel did not run under autograd")
            torch.autograd.backward((y, final), (gy, gf))
            torch.cuda.synchronize()
            runs[name] = [y.detach(), final.detach()] + [t.grad for t in leaves]
        errs = {part: check_close(f"train_grad ssd {dname} {part}", got, want,
                                  STATE_TOL if part == "final" else g["tol"])
                for part, got, want in zip(("y", "final", "dx", "ddt", "da", "db", "dc"),
                                           runs["kernel"], runs["plain"])}
        out[dname] = dict(shape={k: v for k, v in g.items() if k != "tol"}, tol=g["tol"],
                          final_tol=STATE_TOL, max_abs_err=errs)
    return out


def hybrid_loss_grads(torch) -> dict:
    """The hybrid's loss and every gradient on the card (the fp32 flash
    kernel at head_dim 112 and the SSD's fp32 route, both under autograd)
    against the same port on the CPU from the same weights: the smoke
    zamba2-7b at head_dim 112, 2 layers, fp32."""
    import numpy as np

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("zamba2-7b")), head_dim=112,
                              num_layers=2, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (HYBRID_LOSS["batch"], HYBRID_LOSS["seq"] + 1)))
    results = {}
    reset_launches()
    for name, model in (("cpu", cpu), ("cuda", card)):
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": tokens.to(model.device)})
        loss.backward()
        results[name] = (loss.detach().cpu(), {
            keystr(p): t for p, t in tree_flatten_with_path(_host_tree(grad_tree(model)))})
    launches = read_launches()
    expected = {"flash_attention": 1, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": 0, "fp32": cfg.num_layers}}
    if launches != expected:
        fail(f"train_grad hybrid: kernel launches {launches}, expected {expected}")
    tol = HYBRID_LOSS["tol"]
    loss_err = check_close("train_grad hybrid loss card vs cpu", results["cuda"][0],
                           results["cpu"][0], tol)
    grad_err = {k: check_close(f"train_grad hybrid grad {k} card vs cpu",
                               results["cuda"][1][k], ref, tol)
                for k, ref in results["cpu"][1].items()}
    for k, g in results["cuda"][1].items():
        if k.startswith("shared_attn|attn|") and not (g != 0).any():
            fail(f"train_grad hybrid: shared attention gradient {k} is all 0")
    return dict(config="zamba2-7b smoke at head_dim 112, 2 layers, fp32",
                tokens=list(tokens.shape), loss=float(results["cuda"][0]),
                loss_err=loss_err, grad_leaves=len(grad_err),
                grad_max_abs_err=max(grad_err.values()),
                shared_attn_grad_err={k: v for k, v in grad_err.items()
                                      if k.startswith("shared_attn")},
                launches=launches, tol=tol)


def _host_tree(tree):
    """A tree of the port's tensors as CPU fp32 tensors (Stacked leaves
    stacked), for comparing two runs leaf by leaf."""
    import torch

    from repro_torch.tree import Stacked, tree_map
    return tree_map(lambda t: torch.stack([x.detach().float().cpu() for x in t.layers])
                    if isinstance(t, Stacked) else t.detach().float().cpu(), tree)


def train_bound(cfg, params: int, tokens: int, b: int, s: int):
    """The card's least time for one training step, bf16: 6 operations per
    parameter and token (forward 2, backward 4; the tied head's product
    counts once, through the embedding's parameters), and causal attention's
    products, forward (Q.K^T and P.V) and backward (4 products, twice the
    forward's operations). Recomputation in the backward is the
    implementation's, not the step's, and is not counted. Bytes (weights,
    optimizer state read and written once) bound it far less."""
    from repro_torch.roofline.hw import bound_seconds
    pairs = s * (s + 1) // 2
    attn_fwd = 4 * b * cfg.num_heads * cfg.resolved_head_dim * pairs
    flops = 6 * params * tokens + 3 * cfg.num_layers * attn_fwd
    nbytes = params * (2 + 2 + 2 + 3 * 4 * 2)     # params, grads read, params written, opt r/w
    return bound_seconds(flops, nbytes, "bfloat16"), flops, attn_fwd


def peak_rss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def host_rss_gb() -> float:
    """The process's resident host memory now (Linux)."""
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def train_through_a_failure(torch, phase: str, cfg, t: dict, ckpt_name: str) -> dict:
    """Train ``cfg`` through the port's SimCluster on the card (``t``: dp,
    global batch, sequence length, steps before and after, the failed
    worker): steps, a software failure, ``recover()`` with the stream
    policy, steps. The launch counts are zeroed just before the first step
    and read just after the last. Fails the phase unless the recovery came
    from the neighbour with no rollback, the optimizer vector after it is
    bitwise equal to a host copy taken before the failure, every step
    recorded its parts and every loss is finite."""
    import shutil

    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.cluster import ClusterConfig, SimCluster
    from repro_torch.runtime.recovery import _flatten_opt

    ckpt_dir = ROOT / "build" / ckpt_name
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    rss_start = host_rss_gb()
    t0 = time.perf_counter()
    clu = SimCluster(cfg, ClusterConfig(dp=t["dp"], global_batch=t["global_batch"],
                                        seq_len=t["seq_len"], ckpt_dir=ckpt_dir),
                     clock=time.perf_counter)
    setup_s = time.perf_counter() - t0

    # the step's parts as SimCluster.step records them (device by CUDA
    # events, host by the clock); a part missing from a step fails the phase
    span_keys = {"compute_ms", "device_ms", "flatten_ms", "shard_ms", "fabric_ms", "step_ms"}
    spans = []

    def step():
        loss = clu.step()
        sp = dict(clu.last_step_timing)
        if set(sp) != span_keys or any(v is None for v in sp.values()):
            fail(f"{phase}: step timing {sp}, expected every one of {sorted(span_keys)}")
        spans.append(dict(sp, loss=loss, host_rss_gb=host_rss_gb()))

    reset_launches()
    for _ in range(t["steps_before"]):
        step()
    before, _ = _flatten_opt(clu.state["opt"])
    clu.inject_failure([t["failed"]])
    t0 = time.perf_counter()
    rep = clu.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    after, _ = _flatten_opt(clu.state["opt"])
    bitwise = bool(np.array_equal(before, after))
    vec_len = len(after)
    del before, after
    for _ in range(t["steps_after"]):
        step()
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    steps = t["steps_before"] + t["steps_after"]
    losses = [sp["loss"] for sp in spans]
    if rep.recovered_from != "neighbor" or rep.rolled_back_iterations != 0:
        fail(f"{phase}: recovered from {rep.recovered_from} with "
             f"{rep.rolled_back_iterations} iterations rolled back")
    if not bitwise:
        fail(f"{phase}: the optimizer vector after recovery differs from the copy before "
             "the failure")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: losses {losses}")
    if clu.iteration != steps:
        fail(f"{phase}: {clu.iteration} iterations after the run, expected {steps}")
    return dict(clu=clu, ckpt_dir=ckpt_dir, spans=spans, rep=rep, recover_s=recover_s,
                bitwise=bitwise, vec_len=vec_len, launches=launches,
                flash_routes=flash_routes, steps=steps, losses=losses, setup_s=setup_s,
                rss_start=rss_start)


def train_row(torch, run: dict, t: dict, params: int, bound: tuple, flops: float) -> dict:
    """The fields a training phase prints: the step split (medians of the
    steps after the first), tokens/s beside the bound, memory and the
    recovery."""
    import numpy as np

    from repro_torch.roofline.hw import HOST_LINK_BW

    spans, rep = run["spans"], run["rep"]
    later = spans[1:]

    def median(key):
        return float(np.median([sp[key] for sp in later]))

    step_ms = median("step_ms")
    tokens = t["global_batch"] * t["seq_len"]
    return dict(params=params, dp=t["dp"], global_batch=t["global_batch"],
                seq_len=t["seq_len"], tokens_per_step=tokens, steps=run["steps"],
                losses=run["losses"], step_ms=step_ms, step_ms_first=spans[0]["step_ms"],
                device_ms=median("device_ms"), step_call_ms=median("compute_ms"),
                host_ckpt_ms=float(np.median([sp["step_ms"] - sp["compute_ms"]
                                              for sp in later])),
                flatten_d2h_ms=median("flatten_ms"),
                flatten_d2h_bound_ms=run["vec_len"] * 4 / HOST_LINK_BW * 1e3,
                shard_chunk_crc_ms=median("shard_ms"), fabric_run_ms=median("fabric_ms"),
                tokens_per_s=tokens / (step_ms / 1e3),
                bound_ms=bound[0] * 1e3, bound_by=bound[1], bound_tflop=flops / 1e12,
                opt_vector_gb=run["vec_len"] * 4 / 1e9,
                peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                host_rss_at_start_gb=run["rss_start"],
                host_rss_max_gb=max(sp["host_rss_gb"] for sp in spans),
                process_peak_rss_gb=peak_rss_gb(),
                host_rss_note="host_rss_max_gb: the largest RSS read after a step; "
                              "process_peak_rss_gb includes earlier phases",
                setup_s=run["setup_s"], recovered_from=rep.recovered_from,
                rolled_back=rep.rolled_back_iterations,
                opt_vector_bitwise_equal=run["bitwise"], recover_wall_s=run["recover_s"],
                recover_simulated_s=rep.total_time,
                recover_simulated_timeline=rep.timeline,
                recover_note="recover_simulated_s is simulated fabric time, not measured",
                state_bytes_streamed=rep.state_bytes_streamed, chunks=rep.chunks_total,
                launches=run["launches"], flash_routes=run["flash_routes"], spans=spans)


def close_cluster(torch, run: dict) -> float:
    """Close the cluster's engines, free it and hand the freed host heap
    back to the OS; returns the host RSS after."""
    import ctypes
    import gc
    import shutil

    clu = run.pop("clu")
    for w in clu.workers:
        w.engine.close()
    del clu
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    shutil.rmtree(run["ckpt_dir"], ignore_errors=True)
    torch.cuda.empty_cache()
    return host_rss_gb()


def phase_train(torch):
    """Full qwen3-0.6b trained through the port's SimCluster with a
    failure and a stream recovery in the middle."""
    from repro_torch.configs import get_arch
    from repro_torch.models import param_count

    t = TRAIN
    cfg = get_arch("qwen3-0.6b")
    run = train_through_a_failure(torch, "train", cfg, t, "chip_smoke_ckpt")
    steps = run["steps"]
    expected = {"flash_attention": cfg.num_layers * steps, "decode_attention": 0, "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if (run["launches"] != expected
            or run["flash_routes"].get("wgmma") != cfg.num_layers * steps):
        fail(f"train: kernel launches {run['launches']}, flash routes {run['flash_routes']}, "
             f"expected {expected} all on wgmma")

    # where the device step's time goes: one more step under torch.profiler,
    # after the measured run (the first profiler session of the script)
    clu = run["clu"]
    batch = clu._assemble_batch()
    trace = device_share(torch, lambda: clu._step(clu.state, batch), top=12,
                         classify=train_kernel_group)
    del clu, batch
    params = param_count(cfg)
    bound, flops, attn_fwd = train_bound(cfg, params, t["global_batch"] * t["seq_len"],
                                         t["global_batch"], t["seq_len"])
    row = dict(config=f"qwen3-0.6b full ({cfg.num_layers} layers, bf16, tied head)",
               **train_row(torch, run, t, params, bound, flops),
               attention_fwd_gflop_per_layer=attn_fwd / 1e9, device_step_trace=trace)
    row["host_rss_after_free_gb"] = close_cluster(torch, run)
    emit("train", **row)
    return row


# the full-width replay of the fleet's baseline scenario: its events (a
# software failure of worker 1 before step 5, 10 steps) on full qwen3-0.6b,
# dp=4 simulated workers, 8 x 1024 tokens a step
REPLAY = dict(scenario="clean_software_failure", global_batch=8, seq_len=1024)
# a verdict field that may differ from the reference-scale pin at full width,
# and why: the shard's size, or the simulated fabric time it takes
SCALE_FIELDS = {"state_bytes_streamed": "bytes", "chunks_reused": "bytes",
                "chunks_rebalanced": "bytes", "rebalances": "bytes",
                "exposed_seconds": "sim time", "recovery_total_s": "sim time",
                "stream_seconds": "sim time"}


# the sharded multi-rank step (train.step.build_train_step), four gloo ranks
# sharing the one card: (a) full qwen3-0.6b, bf16, FSDP and the instant
# backup, 8 x 1024 tokens a step (2 x 1024 a rank), 3 steps, then the
# neighbour drill, the first batch scored again and one step without FSDP for
# its memory; (b) full width cut to 2 layers, fp32, 2 steps, against one rank
# of the same step over NCCL from the same weights and batches. The children
# are spawned (CUDA cannot fork) and meet through file:// in a temporary
# directory.
TRAIN_MESH = dict(arch="qwen3-0.6b", smoke=False, layers=None, dtype="bfloat16", world=4,
                  global_batch=8, seq_len=1024, steps=3, seed=0, timeout_s=600)
TRAIN_MESH_B = dict(arch="qwen3-0.6b", smoke=False, layers=2, dtype="float32", world=4,
                    global_batch=8, seq_len=1024, steps=2, seed=0, timeout_s=300, tol=1e-5,
                    grad_tol=2e-4)
MESH_NOTE = ("gloo through the host on one shared card: the four ranks share one H100 and "
             "every collective crosses the host; not the figure of a ring on NVLink")


def run_children(name: str, jobs: list, timeout_s: float) -> None:
    """Start ``jobs`` ((function, args) each) as spawned processes and wait
    for all of them; a child that exits non-zero, or any still running at
    the deadline, kills the others and fails the phase."""
    import multiprocessing
    from multiprocessing.connection import wait

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args) for fn, args in jobs]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                fail(f"{name}: ranks still running after {timeout_s} s")
            wait([p.sentinel for p in procs if p.exitcode is None], timeout=min(left, 5.0))
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad:
                fail(f"{name}: a rank exited with {bad[0]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)


def _mesh_cfg(t: dict):
    from repro_torch.configs import get_arch, reduce_for_smoke
    cfg = get_arch(t["arch"])
    cfg = reduce_for_smoke(cfg) if t["smoke"] else cfg
    return dataclasses.replace(cfg, num_layers=t["layers"] or cfg.num_layers,
                               dtype=t["dtype"])


def _mesh_setup(rank: int, world: int, t: dict, rdv: str, backend: str, device: str):
    """One rank's process group and mesh, the step with and without FSDP,
    a maker of the sharded initial state (weights from a host generator
    seeded with t["seed"], as SimCluster draws them) and this rank's rows of
    t["steps"] global batches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.state import param_tree, shard_init_state
    from repro_torch.train.step import build_train_step

    torch.set_num_threads(2)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    cfg = _mesh_cfg(t)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(t["seed"]))
    mesh = make_host_mesh(data=world, model=1)
    shape = ShapeConfig("train_mesh", t["seq_len"], t["global_batch"], "train")
    hp = AdamWConfig(warmup_steps=2, total_steps=100)          # SimCluster's
    arts = {fsdp: build_train_step(model, mesh, hp, fsdp_params=fsdp, shape=shape,
                                   clock=time.perf_counter) for fsdp in (True, False)}
    rng = np.random.default_rng(t["seed"])
    spec = arts[True].input_pspecs["tokens"]
    local = [shd.local_block(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (t["global_batch"], t["seq_len"] + 1), dtype=np.int32)),
        spec, mesh).contiguous().to(device) for _ in range(t["steps"])]

    def make_state(fsdp: bool):
        return shard_init_state(param_tree(model), arts[fsdp].plan, mesh, device=device)

    return cfg, mesh, arts, make_state, local


def _digests(torch, tree, piece: int = 1 << 26) -> list:
    """sha256 of the bytes of every present leaf of ``tree``, in order,
    copied to the host ``piece`` bytes at a time."""
    import hashlib

    from repro_torch.tree import tree_flatten
    out = []
    for x in tree_flatten(tree, lambda v: v is None)[0]:
        if x is None:
            continue
        h = hashlib.sha256()
        for part in x.detach().contiguous().reshape(-1).view(torch.uint8).split(piece):
            h.update(part.cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _same(torch, a, b) -> bool:
    """Two trees bit for bit (None leaves where both have them)."""
    from repro_torch.tree import tree_flatten
    la, lb = (tree_flatten(x, lambda v: v is None)[0] for x in (a, b))
    return len(la) == len(lb) and all(
        x is None and y is None or x is not None and y is not None and torch.equal(x, y)
        for x, y in zip(la, lb))


def _timing_ms(art) -> dict:
    """The last step's parts (the caller times the whole step itself)."""
    return {f"{k}_ms": v * 1e3 for k, v in art.step_fn.last_timing.items() if k != "step"}


def mesh_rank_a(rank: int, world: int, tmp: str, t: dict, device: str) -> None:
    """Part (a) on one rank; its record goes to tmp/a_<rank>.json."""
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch.core.instant import neighbor_backup
    from repro_torch.core.razor import razor_bytes_formula
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import param_count
    from repro_torch.parallel.sharding import is_spec
    from repro_torch.tree import tree_flatten, tree_map

    cfg, mesh, arts, make_state, local = _mesh_setup(rank, world, t, f"{tmp}/rdv_a",
                                                     "gloo", device)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clone = lambda tree: tree_map(lambda x: x.clone(), tree, is_leaf=lambda v: v is None)
    art = arts[True]
    state = make_state(True)
    sync()
    rss = {"setup": host_rss_gb()}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    records, backup, before_last = [], None, None
    reset_launches()
    for i, tokens in enumerate(local):
        if i == len(local) - 1:       # for the drill: the state after step i and its backup
            before_last = (clone(state), backup)
        t0 = time.perf_counter()
        state, metrics, backup = art.step_fn(state, {"tokens": tokens})
        sync()
        records.append(dict(step=i + 1, step_ms=(time.perf_counter() - t0) * 1e3,
                            loss=float(metrics["loss"]), lr=float(metrics["lr"]),
                            **_timing_ms(art)))
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    peak_fsdp = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    rss["steps"] = host_rss_gb()

    # (i) this rank's backup is its predecessor's new optimizer blocks, bit for bit
    unique = tree_map(lambda ps, x: None if ps is None else x, art.backup_pspecs,
                      state["opt"], is_leaf=is_spec)
    every = [None] * world
    dist.all_gather_object(every, (_digests(torch, unique), _digests(torch, backup)))
    pred = (mesh.index("data") - 1) % world
    backup_bitwise = bool(every[rank][1]) and every[rank][1] == every[pred][0]
    # (ii) the bytes the ring sent
    sent = sum(x.numel() * x.element_size()
               for x in tree_flatten(backup, lambda v: v is None)[0] if x is not None)
    # (iii) the neighbour drill: rank 1 loses its optimizer blocks after step
    # n-1 and rebuilds them from rank 2's backup, sent back one hop; its FSDP
    # param blocks are cast from the rebuilt master (a replicated param, the
    # embedding, would come from any data peer). Step n from there must equal
    # the uninterrupted step n on every rank, bit for bit.
    restored, kept = before_last
    returned = neighbor_backup(kept, art.backup_pspecs, mesh, shift=-1)
    if mesh.index("data") == 1:
        for dst, src in zip(tree_flatten(restored["opt"])[0],
                            tree_flatten(returned, lambda v: v is None)[0]):
            if src is not None:
                dst.zero_()
                dst.copy_(src)
        for p, m in zip(tree_flatten(restored["params"])[0],
                        tree_flatten(restored["opt"]["master"])[0]):
            if p.shape == m.shape:
                p.zero_()
                p.copy_(m)
    del returned, kept, before_last
    drill_state, _, drill_backup = art.step_fn(restored, {"tokens": local[-1]})
    drill_bitwise = _same(torch, drill_state, state) and _same(torch, drill_backup, backup)
    del drill_state, drill_backup, restored, unique
    rss["drill"] = host_rss_gb()
    # (v) the first batch scored again: the loss a step on a copy reports
    _, again, _ = art.step_fn(clone(state), {"tokens": local[0]})
    first_batch_loss_after = float(again["loss"])
    del state, backup
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # fsdp_params=False once, for its device memory and step time
    plain = arts[False]
    state = make_state(False)
    t0 = time.perf_counter()
    state, metrics, _ = plain.step_fn(state, {"tokens": local[0]})
    sync()
    no_fsdp = dict(step_ms=(time.perf_counter() - t0) * 1e3, loss=float(metrics["loss"]),
                   peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                   **_timing_ms(plain))
    rss["no_fsdp"] = host_rss_gb()
    rec = dict(rank=rank, records=records, launches=launches, flash_routes=flash_routes,
               peak_device_mem_gb=peak_fsdp, backup_bitwise=backup_bitwise,
               ring_bytes_sent=sent, razor_bytes=art.razor.unique_bytes_per_device_ring,
               formula_bytes=razor_bytes_formula(param_count(cfg), world),
               drill_bitwise=drill_bitwise, first_batch_loss_after=first_batch_loss_after,
               no_fsdp=no_fsdp, host_rss_gb=rss,
               peak_host_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)
    with open(f"{tmp}/a_{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def mesh_rank_b(rank: int, world: int, tmp: str, t: dict, device: str, backend: str) -> None:
    """Part (b) on one rank of ``world``: t["steps"] FSDP steps. One rank
    alone saves its loss, master, m and v after each step to
    tmp/b1_step<i>.pt; rank 0 of the sharded run compares its joined ones
    with them and writes the errors (relative to each leaf's largest
    magnitude) to tmp/b.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.sharding import join_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    _, mesh, arts, make_state, local = _mesh_setup(rank, world, t, f"{tmp}/rdv_b{world}",
                                                   backend, device)
    art = arts[True]
    state, out = make_state(True), []
    for i, tokens in enumerate(local):
        state, metrics, _ = art.step_fn(state, {"tokens": tokens})
        opt = join_tree(state["opt"], art.plan.opt_pspecs, mesh)
        if rank:
            continue
        flat = {f"{k}|{keystr(p)}": x for k in ("master", "m", "v")
                for p, x in tree_flatten_with_path(opt[k])}
        if world == 1:
            torch.save({"loss": float(metrics["loss"]),
                        "opt": {k: x.cpu() for k, x in flat.items()}}, f"{tmp}/b1_step{i}.pt")
            continue
        ref = torch.load(f"{tmp}/b1_step{i}.pt")
        err, lr = {}, float(metrics["lr"])
        for k, x in flat.items():
            r = ref["opt"][k].to(x.device)
            err[k] = float((x - r).abs().max() / r.abs().max().clamp_min(1e-30))
        master_dmax = max(float((x - ref["opt"][k].to(x.device)).abs().max())
                          for k, x in flat.items() if k.startswith("master|"))
        out.append(dict(step=i + 1, loss=float(metrics["loss"]), single_loss=ref["loss"],
                        lr=lr, err=err, master_max_abs_diff=master_dmax))
        del ref
    if rank == 0 and world > 1:
        with open(f"{tmp}/b.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def phase_train_mesh(torch, t: dict = TRAIN_MESH, tb: dict = TRAIN_MESH_B,
                     device: str = "cuda", backend_b: str = "nccl") -> dict:
    """The sharded multi-rank train step (parts (a) and (b) above)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    parent_rss = host_rss_gb()
    try:
        t0 = time.perf_counter()
        run_children("train_mesh (a)", [(mesh_rank_a, (r, t["world"], tmp, t, device))
                                        for r in range(t["world"])], t["timeout_s"])
        recs = []
        for r in range(t["world"]):
            with open(f"{tmp}/a_{r}.json") as f:
                recs.append(json.load(f))
        a_s = time.perf_counter() - t0
        row_a = dict(_train_mesh_row(recs, t, a_s, device), parent_host_rss_gb=parent_rss)
        emit("train_mesh", **row_a)
        t0 = time.perf_counter()
        run_children("train_mesh (b), one rank", [(mesh_rank_b, (0, 1, tmp, tb, device,
                                                                  backend_b))],
                     tb["timeout_s"])
        run_children("train_mesh (b), sharded",
                     [(mesh_rank_b, (r, tb["world"], tmp, tb, device, "gloo"))
                      for r in range(tb["world"])], tb["timeout_s"])
        with open(f"{tmp}/b.json") as f:
            steps_b = json.load(f)
        b_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b): the losses of every step and the master of the first (lr 0 under
    # the warmup) within tb["tol"] of one NCCL rank, and m (0.1 of the
    # gradient at step 1) within tb["grad_tol"], the training slice's fp32
    # gradient tolerance (over 8,192 tokens the two reduction orders differed
    # by up to 8.8e-6 of a leaf's largest gradient on an H100). v holds the same
    # gradients squared and is reported. The later master is reported:
    # AdamW moves every element by O(lr) whatever its gradient's size, so an
    # element whose gradient is below the noise of the two reduction orders
    # moves by a different O(lr).
    tol, grad_tol = tb["tol"], tb["grad_tol"]
    bad = []
    for st in steps_b:
        if abs(st["loss"] - st["single_loss"]) > tol * abs(st["single_loss"]):
            bad.append(f"step {st['step']} loss {st['loss']} vs {st['single_loss']}")
        for k, e in st["err"].items():
            limit = (grad_tol if k.startswith("m|") else
                     tol if k.startswith("master|") and st["step"] == 1 else None)
            if limit is not None and e > limit:
                bad.append(f"step {st['step']} {k}: {e} (limit {limit})")
    if bad:
        fail(f"train_mesh (b): sharded against one {backend_b} rank: " + "; ".join(bad))
    row_b = dict(config=f"{_mesh_cfg(tb).name}, {tb['layers']} layers, fp32",
                 sharded=f"{tb['world']} gloo ranks", against=f"one rank over {backend_b}",
                 tol=tol, grad_tol=grad_tol, seconds=b_s,
                 steps=[dict(step=st["step"], lr=st["lr"], loss=st["loss"],
                             single_loss=st["single_loss"],
                             loss_rel_err=abs(st["loss"] - st["single_loss"])
                             / abs(st["single_loss"]),
                             **{f"{part}_rel_err_max": max(e for k, e in st["err"].items()
                                                           if k.startswith(part + "|"))
                                for part in ("master", "m", "v")},
                             master_max_abs_diff_over_lr=(st["master_max_abs_diff"] / st["lr"]
                                                          if st["lr"] else 0.0))
                        for st in steps_b],
                 note="held: losses and the master of step 1 (lr 0) within tol; m (0.1 "
                      "of the gradient) of every step within grad_tol, the fp32 gradient "
                      "tolerance of the training slice; v (the gradients squared) and the "
                      "later master are reported")
    emit("train_mesh_world1", **row_b)
    return row_a


def _train_mesh_row(recs: list, t: dict, a_s: float, device: str) -> dict:
    """Part (a)'s checks (each failing the run) and its printed fields."""
    import numpy as np

    cfg = _mesh_cfg(t)
    steps = t["steps"]
    losses = [r["loss"] for r in recs[0]["records"]]
    flash = [r["launches"]["flash_attention"] for r in recs]
    if device == "cuda" and (
            min(flash) <= 0
            or any(r["launches"]["decode_attention"] or r["launches"]["ssd"] for r in recs)
            or any(v for r in recs for k, v in r["flash_routes"].items() if k != "wgmma")):
        fail(f"train_mesh: kernel launches {[r['launches'] for r in recs]}, flash routes "
             f"{[r['flash_routes'] for r in recs]}; expected flash launches in every rank, "
             "all on wgmma, and no decode or SSD launch")
    if not all(math.isfinite(x) for r in recs for x in (s["loss"] for s in r["records"])):
        fail(f"train_mesh: losses {[[s['loss'] for s in r['records']] for r in recs]}")
    if not all(r["backup_bitwise"] for r in recs):
        fail("train_mesh: a rank's backup differs from its predecessor's new optimizer blocks")
    if not all(r["ring_bytes_sent"] == r["razor_bytes"] for r in recs):
        fail(f"train_mesh: ring bytes {[r['ring_bytes_sent'] for r in recs]} against the "
             f"razor's {recs[0]['razor_bytes']}")
    if not all(r["drill_bitwise"] for r in recs):
        fail("train_mesh: the step after rebuilding rank 1 from its neighbour's backup "
             "differs from the uninterrupted step")
    if not recs[0]["first_batch_loss_after"] < losses[0]:
        fail(f"train_mesh: the first batch's loss {losses[0]} before the run, "
             f"{recs[0]['first_batch_loss_after']} after it; expected it to fall")

    def per_step(key):
        return [float(np.median([r["records"][i].get(key, 0.0) for r in recs]))
                for i in range(steps)]

    median_ms = float(np.median([s["step_ms"] for r in recs for s in r["records"][1:]]))

    row = dict(config=f"{cfg.name}, {cfg.num_layers} layers, {cfg.dtype}", world=t["world"],
               mesh="data=4, model=1", backend="gloo", device_note=MESH_NOTE,
               fsdp_params=True, instant_ckpt=True, global_batch=t["global_batch"],
               seq_len=t["seq_len"], tokens_per_rank=t["global_batch"] // t["world"]
               * t["seq_len"], steps=steps, losses=losses,
               step_ms=per_step("step_ms"), grad_reduce_ms=per_step("grad_reduce_ms"),
               param_gather_ms=per_step("param_gather_ms"),
               neighbor_backup_ms=per_step("backup_ms"),
               median_step_ms=median_ms,
               tokens_per_s=t["global_batch"] * t["seq_len"] / (median_ms / 1e3),
               peak_device_mem_gb=[r["peak_device_mem_gb"] for r in recs],
               no_fsdp=[r["no_fsdp"] for r in recs],
               peak_host_rss_gb=[r["peak_host_rss_gb"] for r in recs],
               host_rss_gb_rank0=recs[0]["host_rss_gb"],
               host_rss_note="host_rss_gb_rank0: rank 0's resident host memory after its "
                             "setup, 3 steps, the drill and the step without FSDP",
               flash_launches=flash, flash_expected=2 * cfg.num_layers * steps,
               flash_note="per rank: the forward and its recompute in the backward (FSDP "
                          "recomputes each layer body, its gather included)",
               backup_bitwise=True, ring_bytes_sent=recs[0]["ring_bytes_sent"],
               razor_unique_bytes_per_device_ring=recs[0]["razor_bytes"],
               formula_12phi_over_dp=recs[0]["formula_bytes"],
               drill_bitwise=True, first_batch_loss_after=recs[0]["first_batch_loss_after"],
               seconds=a_s)
    return row


def phase_scenarios(torch):
    """The adversarial scenario fleet of the port: the whole corpus at the
    reference's scale on the card and on the CPU (verdicts equal), then one
    scenario's events replayed at full qwen3-0.6b width on the card."""
    import ctypes
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.fcr import fcr, is_free
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline.hw import PEAK_FLOPS
    from repro_torch.runtime.cluster import SimCluster
    from repro_torch.runtime.scenarios import _cluster_kwargs, _Runner, build_cluster, corpus

    # ---- 1. the corpus at the reference's scale: card, then CPU ---- #
    # each scenario as run_scenario replays it, keeping the cluster so that
    # its losses, which the card computes, are held to the CPU's as well
    def replay(sc, root, device):
        clu = build_cluster(sc, root / sc.name, device=device)
        verdict = _Runner(sc, clu).run()
        losses = torch.tensor(clu.loss_history, dtype=torch.float64)
        for w in clu.workers:
            w.engine.close()
        return verdict, losses

    scs = corpus()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scenarios_"))
    card, cpu, secs = {}, {}, {}
    reset_launches()
    for sc in scs:
        t0 = time.perf_counter()
        card[sc.name] = replay(sc, tmp / "cuda", "cuda")
        secs[sc.name] = [time.perf_counter() - t0]
    launches = read_launches()
    routes = dict(fa.flash_attention.routes)
    for sc in scs:
        t0 = time.perf_counter()
        cpu[sc.name] = replay(sc, tmp / "cpu", "cpu")
        secs[sc.name].append(time.perf_counter() - t0)
    shutil.rmtree(tmp, ignore_errors=True)
    loss_err = {}
    for sc in scs:
        (v, losses), (v_cpu, losses_cpu) = card[sc.name], cpu[sc.name]
        if len(losses) != len(losses_cpu) or not torch.isfinite(losses).all():
            fail(f"scenarios: {sc.name} losses on the card {losses.tolist()}, "
                 f"on the CPU {losses_cpu.tolist()}")
        loss_err[sc.name] = check_close(f"scenarios: {sc.name} losses card vs cpu", losses,
                                        losses_cpu, SLICE_TOL)
        emit("scenario", name=sc.name, dp=sc.dp, steps=sc.steps, card_s=secs[sc.name][0],
             cpu_s=secs[sc.name][1], recoveries=v.recoveries, rollbacks=v.rollbacks,
             detection_latency_s=v.detection_latency_s,
             equal_to_cpu=v.pinned() == v_cpu.pinned(), losses=len(losses),
             loss_max_abs_err=loss_err[sc.name], loss_tol=SLICE_TOL)
    differ = [n for n in card if card[n][0].pinned() != cpu[n][0].pinned()]
    if differ:
        fail(f"scenarios: verdicts on the card differ from the CPU's for {differ}")
    if (launches["flash_attention"] == 0 or routes.get("fp32") != launches["flash_attention"]
            or launches["decode_attention"] or launches["ssd"]):
        fail(f"scenarios: corpus kernel launches {launches}, flash routes {routes}, "
             "expected flash launches all on fp32 and no decode or SSD launch")
    corpus_row = dict(scenarios=len(scs), card_s=sum(x[0] for x in secs.values()),
                      cpu_s=sum(x[1] for x in secs.values()), launches=launches,
                      flash_routes=routes, verdicts_equal=True,
                      loss_max_abs_err=max(loss_err.values()), loss_tol=SLICE_TOL)

    # ---- 2. one scenario's events at full width ---- #
    sc = next(s for s in scs if s.name == REPLAY["scenario"])
    cfg = get_arch("qwen3-0.6b")
    ckpt_dir = ROOT / "build" / "chip_smoke_replay_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # wired as build_cluster wires a scenario's cluster, at full width
    clu = SimCluster(cfg, device="cuda", clock=time.perf_counter,
                     **_cluster_kwargs(sc, ckpt_dir, global_batch=REPLAY["global_batch"],
                                       seq_len=REPLAY["seq_len"]))
    setup_s = time.perf_counter() - t0
    span_keys = {"compute_ms", "device_ms", "flatten_ms", "shard_ms", "fabric_ms", "step_ms"}
    spans, reports = [], []

    def step():
        loss = SimCluster.step(clu)
        sp = dict(clu.last_step_timing)
        if set(sp) != span_keys or any(v is None for v in sp.values()):
            fail(f"scenarios: step timing {sp}, expected every one of {sorted(span_keys)}")
        spans.append(dict(sp, loss=loss, host_rss_gb=host_rss_gb()))
        return loss

    def recover(*args, **kw):
        t0 = time.perf_counter()
        rep = SimCluster.recover(clu, *args, **kw)
        torch.cuda.synchronize()
        reports.append((rep, time.perf_counter() - t0, len(spans)))
        return rep

    clu.step, clu.recover = step, recover        # the runner calls these
    reset_launches()
    t0 = time.perf_counter()
    verdict = _Runner(sc, clu).run()
    replay_s = time.perf_counter() - t0
    launches = read_launches()
    routes = dict(fa.flash_attention.routes)
    losses = [sp["loss"] for sp in spans]
    rel = sc.reliability
    analytic = rel.heartbeat_period + rel.scan_period + rel.notify_latency
    if (verdict.steps_completed != sc.steps or verdict.recoveries != 1
            or verdict.rollbacks != 0 or verdict.detections != 1 or len(reports) != 1
            or reports[0][0].recovered_from != "neighbor"):
        fail(f"scenarios: full-width verdict {verdict.pinned()}, reports "
             f"{[r[0].recovered_from for r in reports]}; expected {sc.steps} steps, one "
             "recovery from the neighbour, 0 rollbacks and 1 detection")
    if (verdict.detection_latency_s is None
            or abs(verdict.detection_latency_s - analytic) > rel.heartbeat_period + 1e-9):
        fail(f"scenarios: detection latency {verdict.detection_latency_s} s, analytic "
             f"{analytic} s, allowed one heartbeat ({rel.heartbeat_period} s)")
    if len(losses) != sc.steps or not all(math.isfinite(x) for x in losses):
        fail(f"scenarios: full-width losses {losses}")
    expected = {"flash_attention": cfg.num_layers * sc.steps, "decode_attention": 0,
                "ssd": 0, "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected or routes.get("wgmma") != cfg.num_layers * sc.steps:
        fail(f"scenarios: full-width kernel launches {launches}, flash routes {routes}, "
             f"expected {expected} all on wgmma")

    pin = card[sc.name][0].pinned()
    got = verdict.pinned()
    differs = {k: dict(full_width=got[k], reference_scale=pin[k], why=SCALE_FIELDS[k])
               for k in got if k in SCALE_FIELDS and got[k] != pin[k]}
    unexplained = [k for k in got if k not in SCALE_FIELDS and got[k] != pin[k]]
    if unexplained:
        fail(f"scenarios: full-width verdict differs from the pin in {unexplained}")
    later = spans[1:]

    def median(key):
        return float(np.median([sp[key] for sp in later]))

    step_ms = median("step_ms")
    tokens = REPLAY["global_batch"] * REPLAY["seq_len"]
    host_share = float(np.median([(sp["step_ms"] - sp["compute_ms"]) / sp["step_ms"]
                                  for sp in later]))
    b_worker = REPLAY["global_batch"] / sc.dp
    fcr_value = fcr(REPLAY["seq_len"], b_worker, sc.link_bw, PEAK_FLOPS["bfloat16"])
    rep, recover_s, recovered_after = reports[0]

    # the steps before the recovery and after it: the spilled checkpoint
    # chunks pile up on the host until the recovery resets the streams
    def regime(part):
        return dict(steps=len(part), step_ms=[sp["step_ms"] for sp in part],
                    step_ms_median=float(np.median([sp["step_ms"] for sp in part])),
                    host_rss_gb=[sp["host_rss_gb"] for sp in part])
    row = dict(corpus=corpus_row,
               replay=dict(scenario=sc.name, events=[[e.at_step, e.action, e.kwargs()]
                                                     for e in sc.events],
                           config=f"qwen3-0.6b full ({cfg.num_layers} layers, bf16)",
                           dp=sc.dp, global_batch=REPLAY["global_batch"],
                           seq_len=REPLAY["seq_len"], link_bw=sc.link_bw, dcn_bw=sc.dcn_bw,
                           verdict=got, differs_from_pin=differs,
                           detection_latency_s=verdict.detection_latency_s,
                           detection_analytic_s=analytic,
                           losses=losses, step_ms=step_ms, step_ms_first=spans[0]["step_ms"],
                           tokens_per_s=tokens / (step_ms / 1e3),
                           window_ms_per_step=replay_s * 1e3 / sc.steps,
                           tokens_per_s_window=tokens * sc.steps / replay_s,
                           regimes=dict(before_recovery=regime(later[:recovered_after - 1]),
                                        after_recovery=regime(spans[recovered_after:])),
                           split_ms=dict(device=median("device_ms"),
                                         step_call=median("compute_ms"),
                                         flatten=median("flatten_ms"),
                                         shard_chunk_crc=median("shard_ms"),
                                         fabric=median("fabric_ms")),
                           host_ckpt_share=host_share,
                           recover_wall_s=recover_s, recover_simulated_s=rep.total_time,
                           recovered_from=rep.recovered_from,
                           exposed_seconds_simulated=verdict.exposed_seconds,
                           note="recover_simulated_s, exposed_seconds_simulated and the "
                                "verdict's times are simulated fabric time, not measured",
                           peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                           peak_host_rss_gb=peak_rss_gb(), setup_s=setup_s,
                           replay_s=replay_s, launches=launches, flash_routes=routes,
                           fcr=dict(s=REPLAY["seq_len"], b=b_worker, v=sc.link_bw,
                                    c=PEAK_FLOPS["bfloat16"], value=fcr_value,
                                    free=is_free(REPLAY["seq_len"], b_worker, sc.link_bw,
                                                 PEAK_FLOPS["bfloat16"]),
                                    measured_host_ckpt_share=host_share),
                           spans=spans))
    for w in clu.workers:
        w.engine.close()
    del clu, w, step, recover, reports, rep
    gc.collect()
    # hand the freed host heap back to the OS before train builds its
    # cluster: the replay's backlog of exposed checkpoint chunks leaves
    # tens of GB of freed but resident heap behind
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    row["replay"]["host_rss_after_free_gb"] = host_rss_gb()
    emit("scenarios", **row)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def ssm_serve_bounds(cfg, params: int, b: int, prompt: int):
    """The card's least time for the mamba2 serve run's prefill and for one
    decode step, bf16: weight bytes read once; the decode state (SSD state
    fp32, conv windows bf16) written once by prefill, read and written once
    by a decode step; the matrix products' and the SSD's operations."""
    from repro_torch.roofline.hw import bound_seconds
    L, h, n, p = cfg.num_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # the embedding, also the head
    n_body = params - n_head
    weight_bytes = 2 * params
    state_bytes = L * b * (h * n * p * 4 + (cfg.ssm_conv_kernel - 1)
                           * (cfg.ssm_inner + 2 * n) * 2)
    ssd_flops, _ = ssd_full_work(b, prompt, h, p, n, min(cfg.ssm_chunk, prompt), 2)
    prefill_flops = 2 * n_body * b * prompt + 2 * n_head * b + L * ssd_flops
    prefill = bound_seconds(prefill_flops, weight_bytes + state_bytes, "bfloat16")
    decode_flops = 2 * params * b + L * b * h * n * p * 4
    decode = bound_seconds(decode_flops, weight_bytes + 2 * state_bytes, "bfloat16")
    return prefill, decode


def phase_serve_ssm(torch):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("mamba2-2.7b")
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": cfg.num_layers,
                "ssd_routes": {"wgmma": cfg.num_layers, "fp32": 0}}
    if launches != expected:
        fail(f"serve_ssm: kernel launches {launches}, expected {expected}")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_ssm: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_ssm: generated tokens out of range")
    params = param_count(cfg)
    prefill_bound, decode_bound = ssm_serve_bounds(cfg, params, b, prompt)
    row = dict(config="mamba2-2.7b full (64 layers, bf16)", params=params,
               batch=b, prompt=prompt, gen=gen, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               first_sequence=seqs[0].tolist())
    emit("serve_ssm", **row)
    return model, prefill, decode, tokens, row


def hybrid_serve_bounds(cfg, params: int, shared: int, b: int, prompt: int, gen: int):
    """The card's least time for the hybrid serve run's prefill and for its
    mean decode step, bf16. Operations: the matrix products of every
    parameter but the embedding once a token, with the shared block's
    counted once per application, the head's for the last position only,
    the causal attention of each application and each layer's SSD (the
    prefill; a decode step's state update and read-out). Bytes: the weights
    read once, the shared block once more per further application (a decode
    step), the KV cache written (prefill) or read up to the attended length
    (decode), the SSD state fp32 and the conv windows bf16 written (prefill)
    or read and written (decode)."""
    from repro_torch.roofline.hw import bound_seconds
    L, h, n, p = cfg.num_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    n_attn = sum(k == "mamba_attn" for k in cfg.layer_kinds())
    kh, hq, hd = cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    n_head = cfg.padded_vocab * cfg.d_model          # the embedding, also the head
    n_eff = params - n_head + (n_attn - 1) * shared   # matmul parameters a token
    weight_bytes = 2 * params
    state_bytes = L * b * (h * n * p * 4 + (cfg.ssm_conv_kernel - 1)
                           * (cfg.ssm_inner + 2 * n) * 2)
    kv_bytes_per_pos = 2 * n_attn * b * kh * hd * 2
    ssd_flops, _ = ssd_full_work(b, prompt, h, p, n, min(cfg.ssm_chunk, prompt), 2)
    prefill_flops = (2 * n_eff * b * prompt + 2 * n_head * b + L * ssd_flops
                     + n_attn * 4 * b * hq * hd * prompt * (prompt + 1) // 2)
    prefill = bound_seconds(prefill_flops, weight_bytes + kv_bytes_per_pos * prompt
                            + state_bytes, "bfloat16")
    lens = range(prompt + 1, prompt + gen)             # attended lengths per step
    steps = gen - 1
    decode_flops = (2 * (n_eff + n_head) * b + L * b * h * n * p * 4
                    + n_attn * 4 * b * hq * hd * sum(lens) / steps)
    decode_bytes = (weight_bytes + 2 * (n_attn - 1) * shared + 2 * state_bytes
                    + kv_bytes_per_pos * sum(lens) / steps)
    return (prefill, prefill_flops, weight_bytes + kv_bytes_per_pos * prompt + state_bytes,
            bound_seconds(decode_flops, decode_bytes, "bfloat16"), decode_bytes)


def phase_serve_hybrid(torch):
    """Full zamba2-7b (81 Mamba2 layers, the shared attention block after 13
    of them, bf16), random weights drawn on the card from a seed: the same 8
    x 1000 prompts and 32 greedy tokens. 13 flash launches on wgmma at head
    dim 112, 13 x 31 decode launches, 81 SSD launches on wgmma."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("zamba2-7b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    t0 = time.perf_counter()
    # drawn by a CUDA generator on the card: 6.6 B numbers drawn on the host
    # would cost minutes of host time and a 26 GB fp32 copy
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    n_attn = len(model.attn_layers)
    expected = {"flash_attention": n_attn, "decode_attention": n_attn * (gen - 1),
                "ssd": cfg.num_layers, "ssd_routes": {"wgmma": cfg.num_layers, "fp32": 0}}
    if (launches != expected or flash_routes != {"wgmma": n_attn, "fp32": 0}
            or cfg.resolved_head_dim != 112):
        fail(f"serve_hybrid: kernel launches {launches}, flash routes {flash_routes}, "
             f"head_dim {cfg.resolved_head_dim}; expected {expected}, flash all on wgmma "
             f"at head_dim 112")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_hybrid: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_hybrid: generated tokens out of range")
    params = param_count(cfg)
    shared = sum(p.numel() for p in model.shared_attn.parameters())
    prefill_bound, prefill_flops, prefill_bytes, decode_bound, decode_bytes = \
        hybrid_serve_bounds(cfg, params, shared, b, prompt, gen)
    row = dict(config=f"zamba2-7b full ({cfg.num_layers} layers, shared block after "
                      f"{n_attn}, head_dim {cfg.resolved_head_dim}, bf16)",
               params=params, shared_block_params=shared, batch=b, prompt=prompt, gen=gen,
               init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_ms=prefill_bound[0] * 1e3, prefill_bound_by=prefill_bound[1],
               prefill_tflop=prefill_flops / 1e12, prefill_gbytes=prefill_bytes / 1e9,
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_step_bound_ms=decode_bound[0] * 1e3, decode_step_bound_by=decode_bound[1],
               decode_step_gbytes=decode_bytes / 1e9,
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes, logits_finite=finite,
               repeat_identical=bool((warm == seqs).all()),
               profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve_hybrid", **row)
    del model, prefill, decode
    torch.cuda.empty_cache()
    return row


def routing_compare(card_log: list, cpu_log: list, k: int) -> dict:
    """The routing of the card's run against the CPU's, record by record
    (one per MoE call: layer by layer, prefill, decode steps, loss): the
    assignments whose expert differs (flips), the capacity verdicts that
    differ, and, on the card's gate probabilities, the smallest gap between
    a token's k-th and (k+1)-th expert over the real experts: how close the
    closest token came to flipping."""
    flips = valid_diff = 0
    gap = math.inf
    for a, b in zip(card_log, cpu_log):
        flips += int((a["top_e"].cpu() != b["top_e"]).sum())
        valid_diff += int((a["valid"].cpu() != b["valid"]).sum())
        top = a["gate_probs"].float().topk(k + 1, dim=-1).values
        gap = min(gap, float((top[..., k - 1] - top[..., k]).min()))
    if len(card_log) != len(cpu_log):
        fail(f"slice_moe: {len(card_log)} MoE calls on the card, {len(cpu_log)} on the CPU")
    return dict(moe_calls=len(card_log), flipped_assignments=flips,
                valid_differs=valid_diff, min_gate_gap=gap,
                dropped_assignments=sum(int((~r["valid"]).sum()) for r in cpu_log),
                assignments=sum(r["valid"].numel() for r in cpu_log))


def phase_slice_moe(torch):
    """qwen2-moe-a2.7b at full width, cut to 2 layers, fp32: the same
    weights on the CPU (plain versions) and on the card (kernels). Prefill
    of 1 x 576 tokens, 8 decode steps (both sides take the CPU's greedy
    token), then the loss of 1 x 577 tokens and every gradient; the routing
    of every MoE call compared first."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, moe
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    from repro_torch.train.state import grad_tree
    from repro_torch.tree import keystr, tree_flatten_with_path

    m = MOE_SLICE
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b"), num_layers=m["layers"],
                              dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card (1.83 B numbers drawn on the host take ~15 s), then
    # copied to the CPU
    card = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (m["batch"], m["seq"] + 1)))
    prompt = tokens[:, :m["seq"]]
    reset_launches()
    runs, logs = {}, {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        prefill, decode = build_prefill_step(model), build_decode_step(model)
        with moe.record_routing() as log:
            logits, cache = prefill(prompt.to(dev), m["seq"] + m["steps"] + 1)
            outs = [logits.cpu()]
            for step in range(m["steps"]):
                tok = (runs["cpu"] if name == "cuda" else outs)[step].argmax(-1)
                logits, cache = decode(cache, tok.to(dev))
                outs.append(logits.cpu())
            del cache
            model.requires_grad_(True)
            loss, aux = model.loss({"tokens": tokens.to(dev)})
            loss.backward()
        runs[name] = outs
        logs[name] = log
        runs[name + "_loss"] = [loss.detach().cpu(), aux["xent"].detach().cpu(),
                                aux["aux"].detach().cpu()]
        runs[name + "_grads"] = {keystr(p): t for p, t in
                                 tree_flatten_with_path(_host_tree(grad_tree(model)))}
    launches = read_launches()
    routing = routing_compare(logs["cuda"], logs["cpu"], cfg.top_k)
    del logs
    expected = {"flash_attention": 2 * cfg.num_layers,
                "decode_attention": cfg.num_layers * m["steps"], "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if launches != expected:
        fail(f"slice_moe: kernel launches {launches}, expected {expected} (prefill and "
             f"the loss's forward each run flash once a layer)")
    errs = []
    for ref, out in zip(runs["cpu"], runs["cuda"]):
        if out.shape != (m["batch"], cfg.padded_vocab) or not torch.isfinite(out).all():
            fail(f"slice_moe: logits of shape {tuple(out.shape)} or not finite")
        errs.append(check_close("slice_moe logits card vs cpu", out, ref, m["tol"]))
    loss_err = {part: check_close(f"slice_moe {part} card vs cpu", got, want, m["tol"])
                for part, got, want in zip(("loss", "xent", "aux"), runs["cuda_loss"],
                                           runs["cpu_loss"])}
    grad_err = {k: check_close(f"slice_moe grad {k} card vs cpu", runs["cuda_grads"][k], ref,
                               m["tol"]) for k, ref in runs["cpu_grads"].items()}
    for k, g in runs["cuda_grads"].items():
        if "|moe|" in k and (not torch.isfinite(g).all() or not (g != 0).any()):
            fail(f"slice_moe: MoE gradient {k} is not finite or is all 0")
    row = dict(config=f"qwen2-moe-a2.7b full width, {cfg.num_layers} layers, fp32",
               batch=m["batch"], prompt=m["seq"], decode_steps=m["steps"],
               loss_tokens=list(tokens.shape), init_s=init_s, routing=routing,
               logits_max_abs_err_per_step=errs, loss=float(runs["cuda_loss"][0]),
               aux=float(runs["cuda_loss"][2]), loss_err=loss_err,
               grad_leaves=len(grad_err), grad_max_abs_err=max(grad_err.values()),
               moe_grad_err={k: v for k, v in grad_err.items() if "|moe|" in k},
               tol=m["tol"], launches=launches)
    emit("slice_moe", **row)
    del cpu, card, runs
    torch.cuda.empty_cache()
    return row


def moe_serve_bounds(cfg, params: int, b: int, prompt: int, gen: int, slots: int,
                     distinct_experts: float):
    """The card's least times of the MoE serve run, bf16. Operations: the
    matrix products of every parameter but the embedding, the head's and
    the routed experts' once a token, the head's for the last position only
    (prefill), the routed experts' once per assignment (k a token) or, for
    the reference's dispatch, once per slot of its (G, E, C) table (``slots``
    a layer), and the causal attention. Bytes: every weight but the
    embedding table read once and the KV cache written (prefill) or read up
    to the attended length (decode). A decode step's bytes are given twice:
    with all E experts a layer read (the reference's dispatch runs every
    expert) and with the ``distinct_experts`` a layer that this run's steps
    picked on average. Returns a dict of (seconds, bound_by) and the counts."""
    from repro_torch.roofline.hw import bound_seconds
    L, kh, h, hd = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    d, e, k = cfg.d_model, cfg.padded_experts, cfg.top_k
    per_expert = 3 * d * cfg.moe_d_ff
    n_embed = n_head = cfg.padded_vocab * d           # untied
    n_routed = L * e * per_expert
    n_dense = params - n_embed - n_head - n_routed    # attention, shared expert, router, norms
    tokens = b * prompt
    kv_bytes_per_pos = 2 * L * b * kh * hd * 2
    attn_flops = L * 4 * b * h * hd * prompt * (prompt + 1) // 2
    weights = 2 * (params - n_embed)
    prefill_bytes = weights + kv_bytes_per_pos * prompt
    prefill_assigned = (2 * n_dense * tokens + 2 * n_head * b
                        + 2 * per_expert * L * tokens * k + attn_flops)
    prefill_slots = prefill_assigned - 2 * per_expert * L * tokens * k \
        + 2 * per_expert * L * slots
    lens = range(prompt + 1, prompt + gen)
    steps = gen - 1
    kv_read = kv_bytes_per_pos * sum(lens) / steps
    decode_flops = (2 * (n_dense + n_head) * b + 2 * per_expert * L * b * k
                    + L * 4 * b * h * hd * sum(lens) / steps)
    decode_all = weights + kv_read
    decode_picked = weights - 2 * n_routed + 2 * L * distinct_experts * per_expert + kv_read
    return dict(prefill_assigned=bound_seconds(prefill_assigned, prefill_bytes, "bfloat16"),
                prefill_slots=bound_seconds(prefill_slots, prefill_bytes, "bfloat16"),
                decode_all_experts=bound_seconds(decode_flops, decode_all, "bfloat16"),
                decode_picked_experts=bound_seconds(decode_flops, decode_picked, "bfloat16"),
                prefill_tflop_assigned=prefill_assigned / 1e12,
                prefill_tflop_slots=prefill_slots / 1e12,
                decode_gbytes_all_experts=decode_all / 1e9,
                decode_gbytes_picked_experts=decode_picked / 1e9)


def phase_serve_moe(torch):
    """Full qwen2-moe-a2.7b (24 layers, 60 routed experts padded to 64, top-4,
    a shared expert of 5632, MHA of 16 heads at head_dim 128, untied head,
    bf16), random weights drawn on the card from a seed: the same 8 x 1000
    prompts and 32 greedy tokens, served twice (the first a warm-up whose
    routing is recorded). 24 flash launches on wgmma, 24 x 31 decode
    launches, no SSD launch."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import active_param_count, build_model, moe, param_count
    from repro_torch.train.serve import build_decode_step, build_prefill_step

    cfg = get_arch("qwen2-moe-a2.7b")
    b, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    t0 = time.perf_counter()
    # drawn by a CUDA generator on the card: 15 B numbers drawn on the host
    # would cost minutes of host time
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, prompt))).cuda()
    with moe.record_routing() as log:
        warm, *_ = serve_once(torch, prefill, decode, tokens, prompt + gen, gen)
    L = cfg.num_layers
    pre, dec = log[:L], log[L:]
    if len(dec) != L * (gen - 1):
        fail(f"serve_moe: {len(log)} MoE calls in the warm-up, expected {L * gen}")
    dropped = sum(int((~r["valid"]).sum()) for r in pre) / sum(r["valid"].numel() for r in pre)
    slots = pre[0]["top_e"].shape[0] * cfg.padded_experts * pre[0]["capacity"]
    distinct = sum(int(r["top_e"].unique().numel()) for r in dec) / len(dec)
    dec_dropped = sum(int((~r["valid"]).sum()) for r in dec)
    # how alike the prefill's tokens route: the share of a layer's tokens
    # whose first expert is that layer's most common first expert
    mode_share = sum(int(torch.bincount(r["top_e"][..., 0].reshape(-1)).max())
                     / r["top_e"][..., 0].numel() for r in pre) / len(pre)
    # and within a group (500 consecutive tokens of one prompt): the experts
    # its assignments reach, of the 60
    per_group = sum(int(g.unique().numel()) for r in pre for g in r["top_e"]) \
        / sum(r["top_e"].shape[0] for r in pre)
    if max(int(r["top_e"].max()) for r in log) >= cfg.num_experts:
        fail("serve_moe: a padded expert was routed to")
    groups, cap = pre[0]["top_e"].shape[0], pre[0]["capacity"]
    del log, pre, dec

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, finite, t_prefill, t_decode, shape = serve_once(
        torch, prefill, decode, tokens, prompt + gen, gen)
    launches = read_launches()
    flash_routes = dict(fa.flash_attention.routes)
    expected = {"flash_attention": L, "decode_attention": L * (gen - 1), "ssd": 0,
                "ssd_routes": {"wgmma": 0, "fp32": 0}}
    if (launches != expected or flash_routes != {"wgmma": L, "fp32": 0}
            or (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) != (16, 16, 128)):
        fail(f"serve_moe: kernel launches {launches}, flash routes {flash_routes}; expected "
             f"{expected}, flash all on wgmma, MHA 16/16 at head_dim 128")
    if not finite or tuple(shape) != (b, cfg.padded_vocab):
        fail(f"serve_moe: logits not finite or of shape {tuple(shape)}")
    if seqs.shape != (b, gen) or not ((seqs >= 0) & (seqs < cfg.padded_vocab)).all():
        fail("serve_moe: generated tokens out of range")
    repeat = bool((warm == seqs).all())
    if not repeat:
        fail("serve_moe: the repeat generated other tokens than the warm-up")
    params = param_count(cfg)
    bounds = moe_serve_bounds(cfg, params, b, prompt, gen, slots, distinct)
    row = dict(config=f"qwen2-moe-a2.7b full ({L} layers, {cfg.num_experts} experts padded "
                      f"to {cfg.padded_experts}, top-{cfg.top_k}, shared "
                      f"{cfg.shared_expert_d_ff}, MHA {cfg.num_heads}/{cfg.num_kv_heads} at "
                      f"head_dim {cfg.resolved_head_dim}, bf16)",
               params=params, active_params=active_param_count(cfg), batch=b,
               prompt=prompt, gen=gen, init_s=init_s, prefill_ms=t_prefill * 1e3,
               prefill_bound_assigned_ms=bounds["prefill_assigned"][0] * 1e3,
               prefill_bound_assigned_by=bounds["prefill_assigned"][1],
               prefill_bound_slots_ms=bounds["prefill_slots"][0] * 1e3,
               prefill_bound_slots_by=bounds["prefill_slots"][1],
               prefill_tflop_assigned=bounds["prefill_tflop_assigned"],
               prefill_tflop_slots=bounds["prefill_tflop_slots"],
               prefill_groups=groups, prefill_capacity=cap, prefill_slots_per_layer=slots,
               prefill_dropped_share=dropped, prefill_top1_mode_share=mode_share,
               prefill_experts_per_group=per_group,
               decode_dropped=dec_dropped,
               decode_distinct_experts_per_layer=distinct,
               decode_steps=gen - 1, decode_ms_per_step=t_decode * 1e3 / (gen - 1),
               decode_bound_all_experts_ms=bounds["decode_all_experts"][0] * 1e3,
               decode_bound_all_experts_by=bounds["decode_all_experts"][1],
               decode_bound_picked_experts_ms=bounds["decode_picked_experts"][0] * 1e3,
               decode_bound_picked_experts_by=bounds["decode_picked_experts"][1],
               decode_gbytes_all_experts=bounds["decode_gbytes_all_experts"],
               decode_gbytes_picked_experts=bounds["decode_gbytes_picked_experts"],
               decode_tok_s=b * (gen - 1) / t_decode,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, flash_routes=flash_routes, logits_finite=finite,
               repeat_identical=repeat, profiler_sessions_before=PROFILER_SESSIONS[0],
               first_sequence=seqs[0].tolist())
    emit("serve_moe", **row)
    del model, prefill, decode
    torch.cuda.empty_cache()
    return row


def phase_train_ssm(torch):
    """mamba2-2.7b at full width, cut to 8 layers, trained by the port's
    SimCluster with a failure and a stream recovery in the middle: the SSD
    kernel under autograd on the main training path."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import param_count
    from repro_torch.roofline.hw import bound_seconds

    t = TRAIN_SSM
    cfg = dataclasses.replace(get_arch("mamba2-2.7b"), num_layers=t["layers"])
    run = train_through_a_failure(torch, "train_ssm", cfg, t, "chip_smoke_ssm_ckpt")
    steps, losses = run["steps"], run["losses"]
    expected = {"flash_attention": 0, "decode_attention": 0, "ssd": cfg.num_layers * steps,
                "ssd_routes": {"wgmma": cfg.num_layers * steps, "fp32": 0}}
    if run["launches"] != expected:
        fail(f"train_ssm: kernel launches {run['launches']}, expected {expected}")
    # the loss falls: the first step's batch (the same tokens, from the
    # loaders) scored again after the run. Each step's own batch is new
    # uniform random tokens, whose loss moves by batch noise more than by
    # what 3 updates can learn about them.
    clu = run["clu"]
    batch0 = {"tokens": torch.from_numpy(np.concatenate(
        [w.loader.get(0) for w in clu.workers[:clu.active_dp]], axis=0)).to(clu.device)}
    with torch.no_grad():
        first_batch_loss_after = float(clu.model.loss(batch0)[0])
    del clu, batch0
    if not first_batch_loss_after < losses[0]:
        fail(f"train_ssm: the first batch's loss {losses[0]} before the run, "
             f"{first_batch_loss_after} after it; expected it to fall")

    params = param_count(cfg)
    # 6 operations per parameter and token, and the SSD's own (forward once,
    # backward twice the forward's)
    ssd_flops, _ = ssd_full_work(t["global_batch"], t["seq_len"], cfg.ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, 2)
    flops = (6 * params * t["global_batch"] * t["seq_len"]
             + 3 * cfg.num_layers * ssd_flops)
    bound = bound_seconds(flops, params * (2 + 2 + 2 + 3 * 4 * 2), "bfloat16")
    row = dict(config=f"mamba2-2.7b full width, {cfg.num_layers} of 64 layers, bf16",
               **train_row(torch, run, t, params, bound, flops),
               first_batch_loss_after=first_batch_loss_after)
    row["host_rss_after_free_gb"] = close_cluster(torch, run)
    emit("train_ssm", **row)
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False      # full fp32 comparisons
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    path, build_s, log = _build.build()
    emit("build", seconds=build_s, library=str(path.relative_to(ROOT)),
         sources=[str(s.relative_to(ROOT)) for s in _build._sources()],
         ptxas=ptxas_summary(log), sass_hgmma=sass_hgmma(path))

    # the slices and both serve runs come before any torch.profiler session
    timed("slice", phase_slice, torch)
    served, serve = timed("serve", phase_serve, torch)
    timed("slice_ssm", phase_slice_ssm, torch)
    ssm_model, ssm_prefill, ssm_decode, ssm_tokens, serve_ssm = timed(
        "serve_ssm", phase_serve_ssm, torch)
    serve_hybrid = timed("serve_hybrid", phase_serve_hybrid, torch)
    timed("slice_moe", phase_slice_moe, torch)
    serve_moe = timed("serve_moe", phase_serve_moe, torch)
    timed("train_grad", phase_train_grad, torch)
    train_mesh = timed("train_mesh", phase_train_mesh, torch)
    scenarios = timed("scenarios", phase_scenarios, torch)
    train_ssm = timed("train_ssm", phase_train_ssm, torch)
    train = timed("train", phase_train, torch)
    kernels = timed("kernels", phase_kernels, torch, F)
    ssd_rows = timed("kernels", phase_ssd_kernel, torch)
    _, prefill, decode, tokens, _ = served
    timed("trace", phase_trace, torch, prefill, decode, tokens, "qwen3-0.6b")
    timed("trace", phase_trace, torch, ssm_prefill, ssm_decode, ssm_tokens, "mamba2-2.7b")
    del ssm_model, ssm_prefill, ssm_decode
    torch.cuda.empty_cache()
    timed("serve", phase_serve, torch, served)        # the same serve, after the profiler

    fa = kernels["flash_attention"]["bfloat16"]
    fa_train = kernels["flash_attention"]["bfloat16_train"]
    da = kernels["decode_attention"]["bfloat16"]
    da_main = da[-1]                                  # cur_len 1032 = the cache length
    ssd_main = ssd_rows[("mamba2-2.7b", SERVE["prompt"], "bfloat16")]  # the serve run's shape
    ssd_hyb = ssd_rows[("zamba2-7b", SERVE["prompt"], "bfloat16")]
    keys = ("shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def hd112(rows):
        """The hd-112 rows (bf16, fp32) of one kernel for the kernels line."""
        return {dname: {k_: row[k_] for k_ in keys} for dname, row in rows.items()}

    def moe_shape(row):
        """A kernel's row at qwen2-moe-a2.7b's shape (bf16) for the kernels line."""
        return {k_: row[k_] for k_ in keys}
    line = [
        dict(name="flash_attention", route="cuda", dispatch=fa["route"],
             source="src/repro_torch/csrc/flash_attention_wgmma.cu",
             fp32_source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:25",
             tpu_kernel="_flash_fwd_kernel (pl.pallas_call at flash_attention.py:80)",
             design="redesigned for Hopper: bf16 Q.K^T and P.V on wgmma with P kept in "
                    "registers; TMA loads by a producer warp into a 3-stage swizzled ring; two "
                    "consumer warpgroups in ping-pong; fp32 inputs on the CUDA-core kernel",
             launches=serve["launches"]["flash_attention"],
             train_launches=train["launches"]["flash_attention"],
             scenario_launches=dict(
                 corpus=scenarios["corpus"]["launches"]["flash_attention"],
                 full_width=scenarios["replay"]["launches"]["flash_attention"]),
             max_abs_err=fa["max_abs_err"], tol=fa["tol"], shape=fa["shape"],
             dtype="bfloat16", ms=fa["ms"], plain_ms=fa["plain_ms"],
             bound_ms=fa["bound_ms"], bound_by=fa["bound_by"], library_ms=fa["library_ms"],
             timing=fa["timing"],
             train_shape={k_: fa_train[k_] for k_ in ("shape", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
             hybrid_launches=serve_hybrid["launches"]["flash_attention"],
             train_ssm_launches=train_ssm["launches"]["flash_attention"],
             train_mesh_launches=train_mesh["flash_launches"],
             hd112=hd112({d: kernels["flash_attention"][f"{d}_hd112"]
                          for d in ("bfloat16", "float32")}),
             moe_launches=serve_moe["launches"]["flash_attention"],
             moe_shape=moe_shape(kernels["flash_attention"]["bfloat16_moe"]),
             backward="plain blockwise_attention recompute (FlashAttention), no kernel"),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attn.cu",
             replaces="src/repro/kernels/decode_attn.py:24",
             tpu_kernel="_decode_kernel (pl.pallas_call at decode_attn.py:71)",
             design="redesigned for Hopper: split over the cache, grid (K, B, n_split), "
                    "partials merged by a second grid in the same call",
             n_split=da_main["n_split"], rows_per_split=da_main["rows_per_split"],
             launches=serve["launches"]["decode_attention"],
             train_launches=train["launches"]["decode_attention"],
             scenario_launches=scenarios["replay"]["launches"]["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in da), tol=da_main["tol"],
             shape=da_main["shape"], cur_len=da_main["cur_len"], dtype="bfloat16",
             ms=da_main["ms"], plain_ms=da_main["plain_ms"],
             bound_ms=da_main["bound_ms"], bound_by=da_main["bound_by"],
             library_ms=da_main["library_ms"], timing=da_main["timing"],
             hybrid_launches=serve_hybrid["launches"]["decode_attention"],
             train_ssm_launches=train_ssm["launches"]["decode_attention"],
             hd112=hd112({d: kernels["decode_attention"][f"{d}_hd112"][-1]
                          for d in ("bfloat16", "float32")}),
             moe_launches=serve_moe["launches"]["decode_attention"],
             moe_shape=moe_shape(kernels["decode_attention"]["bfloat16_moe"][-1])),
        dict(name="ssd", route="cuda", dispatch=ssd_main["route"],
             source="src/repro_torch/csrc/ssd_wgmma.cu",
             fp32_source="src/repro_torch/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:24",
             tpu_kernel="_ssd_chunk_kernel (pl.pallas_call at ssd.py:76) and the plain "
                        "inter-chunk combine of ssd() (ssd.py:128-154)",
             design="redesigned for Hopper: the whole SSD in one launch, a block per (batch, "
                    "2 heads) walking 64-row steps with the state in registers; scores, "
                    "inter and intra terms and the state update on wgmma, weighted operands "
                    "split into bf16 high and low parts; TMA issued by one thread; y written "
                    "once in bf16; fp32 inputs on the CUDA-core kernel plus a plain combine",
             launches=serve_ssm["launches"]["ssd"],
             train_launches=train["launches"]["ssd"],
             scenario_launches=scenarios["replay"]["launches"]["ssd"],
             max_abs_err=ssd_main["max_abs_err"], tol=ssd_main["tol"],
             final_state_err=ssd_main["final_state_err"], state_tol=STATE_TOL,
             shape=ssd_main["shape"], dtype="bfloat16", ms=ssd_main["ms"],
             plain_ms=ssd_main["plain_ms"], bound_ms=ssd_main["bound_ms"],
             bound_by=ssd_main["bound_by"], library_ms=None,
             library_note=ssd_main["library_note"], timing=ssd_main["timing"],
             hybrid_launches=serve_hybrid["launches"]["ssd"],
             train_ssm_launches=train_ssm["launches"]["ssd"],
             hybrid_shape={k_: ssd_hyb[k_] for k_ in keys},
             moe_launches=serve_moe["launches"]["ssd"],
             backward="plain ssd_chunked recompute (SSD), no kernel"),
    ]
    emit("timing", kernel_timings=TIMING, profiler_sessions=PROFILER_SESSIONS[0],
         phase_s=PHASE_S, script_s=time.perf_counter() - T_START)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

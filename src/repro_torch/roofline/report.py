"""Render the roofline and dry-run tables from the dry-run's cell JSONs
(port of ``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun]

The cells are ``launch.dryrun``'s, with the reference's keys; their times are
on one H100's rates (``roofline.hw``), their memory a rank's bytes.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import dryrun_cells, get_arch


def load(dir_: Path):
    cells = {}
    for p in sorted(dir_.glob("*.json")):
        d = json.loads(p.read_text())
        cells[(d["mesh"], d["arch"], d["shape"])] = d
    return cells


def fmt_ms(s):
    return f"{s * 1e3:.1f}"


def roofline_table(cells) -> str:
    rows = ["| arch | shape | kind | compute ms | memory ms | collective ms |"
            " bottleneck | useful | roofline | peak GiB | fits |",
            "|---|---|---|---|---|---|---|---|---|---|---|"[:-4]]
    for cfg, shape, skip in dryrun_cells(include_skips=True):
        key = ("pod16x16", cfg.name, shape.name)
        if skip:
            rows.append(f"| {cfg.name} | {shape.name} | — | — | — | — | "
                        f"skipped (full attention at 524k; DESIGN.md §5) "
                        f"| — | — | — | — |")
            continue
        d = cells.get(key)
        if d is None or "compute_s" not in d:
            rows.append(f"| {cfg.name} | {shape.name} | {shape.kind} "
                        f"| (pending) | | | | | | | |")
            continue
        peak = d["peak_memory_per_device"] / 2**30
        rows.append(
            f"| {cfg.name} | {shape.name} | {d['kind']} "
            f"| {fmt_ms(d['compute_s'])} | {fmt_ms(d['memory_s'])} "
            f"| {fmt_ms(d['collective_s'])} | {d['bottleneck']} "
            f"| {d['useful_ratio']:.2f} | {d['roofline_fraction']:.3f} "
            f"| {peak:.1f} | {'Y' if d['fits_hbm'] else 'N'} |")
    return "\n".join(rows)


def dryrun_table(cells) -> str:
    rows = ["| mesh | arch | shape | compile s | bytes/device GiB | "
            "collective schedule |",
            "|---|---|---|---|---|---|"]
    for (mesh, arch, shape), d in sorted(cells.items()):
        ma = d["memory_analysis"]
        per_dev = (ma["argument_size_in_bytes"] + ma["output_size_in_bytes"]
                   + ma["temp_size_in_bytes"] - ma["alias_size_in_bytes"]) / 2**30
        sched = d["production_collectives"]["count_by_kind"]
        rows.append(f"| {mesh} | {arch} | {shape} | {d['compile_s']:.0f} "
                    f"| {per_dev:.1f} | {sched} |")
    return "\n".join(rows)


def summary(cells) -> str:
    single = [d for (m, _, _), d in cells.items() if m == "pod16x16"]
    multi = [d for (m, _, _), d in cells.items() if m == "pod2x16x16"]
    done = [d for d in single if "roofline_fraction" in d]
    lines = [
        f"- single-pod cells run: {len(single)} / 32",
        f"- multi-pod cells run: {len(multi)} / 32",
    ]
    if done:
        worst = min(done, key=lambda d: d["roofline_fraction"])
        best = max(done, key=lambda d: d["roofline_fraction"])
        coll = max(done, key=lambda d: d["collective_s"])
        lines += [
            f"- worst roofline fraction: {worst['arch']} x {worst['shape']} "
            f"= {worst['roofline_fraction']:.3f} ({worst['bottleneck']}-bound)",
            f"- best roofline fraction: {best['arch']} x {best['shape']} "
            f"= {best['roofline_fraction']:.3f}",
            f"- most collective-bound: {coll['arch']} x {coll['shape']} "
            f"({coll['collective_s']*1e3:.0f} ms)",
        ]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    cells = load(Path(args.dir))
    print("## Summary\n")
    print(summary(cells))
    print("\n## Roofline (single pod, 16x16)\n")
    print(roofline_table(cells))
    print("\n## Per-cell diagnosis\n")
    print(diagnosis_table(cells))
    print("\n## Dry-run steps\n")
    print(dryrun_table(cells))


# --------------------------------------------------------------------------- #
# Per-cell one-line diagnoses: one sentence on what would move the dominant
# term down, the reference's sentences in the port's terms
# --------------------------------------------------------------------------- #
def diagnose(d: dict) -> str:
    arch, kind = d["arch"], d["kind"]
    bot = d.get("bottleneck", "?")
    cfg = get_arch(arch)
    if bot == "collective":
        if cfg.is_moe and kind != "decode":
            return ("an all-to-all dispatch (each card receives only its experts' "
                    "slots) would cut the replicated MoE input over \"model\" ~16x")
        if kind == "decode":
            return ("the cache split by sequence (the mesh's serve steps) keeps the "
                    "merge's (o, lse) gather the only decode collective")
        return ("ring/Ulysses attention and FSDP gathers overlapped with the layer "
                "bodies would hide the gather stream behind compute")
    if bot == "memory":
        if kind == "decode":
            return ("decode reads params+cache once per token — raise batch "
                    "or shrink the mesh slice to lift arithmetic intensity; "
                    "int8 KV cache would halve the traffic")
        return ("larger microbatching or offloaded activations would cut "
                "the activation stream; weights already stream once/pass")
    return ("compute-bound: the flash kernel's backward on wgmma and fused "
            "norm/MLP passes would raise the card's tensor-core utilization")


def diagnosis_table(cells) -> str:
    rows = ["| arch | shape | bottleneck | what moves it down |",
            "|---|---|---|---|"]
    for cfg, shape, skip in dryrun_cells():
        d = cells.get(("pod16x16", cfg.name, shape.name))
        if d is None or "bottleneck" not in d:
            continue
        rows.append(f"| {cfg.name} | {shape.name} | {d['bottleneck']} "
                    f"| {diagnose(d)} |")
    return "\n".join(rows)


if __name__ == "__main__":
    main()

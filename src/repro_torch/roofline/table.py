"""Render the roofline table from experiments/dryrun/*.json — counterpart
of `repro/roofline/table.py`: the same rows give the same text.

  PYTHONPATH=src python -m repro_torch.roofline.table [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SKIPPED_LONG = (
    "qwen2_moe_a2_7b", "granite_moe_1b_a400m", "internvl2_26b",
    "qwen1_5_0_5b", "deepseek_67b", "qwen2_5_32b", "gemma2_27b",
    "whisper_tiny",
)

ARCH_ORDER = [
    "qwen2_moe_a2_7b", "granite_moe_1b_a400m", "internvl2_26b",
    "qwen1_5_0_5b", "deepseek_67b", "qwen2_5_32b", "gemma2_27b",
    "whisper_tiny", "recurrentgemma_2b", "mamba2_2_7b",
    "msc-mf", "msc-gram", "msc-mf-coll", "msc-gram-coll",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "msc_1000", "msc_1024"]


def _key(r):
    a = r["arch"].replace("-", "_").replace(".", "_")
    a = {"qwen2_5_32b": "qwen2_5_32b", "msc_mf": "msc-mf",
         "msc_gram": "msc-gram", "msc_mf_coll": "msc-mf-coll",
         "msc_gram_coll": "msc-gram-coll"}.get(a, a)
    ai = ARCH_ORDER.index(a) if a in ARCH_ORDER else 99
    si = SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 99
    return (ai, si, r["mesh"])


def load(dir_: str):
    rows = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return sorted(rows, key=_key)


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f}s "
    return f"{x*1e3:8.2f}ms"


def render(rows, mesh: str = "16x16") -> str:
    out = ["| arch | shape | comp | mem | coll(ring) | dominant | "
           "MODEL/HLO | roofline | HBM fit | note |",
           "|---|---|---:|---:|---:|---|---:|---:|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        ms = r.get("memory_stats", {})
        temp = ms.get("tpu_temp_estimate", ms.get("temp_size_in_bytes", 0))
        args = ms.get("argument_size_in_bytes", 0)
        fit = "✓" if (temp + args) <= 16 * 2**30 else "✗"
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_link_s'])} "
            f"| {r['dominant']} | {r['flops_ratio']:.3f} "
            f"| {r['roofline_fraction']*100:.1f}% | {fit} "
            f"| {(temp+args)/2**30:.1f}GiB/dev |")
    # the skipped long_500k cells, for the full 40-cell accounting
    if mesh == "16x16":
        for a in SKIPPED_LONG:
            out.append(f"| {a} | long_500k | — | — | — | skipped | — | — "
                       f"| — | full attention: no sub-quadratic mode "
                       f"(DESIGN.md §4) |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    rows = load(args.dir)
    print(render(rows, args.mesh))


if __name__ == "__main__":
    main()

"""Roofline analysis of the dry run's cells (a port of
``repro.launch.roofline``): three terms per (arch x shape) cell from the
dry-run JSONs, the dominant one, the MODEL_FLOPS ratio, and a markdown
table.  The denominators are one H100 SXM's (``launch.mesh.HW``):

  compute    = FLOPs_per_device / 989e12            (bf16 peak a GPU)
  memory     = bytes_per_device / 3.35e12           (HBM3 a GPU)
  collective = collective_bytes_per_device / 450e9  (NVLink 4 a GPU, one
                                                     direction, inside a
                                                     node of 8)

The collective term is NVLink's, as if every peer sat in one NVLink domain;
a mesh beyond 8 GPUs crosses nodes, where the inter-node network is slower,
so it is a lower bound there.  ``roofline_fraction`` = ideal time /
max(the three terms): how close the step is to its roof if the terms
overlapped perfectly; the ideal is the larger of the model FLOPs at peak
and every argument byte read once.

Usage: python -m repro_torch.launch.roofline [--dir build/dryrun] [--md out.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from .mesh import HW

__all__ = ["analyze_record", "build_table", "main"]


def analyze_record(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("status") != "run" or not rec.get("ok"):
        return None
    chips = rec["chips"]
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    coll_dev = rec["collectives"]["total_bytes"]
    t_compute = flops_dev / HW.PEAK_FLOPS
    t_memory = bytes_dev / HW.HBM_BW
    t_collective = coll_dev / HW.NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    dominant = max(terms, key=terms.get)
    model_fl = rec["model_flops"]
    total = flops_dev * chips
    useful = model_fl / total if total else 0.0
    # ideal step time = max(model FLOPs at peak, every argument byte read
    # once at HBM bw) -- decode is legitimately memory-bound (weights + KV
    # must stream), so a compute-only ideal would mean nothing there
    t_ideal = max(model_fl / (chips * HW.PEAK_FLOPS),
                  rec["memory"]["argument_bytes"] / HW.HBM_BW)
    bound = max(terms.values())
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "step", "chips")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "model_flops": model_fl,
        "flops_total": total,
        "useful_ratio": useful,
        "t_ideal_s": t_ideal,
        "roofline_fraction": t_ideal / bound if bound > 0 else 0.0,
        "fits_hbm": rec["memory"]["fits_hbm"],
        "live_gib": rec["memory"]["live_bytes"] / 2**30,
    }


_SUGGEST = {
    "compute": "cut FLOPs: less remat recompute, or prune (BSR) the big GEMMs",
    "memory": "cut HBM traffic: fuse producers / consumers (eager PyTorch fuses nothing), "
              "bf16 intermediates, a smaller logits dtype",
    "collective": "cut NVLink bytes: reduce-scatter instead of all-reduce, bf16 grads, "
                  "keep TP inside a node, sequence parallelism",
}


def build_table(records: List[Dict[str, Any]]) -> str:
    rows = [
        "| arch | shape | step | compute s | memory s | collective s (NVLink) | dominant | "
        "useful (6ND/FLOPs) | roofline frac | live GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | "
            f"{r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} | "
            f"{r['live_gib']:.1f} | {'y' if r['fits_hbm'] else 'N'} |"
        )
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    default_dir = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
    ap.add_argument("--dir", default=default_dir)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)

    records, skips = [], []
    for path in sorted(glob.glob(os.path.join(args.dir, f"*__{args.mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "run":
            skips.append(f"{rec['arch']} {rec['shape']}: {rec['status']}")
            continue
        a = analyze_record(rec)
        if a:
            records.append(a)
        else:
            skips.append(f"{rec['arch']} {rec['shape']}: FAILED {rec.get('error', '')}")
    table = build_table(records)
    print(table)
    print("\nSkipped/failed cells:")
    for s in skips:
        print("  ", s)
    print("\nPer-cell dominant-term advice:")
    for r in records:
        print(f"  {r['arch']:22s} {r['shape']:12s} -> {r['dominant']}: {_SUGGEST[r['dominant']]}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

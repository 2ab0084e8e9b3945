#!/usr/bin/env python3
"""Compare this tree of the PyTorch/CUDA port with an earlier commit on
one NVIDIA card.

Unpack the earlier commit into a directory that ``.gitignore`` lists,
then run from the repository root:

    git archive <commit> | tar -x -C chipcalls/parent
    python3 chip_compare.py --parent chipcalls/parent --out OUT_DIR

Two parts, each printing one JSON line per result:

  1. expand      — the slice of ``chip_smoke.py`` runs once with this tree
                   to record the arguments of every ``expand_positions``
                   call one exact replay makes; the earlier commit's
                   ``csrc/expand_positions.cu`` is built by its own build
                   module and launched by a copy of its wrapper (an int32
                   ``cumsum`` prelude, then the kernel).  On each call's
                   arguments both wrappers are timed (median of 20, CUDA
                   events, as ``chip_smoke.time_ms``) in the order
                   earlier, this, this, earlier, and their outputs must be
                   equal;
  2. smoke       — ``chip_smoke.py`` of earlier, this, this, earlier, each
                   in a process of its own with its output in ``--out``:
                   warm latencies, device busy time and kernel times of
                   each run.

Needs one card; exits nonzero on any failure.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def parent_expand(torch, lib):
    """The earlier commit's expand_positions wrapper, bound to ``lib``."""
    lib.expand_positions.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.expand_positions.restype = ctypes.c_int

    def run(counts, lo, out_cap):
        dev = counts.device
        l_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
        r_pos = torch.empty(out_cap, dtype=torch.int32, device=dev)
        valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
        offsets = torch.cumsum(counts, 0, dtype=torch.int32)
        lo32 = lo.to(torch.int32).contiguous()
        status = lib.expand_positions(
            offsets.data_ptr(), lo32.data_ptr(), counts.shape[0], out_cap,
            l_idx.data_ptr(), r_pos.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if status:
            raise RuntimeError(f"earlier expand_positions: CUDA error "
                               f"{status}")
        return l_idx, r_pos, valid
    return run


def compare_expand(torch, np, smoke, parent_dir: str, card: str) -> None:
    from caps_tpu_torch.ops import build
    from caps_tpu_torch.ops import expand as X
    build.build()
    args = argparse.Namespace(seed=0, persons=1_000_000, edges=10_000_000)
    _, _, calls, _ = smoke.run_slice(torch, np, args, card)
    spec = importlib.util.spec_from_file_location(
        "parent_build",
        os.path.join(parent_dir, "caps_tpu_torch", "ops", "build.py"))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    old = parent_expand(torch, parent_build.library("expand_positions"))
    for i, a in enumerate(calls["expand_positions_cuda"]):
        for g, w in zip(X.expand_positions_cuda(*a), old(*a)):
            if not torch.equal(g, w):
                raise RuntimeError(f"expand call {i}: this tree and the "
                                   f"earlier commit disagree")
        order = []
        for who in ("parent", "change", "change", "parent"):
            fn = old if who == "parent" else X.expand_positions_cuda
            order.append(smoke.time_ms(torch, lambda fn=fn, a=a: fn(*a)))
        counts, lo, out_cap = a
        smoke.emit({"part": "expand", "card": card, "call": i + 1,
                    "cap_l": counts.shape[0], "out_cap": out_cap,
                    "total": int(counts.sum()),
                    "dtypes": [str(counts.dtype), str(lo.dtype)],
                    "parent_ms": [order[0], order[3]],
                    "change_ms": [order[1], order[2]]})


def summary(path: str) -> dict:
    """Warm latencies, busy time and kernel times of one smoke log."""
    out = {"kernels": {}}
    for line in open(path):
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") == "slice":
            out["cold_s"], out["slice_warm_s"] = d["cold_s"], d["warm_s"]
        elif d.get("phase") == "warm":
            out.update({k: d[k] for k in ("eager_s", "exact_replay_s",
                                          "generic_replay_s")})
            out["busy_s"] = {k: p.get("device_busy_s")
                             for k, p in d["profiles"].items()}
            out["idle_share"] = {k: p.get("device_idle_share")
                                 for k, p in d["profiles"].items()}
        elif d.get("phase") == "kernel":
            out["kernels"][d["name"]] = {k: d.get(k) for k in (
                "ms", "ms_per_query", "call_ms")}
        elif d.get("ok"):
            out["ok"] = True
    return out


def compare_smoke(smoke, parent_dir: str, out_dir: str, card: str) -> bool:
    ok = True
    for i, who in enumerate(("parent", "change", "change", "parent"), 1):
        log = os.path.join(out_dir, f"smoke_{i}_{who}.log")
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, "chip_smoke.py"], stdout=f,
                stderr=subprocess.STDOUT, timeout=1200,
                cwd=parent_dir if who == "parent" else ROOT).returncode
        ok = ok and rc == 0
        smoke.emit({"part": "smoke", "card": card, "run": i, "tree": who,
                    "rc": rc, "log": os.path.relpath(log, ROOT),
                    **summary(log)})
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the earlier commit")
    ap.add_argument("--out", required=True,
                    help="directory for the chip_smoke.py logs")
    args = ap.parse_args()
    parent_dir = os.path.abspath(args.parent)
    if not os.path.isfile(os.path.join(parent_dir, "chip_smoke.py")):
        print(f"chip_compare.py: no chip_smoke.py in {parent_dir}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_compare.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as smoke
    out_dir = os.path.join(ROOT, args.out)
    os.makedirs(out_dir, exist_ok=True)
    card = smoke.card_line()
    print(card, flush=True)
    compare_expand(torch, np, smoke, parent_dir, card)
    ok = compare_smoke(smoke, parent_dir, out_dir, card)
    print(smoke.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

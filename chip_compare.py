#!/usr/bin/env python3
"""Compare this tree of the PyTorch/CUDA port with an earlier commit on
one NVIDIA card.

Unpack the earlier commit into a directory that ``.gitignore`` lists,
then run from the repository root:

    git archive <commit> | tar -x -C chipcalls/parent
    python3 chip_compare.py --parent chipcalls/parent --out OUT_DIR

Five parts, each printing one JSON line per result (``--parts``
picks some; the first four by default):

  1. expand      — the slice of ``chip_smoke.py`` runs once with this tree
                   to record the arguments of every kernel call one exact
                   replay makes; the earlier commit's
                   ``csrc/expand_positions.cu`` is built by its own build
                   module and launched by a copy of its wrapper (an int32
                   ``cumsum`` prelude, then the kernel).  On each call's
                   arguments both wrappers are timed (median of 20, CUDA
                   events, as ``chip_smoke.time_ms``) in the order
                   earlier, this, this, earlier, and their outputs must be
                   equal;
  2. segment     — the same for the dense segment-aggregation kernel
                   (K1, ``csrc/segment_agg.cu``; the earlier wrapper
                   sizes its block partials, then launches): at the
                   replay's call and at count S = 1, 3, 1001 (90 % one
                   code) and 4096, min_i32 and max_f32 at S = 1001 and
                   sum_f32 at S = 1001 and 4096 over 2,097,152 rows, where
                   the earlier kernel runs (S <= 4096, no NaN: it drops
                   NaNs).  Outputs must be equal (sum_f32: rtol and atol
                   1e-5, the two add in different orders).  An empty
                   kernel timed the same way gives the launch floor;
  3. breakdown   — this tree's K1 beside a copy of its source with the
                   fold after the block histograms skipped (its results
                   are wrong; it is timed only), at count S = 1, 1002 and
                   4096, 2,097,152 rows and no rows on the main path's
                   grid: the kernel's time without the fold, and its
                   fixed cost;
  4. smoke       — ``chip_smoke.py`` of earlier, this, this, earlier, each
                   in a process of its own with its output in ``--out``:
                   warm latencies, device busy time and kernel times of
                   each run;
  5. unwind      — the ``slice`` and ``unwind`` phases of each tree's
                   ``chip_smoke.py`` (and its ``lists`` phase, where the
                   tree has one), earlier, this, this, earlier, each in a
                   process of its own with its log in ``--out``: per
                   query of the unwind phase its cold, exact-replay and
                   generic-replay latency, size reads, peak bytes and one
                   exact replay's device busy time.

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


def parent_segment(torch, lib):
    """The earlier commit's dense_segment_agg wrapper, bound to ``lib``
    (its kinds in its order)."""
    kinds = ("count", "sum_f32", "sum_i32", "min_i32", "max_i32",
             "min_f32", "max_f32")
    lib.segment_agg_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.segment_agg_blocks.restype = ctypes.c_int
    lib.segment_agg.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.segment_agg.restype = ctypes.c_int

    def run(codes, ok, values, num_segments, kind):
        dev, n, kind_id = codes.device, codes.shape[0], kinds.index(kind)
        blocks = lib.segment_agg_blocks(n, kind_id)
        partials = torch.empty(
            blocks * num_segments, device=dev,
            dtype=torch.float64 if kind == "sum_f32" else torch.int32)
        out = torch.empty(num_segments, device=dev, dtype=torch.float32
                          if kind.endswith("f32") else torch.int32)
        status = lib.segment_agg(
            codes.data_ptr(), ok.data_ptr(), values.data_ptr(), n,
            num_segments, kind_id, partials.data_ptr(), blocks,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if status:
            raise RuntimeError(f"earlier segment_agg: CUDA error {status}")
        return out
    return run


def parent_library(parent_dir: str, name: str):
    """``name``'s library built by the earlier commit's build module
    from the earlier commit's source."""
    spec = importlib.util.spec_from_file_location(
        "parent_build",
        os.path.join(parent_dir, "caps_tpu_torch", "ops", "build.py"))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    return parent_build.library(name)


def segment_shapes(torch, dev):
    """(label, args) of the edge shapes the earlier K1 also takes."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 2_097_152
    out = []
    for kind, s, skew in (("count", 1, False), ("count", 3, False),
                          ("count", 1001, True), ("count", 4096, False),
                          ("min_i32", 1001, False), ("max_f32", 1001, False),
                          ("sum_f32", 1001, False), ("sum_f32", 4096, False)):
        codes = torch.randint(0, s, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        if skew:
            codes[torch.rand(n, generator=gen, device=dev) < 0.9] = s // 2
        ok = torch.rand(n, generator=gen, device=dev) < 0.8
        if kind.endswith("f32"):
            vals = torch.randn(n, generator=gen, device=dev)
        elif kind == "count":
            vals = codes
        else:
            vals = torch.randint(-1000, 1000, (n,), generator=gen,
                                 device=dev, dtype=torch.int32)
        label = f"{kind}/S={s}" + ("/skew" if skew else "")
        out.append((label, (codes, ok, vals, s, kind)))
    return out


def compare_segment(torch, smoke, calls, parent_dir: str, card: str) -> None:
    from caps_tpu_torch.ops import segment as S
    old = parent_segment(torch, parent_library(parent_dir, "segment_agg"))
    dev = torch.device("cuda")
    shapes = [(f"replay_call_{i + 1}", a)
              for i, a in enumerate(calls["dense_segment_agg_cuda"])]
    shapes += segment_shapes(torch, dev)
    for label, a in shapes:
        tol = (1e-5, 1e-5) if a[4] == "sum_f32" else (0.0, 0.0)
        smoke.check_equal(torch, f"segment[{label}] earlier vs this",
                          S.dense_segment_agg_cuda(*a), old(*a), *tol)
        order = []
        for who in ("parent", "change", "change", "parent"):
            fn = old if who == "parent" else S.dense_segment_agg_cuda
            order.append(smoke.time_ms(torch, lambda fn=fn, a=a: fn(*a)))
        codes, _, _, s, kind = a
        smoke.emit({"part": "segment", "card": card, "shape": label,
                    "n": codes.shape[0], "S": s, "kind": kind,
                    "bound_ms": smoke.segment_bound(a)[0],
                    "parent_ms": [order[0], order[3]],
                    "change_ms": [order[1], order[2]]})
    smoke.emit({"part": "segment", "card": card,
                "launch_floor_ms": smoke.time_ms(
                    torch, lambda: torch.cuda._sleep(0))})


SKIP_FOLD = ("  fold_hist<KIND>(hist, W, acc, ticket, out, &last);",
             "  if (n < 0) fold_hist<KIND>(hist, W, acc, ticket, out, &last);")


def compare_breakdown(torch, smoke, card: str) -> None:
    from caps_tpu_torch.ops import build
    from caps_tpu_torch.ops import segment as S
    src = open(build.SRC_DIR / "segment_agg.cu").read()
    if SKIP_FOLD[0] not in src:
        raise RuntimeError("breakdown: the fold call is not in segment_agg.cu")
    variant = build.BUILD_DIR / "segment_agg_no_fold.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(src.replace(*SKIP_FOLD))
    lib_path = variant.with_suffix(".so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(variant)], check=True)
    no_fold = ctypes.CDLL(str(lib_path))
    this = S._library()
    no_fold.segment_agg.argtypes = this.segment_agg.argtypes
    no_fold.segment_agg.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.zeros(S.MAX_SEGMENTS + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    n = 2_097_152
    for w in (1, 1002, 4096):
        codes = torch.randint(0, w, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        ok = torch.rand(n, generator=gen, device=dev) < 0.8
        out = torch.empty(w, dtype=torch.int32, device=dev)
        blocks, _ = S.segment_geometry(n, w, "count", S._sm_count(dev.index
                                                                  or 0))

        def launch(lib, rows):
            status = lib.segment_agg(
                codes.data_ptr(), ok.data_ptr(), codes.data_ptr(), rows, 0,
                1, 0, w, S.KINDS.index("count"), blocks, state.data_ptr(), 0,
                state.data_ptr() + 4 * S.MAX_SEGMENTS, out.data_ptr(),
                stream)
            if status:
                raise RuntimeError(f"breakdown: CUDA error {status}")
        for rows in (n, 0):
            smoke.emit({"part": "breakdown", "card": card, "S": w,
                        "n": rows, "blocks": blocks,
                        "kernel_ms": smoke.time_ms(
                            torch, lambda: launch(this, rows)),
                        "no_fold_ms": smoke.time_ms(
                            torch, lambda: launch(no_fold, rows))})
    smoke.emit({"part": "breakdown", "card": card,
                "launch_floor_ms": smoke.time_ms(
                    torch, lambda: torch.cuda._sleep(0))})


def compare_expand(torch, smoke, calls, parent_dir: str, card: str) -> None:
    from caps_tpu_torch.ops import expand as X
    old = parent_expand(torch, parent_library(parent_dir,
                                              "expand_positions"))
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


# One tree's slice and unwind phases (and lists, where it has them), run
# from that tree's root.
PHASES_CHILD = """
import argparse, sys
sys.path.insert(0, '.')
import numpy as np
import torch
import chip_smoke as s
from caps_tpu_torch.ops import build
build.build()
card = s.card_line()
args = argparse.Namespace(seed=0, persons=1_000_000, edges=10_000_000)
state = s.run_slice(torch, np, args, card)[3]
s.run_unwind(torch, np, args, card, state)
if hasattr(s, 'run_lists'):
    s.run_lists(torch, np, args, card, state)
print('{"ok": true}', flush=True)
"""


def phases_summary(path: str) -> dict:
    """Per unwind-phase query (and lists-phase query) of one log: cold,
    exact and generic latency, size reads, peak bytes, busy time."""
    out = {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") in ("unwind", "lists"):
            for label, info in d.items():
                if isinstance(info, dict) and "warm_s" in info:
                    prof = info.get("profile_exact_replay", {})
                    out[f"{d['phase']}/{label}"] = {
                        "cold_s": info.get("cold_s"),
                        "warm_s": info["warm_s"],
                        "generic_s": info.get("generic_s"),
                        "size_syncs": info["size_syncs"],
                        "cold_size_syncs": info.get(
                            "cold_run", {}).get("size_syncs"),
                        "peak_mem_bytes": info.get("peak_mem_bytes"),
                        "busy_s": prof.get("device_busy_s"),
                        "idle_share": prof.get("device_idle_share")}
            out[f"{d['phase']}_s"] = d.get("phase_s")
        elif d.get("ok"):
            out["ok"] = True
    return out


def compare_phases(smoke, parent_dir: str, out_dir: str, card: str) -> bool:
    ok = True
    for i, who in enumerate(("parent", "change", "change", "parent"), 1):
        log = os.path.join(out_dir, f"unwind_{i}_{who}.log")
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, "-c", PHASES_CHILD], stdout=f,
                stderr=subprocess.STDOUT, timeout=900,
                cwd=parent_dir if who == "parent" else ROOT).returncode
        ok = ok and rc == 0
        smoke.emit({"part": "unwind", "card": card, "run": i, "tree": who,
                    "rc": rc, "log": os.path.relpath(log, ROOT),
                    **phases_summary(log)})
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the earlier commit")
    ap.add_argument("--out", required=True,
                    help="directory for the chip_smoke.py logs")
    ap.add_argument("--parts", default="expand,segment,breakdown,smoke",
                    help="comma-separated parts to run")
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
    parts = args.parts.split(",")
    if "expand" in parts or "segment" in parts:
        from caps_tpu_torch.ops import build
        build.build()
        run = argparse.Namespace(seed=0, persons=1_000_000,
                                 edges=10_000_000)
        _, _, calls, _ = smoke.run_slice(torch, np, run, card)
        if "expand" in parts:
            compare_expand(torch, smoke, calls, parent_dir, card)
        if "segment" in parts:
            compare_segment(torch, smoke, calls, parent_dir, card)
    if "breakdown" in parts:
        compare_breakdown(torch, smoke, card)
    ok = True
    if "smoke" in parts:
        ok = compare_smoke(smoke, parent_dir, out_dir, card)
    if "unwind" in parts:
        ok = compare_phases(smoke, parent_dir, out_dir, card) and ok
    print(smoke.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

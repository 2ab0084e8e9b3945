"""Phase ``mesh`` of ``chip_smoke.py`` alone, at full size.

Builds the kernels, makes the slice's graph (1,000,000 persons,
10,000,000 edges, ``--seed``) and runs ``chip_smoke.run_mesh``: M1–M8
on a 4-shard mesh, each checked as ``chip_smoke.py`` checks it.  Shard
*i* runs on card *i* where the process sees four cards, else every
shard on card 0 (a virtual mesh).  Prints the phase's JSON lines and
exits non-zero where a check fails.

    python3 chip_mesh.py [--seed 0]
"""
import argparse
import time
import types

import numpy as np
import torch

import chip_smoke as C
from caps_tpu_torch.ops import build


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    if not torch.cuda.is_available():
        raise SystemExit("chip_mesh.py needs a CUDA card")
    card = C.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build()
    C.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    args = types.SimpleNamespace(seed=seed, persons=1_000_000,
                                 edges=10_000_000)
    nodes, rels = C.make_graph(np, args.seed, args.persons, args.edges,
                               C.CITIES)
    launches, _calls = C.run_mesh(torch, np, args, card,
                                  (None, None, nodes, rels, {}))
    C.emit({"launches": launches})
    C.emit({"total_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()

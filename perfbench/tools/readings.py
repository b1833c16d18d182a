"""The readings that a cell's correctness limits are set from (not run by
the benchmark's own runs).

For each seed, in one process: the cell's set-up as a run makes it, a
short window of the cell's own closed loop, and the check's numbers for
the window's sampled answers from

- `program`: what the timed path answered (the lower readings);
- `control`: the plain reference in TF32, put in the program's place
  (reference/cosine_topk.control_topk);
- `control_approx`: the program's own lower-precision path, its approx
  tier (systems/retriever_approx.py: bf16x2 scores with no rerank,
  certificate or fallback), put in the program's place on the same
  batches; the upper readings are the least of the two controls';
- with `--native-tf32` on a card, also the same reference run through
  the card's own TF32 matrix product, as a second witness of the control.

    python3 perfbench/tools/readings.py --workload <cell> \
        --seeds 11,12,13 [--seconds 2] [--native-tf32] [--out file.jsonl]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from perfbench.harness import bench, check, spec  # noqa: E402
from perfbench.reference import cosine_topk  # noqa: E402
from perfbench.systems import retriever_approx  # noqa: E402


def native_tf32_topk(catalog, queries, excl, k, block=128):
    """The reference's float32 cosine with the card's TF32 matrix product."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cat = catalog.to(torch.float32)
        cn = torch.linalg.vector_norm(cat, dim=1)
        q = queries.to(device=cat.device, dtype=torch.float32)
        qn = torch.linalg.vector_norm(q, dim=1)
        excl = excl.to(device=cat.device)
        out_s, out_i = [], []
        for s in range(0, q.shape[0], block):
            sc = cosine_topk._cosine(q[s:s + block], qn[s:s + block], cat, cn)
            v, i = cosine_topk._topk(sc, excl[s:s + block], k)
            out_s.append(v)
            out_i.append(i)
        return torch.cat(out_s), torch.cat(out_i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _as_answers(fn, features, answers, k):
    out = []
    for a in answers:
        s, r = fn(features, torch.from_numpy(a.queries),
                  torch.from_numpy(a.exclude), k)
        out.append(check.Answer(a.queries, a.exclude, s.cpu().numpy(),
                                r.cpu().numpy()))
    return out


def approx_answers(cell: spec.Cell, features, answers, device, k):
    """The approx tier's answers to the batches of `answers`."""
    system = retriever_approx.build(cell.config, features.cpu().numpy(),
                                    device, k)
    return [check.Answer(a.queries, a.exclude,
                         *retriever_approx.call(system, a.queries, a.exclude,
                                                k))
            for a in answers]


def readings(cell: spec.Cell, seed: int, seconds: float, device,
             native: bool) -> dict:
    t0 = time.perf_counter()
    su = bench.set_up(cell, seed, device)
    setup_s = time.perf_counter() - t0
    k = cell.traffic["k"]
    window = su.traffic.run_window(su.call, su.pool, cell.traffic, seconds,
                                   cell.traffic["check_batches"], seed)
    features, sample = su.features, window.sample
    del su
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row = {"workload": cell.name, "seed": seed, "setup_s": setup_s,
           "batches": window.batches, "failed": window.failed,
           "program": check.compare(features, sample, k),
           "control": check.compare(
               features, _as_answers(cosine_topk.control_topk, features,
                                     sample, k), k)}
    row["control_approx"] = check.compare(
        features, approx_answers(cell, features, sample, device, k), k)
    if native and device.type == "cuda":
        row["control_native_tf32"] = check.compare(
            features, _as_answers(native_tf32_topk, features, sample, k), k)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--native-tf32", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also append lines here")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.seconds, device,
                                   args.native_tf32))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell's correctness check: the plain reference in the
program's place, computed one precision below the configuration's, or the
program's own lower-precision path where it has one. Its readings have to
fail the cell's limits, and the limits are set between them and the
program's.

    python3 avbench/control.py --workload <name> --seed <n> [--seed <n> ...] [--fault F]

Training cells: the reference's first steps in the control's precision
('fp8' or 'tf32', `reference.Precision`) against the same steps in float32,
on the inputs and weights a run of that seed makes. Serving cells: the
transcripts of `check_requests` pool clips drawn from the seed, from the
program's int8 reader (`program_quantize`) or from the reference in the
control's precision, against the float32 reference. Prints one JSON line
per seed with the cell's numbers and limits. Needs a CUDA device unless
`--device cpu` is given.

`--fault` reads a fault instead, planted in the float32 reference put in
the program's place: 'half_batch' (a training step's loss over the first
half of its batch, the mean taken over it), 'state_unchanged' (steps that
leave the parameters as they were) or 'altered_token' (each served
transcript's first character changed where it is produced).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class _Ctx:
    def __init__(self, cell, config, seed, device):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device


def train_control(ctx, fault=None) -> dict:
    from avbench.harness import compare, reference
    from avbench.kinds.train import reference_inputs

    cfg, cell = ctx.config, ctx.cell
    params, batches, seed = reference_inputs(ctx)
    block = cell["reference_block_rows"]
    want = reference.train_steps(cfg, params, batches, seed, block_rows=block)
    if fault == "half_batch":
        got = reference.train_steps(cfg, params, batches, seed, block_rows=block,
                                    loss_rows=cell["batch"] // 2)
    elif fault == "state_unchanged":
        got = reference.train_steps(dict(cfg, learning_rate=0.0), params, batches, seed,
                                    block_rows=block)
    else:
        got = reference.train_steps(cfg, params, batches, seed, block_rows=block,
                                    prec=reference.Precision(cell["control"]["precision"]))
    return compare.train_readings(params, got, want)


def serve_control(ctx, fault=None) -> dict:
    import torch

    from avbench.harness import reference, traffic

    from avbench.harness import compare

    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    params = reference.init_params(cfg, traffic.seed_of(ctx.seed, 0), dev)
    pool = traffic.clip_pool(cfg, cell, ctx.seed, dev)
    pick = traffic.sample(cell["pool_clips"], cell["check_requests"], ctx.seed)
    x = reference.model_input(cfg, torch.from_numpy(pool[pick]).to(dev))
    want = reference.logprobs(cfg, params, x)
    control = cell["control"]
    if fault == "altered_token":
        got = want
        texts = [reference.greedy_text(cfg, r) for r in want.cpu().numpy()]
        texts = [("q" if t[:1] != "q" else "r") + t[1:] for t in texts]
    elif "program_quantize" in control:
        from avbench.harness.program import program_config
        from avsync_torch.predictor import LipReader

        reader = LipReader(params=params, config=program_config(cfg, cell["max_batch"], 0),
                           device=dev, quantize=control["program_quantize"],
                           calibration_frames=list(pool[:cell["max_batch"]]))
        B = cell["max_batch"]
        got = torch.cat([reader._logprobs(reader.preprocess_device(pool[pick[i:i + B]])).float()
                         for i in range(0, len(pick), B)])
        texts = reader._decode(got)
    else:
        got = reference.logprobs(cfg, params, x, reference.Precision(control["precision"]))
        texts = [reference.greedy_text(cfg, r) for r in got.cpu().numpy()]
    lp = want.cpu().numpy()
    return {"served_gap": max(reference.transcript_gap(cfg, lp[j], t) for j, t in enumerate(texts)),
            "logprob_gap": compare.token_gap(want, got.to(want.device)),
            "logprob_err": compare.logprob_err(want, got.to(want.device))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--fault", choices=("half_batch", "state_unchanged", "altered_token"),
                   default=None)
    args = p.parse_args(argv)

    import torch

    from avbench.harness import spec

    bench = spec.benchmark()
    entry = spec.workload_entry(bench, args.workload)
    cell, config = spec.workload(args.workload), spec.config(entry["config"])
    if args.device is None and not torch.cuda.is_available():
        print("avbench control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device(args.device or "cuda")
    for seed in args.seed:
        ctx = _Ctx(cell, config, seed, device)
        run = train_control if cell["kind"] == "train" else serve_control
        got = run(ctx, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or cell["control"], "readings": got,
                          "limits": cell["limits"],
                          "fails": any(got[k] > float(v) for k, v in cell["limits"].items())}),
              flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

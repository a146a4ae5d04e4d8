"""Same-card A/B of the port's inference benchmarks across source trees.

Runs ``comet_tpu_torch.bench_lib.run_benchmark``, a profiled forward of the
model it timed (device time, kernel launches, copy kernels' time, the
parameters' dtypes) and ``run_eval_data_benchmark`` at the full ``ours``
configuration on the CUDA card, once per ``--root`` in the order given, each in a fresh process from
that tree (so a parent commit unpacked with ``git archive`` is timed with
its own code), and prints one JSON line per run with the card's name and
power limit. Give the roots in turns to compare two trees within one call:

    python3 tools/torch_bench_ab.py --root .chipwork/parent --root . --root . \\
        --root .chipwork/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from comet_tpu_torch import bench_lib
from comet_tpu_torch.config import get_config
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device")
cfg = get_config("ours")
built, build = [], bench_lib.build_comet
bench_lib.build_comet = lambda *a, **k: built.append(build(*a, **k)) or built[-1]
result = {"run_benchmark": bench_lib.run_benchmark(cfg)}
# the device time and launches of one warm forward of the model run_benchmark timed
model, gen = built[0], torch.Generator(device="cuda").manual_seed(0)
images = torch.randn(1, cfg.seqlen, cfg.img_size, cfg.img_size, 3, generator=gen, device="cuda")
queries = torch.rand(1, cfg.track_num, 2, generator=gen, device="cuda") * (cfg.img_size - 64) + 32
with torch.inference_mode():
    model(images, queries)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(images, queries)
        torch.cuda.synchronize()
kernels = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
result["profiled_forward"] = {
    "parameter_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
    "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
    "launches": sum(e.count for e in kernels),
    "copy_ms": sum(e.self_device_time_total for e in kernels if "copy" in e.key.lower()) / 1e3}
del model, built[:]
result["run_eval_data_benchmark"] = bench_lib.run_eval_data_benchmark(cfg)
print(json.dumps(result))
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", required=True,
                        help="a source tree holding comet_tpu_torch/ (repeatable, run in order)")
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for i, root in enumerate(args.root):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": root})
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "root": os.path.relpath(root), "card": smi, **result}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

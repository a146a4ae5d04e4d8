"""How far each package's f32 square root of a Sobel field lies from the
correctly rounded root, on the CPU, in many fresh processes at once.

Each worker process builds the 64 x 64 scenes of
``tests/test_torch_port_lines.py`` (seeds 0-2), takes the JAX package's
Sobel gradients, and computes sqrt(gx^2 + gy^2) with ``jnp.sqrt``, with
torch's f32 ``torch.sqrt`` and with the port's
``lines.gradient_magnitude``, ``--reps`` times each. Every result is held to
the f64 root rounded once to f32. A worker prints one JSON line: the most
ulps any entry was off per method, and the calls whose largest error was
over 1e-6 of the field's largest value. The parent prints each worker's
line and a summary.

    python tools/torch_sqrt_probe.py [--procs 24] [--parallel 6] [--reps 40]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(np, synthetic_texture, seed, size=64):
    rng = np.random.default_rng(seed)
    img = 0.3 * synthetic_texture(rng, size, size)[..., 0]
    for _ in range(3):
        y0, x0 = rng.integers(4, size // 2), rng.integers(4, size // 2)
        img[y0:y0 + rng.integers(12, size // 2), x0:x0 + rng.integers(12, size // 2)] = (
            rng.uniform(0.5, 1.0))
    img[size // 2:size // 2 + 3, 6:size - 6] = 0.9
    return img.astype(np.float32)


def worker(reps):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from comet_tpu.matching import lines as jlines
    from comet_tpu_torch.matching import lines as tlines
    from comet_tpu_torch.matching.benchmarks import synthetic_texture

    ulps = {"jnp.sqrt": 0, "torch.sqrt": 0, "gradient_magnitude": 0}
    over = []
    for rep in range(reps):
        for seed in (0, 1, 2):
            gx, gy = jlines.image_gradients(jnp.asarray(_scene(np, synthetic_texture, seed)))
            a, b = np.asarray(gx), np.asarray(gy)
            ref = np.sqrt((a * a + b * b).astype(np.float64)).astype(np.float32)
            ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
            got = {"jnp.sqrt": np.asarray(jnp.sqrt(gx * gx + gy * gy)),
                   "torch.sqrt": torch.sqrt(ta * ta + tb * tb).numpy(),
                   "gradient_magnitude": tlines.gradient_magnitude(ta, tb).numpy()}
            for name, g in got.items():
                off = np.abs(g.view(np.int32).astype(np.int64) - ref.view(np.int32))
                ulps[name] = max(ulps[name], int(off.max()))
                rel = float(np.abs(g.astype(np.float64) - ref).max() / ref.max())
                if rel > 1e-6:
                    over.append({"rep": rep, "seed": seed, "method": name, "rel": rel})
    print(json.dumps({"pid": os.getpid(), "max_ulps": ulps, "calls_over_1e-6": over}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=24)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.reps)
        return
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--reps", str(args.reps)]
    lines, left = [], args.procs
    while left:
        batch = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                  text=True) for _ in range(min(left, args.parallel))]
        left -= len(batch)
        for p in batch:
            out, _ = p.communicate(timeout=600)
            lines.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(lines[-1]), flush=True)
    worst = {k: max(r["max_ulps"][k] for r in lines) for k in lines[0]["max_ulps"]}
    print(json.dumps({"processes": len(lines), "calls_per_method": 3 * args.reps * len(lines),
                      "max_ulps": worst,
                      "calls_over_1e-6": sum(len(r["calls_over_1e-6"]) for r in lines)}))


if __name__ == "__main__":
    main()

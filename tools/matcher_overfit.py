"""Overfit one fixed batch with a matcher's train step and print the loss curve.

Does the port's matcher training learn? This drives ``match --train``'s step
(``matching.train.build_matcher_train_step``, Adam) on one batch, the same
batch every step, and prints one JSON line: the device, the steps, and the
loss after each.

    # the batch and the matcher's initial weights, made on the CPU from a seed
    python tools/matcher_overfit.py --make-batch batch.pt [--experiment E]
        [--batch-size 4] [--image-size 480] [--seed 0]
    # the curve on a device (the card, or the CPU)
    python tools/matcher_overfit.py --batch batch.pt --device cuda --steps 120 [--lr 1e-4]
    # the JAX package's curve on the CPU (where JAX is installed), the same
    # weights through weights.module_params_to_jax, optax.adam, its jitted step
    python tools/matcher_overfit.py --batch batch.pt --jax --steps 10

The batch is made once and carried between machines, so both devices
train from the same keypoints, labels and weights (the experiment's matcher
at its own width: LightGlue at depth 9, width 256). Matmuls run in f32
(TF32 off) on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_batch(path, experiment, batch_size, image_size, seed):
    import numpy as np
    import torch

    from comet_tpu_torch import cli
    from comet_tpu_torch.matching import configs, train
    from comet_tpu_torch.matching.registry import get_model

    conf = configs.get_experiment(experiment)
    tb = conf["train"]
    ext_conf = dict(conf["extractor"])
    extractor = get_model(ext_conf.pop("name"), **ext_conf)
    mat_conf = dict(conf["matcher"])
    batch = train.make_homography_training_batch(
        extractor, np.random.default_rng(seed), batch_size=batch_size,
        image_hw=(image_size, image_size), difficulty=tb["homography"]["difficulty"],
        max_angle=tb["homography"]["max_angle"], th_positive=conf["ground_truth"]["th_positive"],
        th_negative=conf["ground_truth"]["th_negative"], device="cpu")
    module = cli._init_matcher(get_model(mat_conf.pop("name"), **mat_conf),
                               batch["desc0"].shape[-1], seed)
    torch.save({"experiment": experiment, "batch": batch, "weights": module.state_dict()}, path)
    print(json.dumps({"batch": path, "experiment": experiment,
                      "shapes": {k: list(v.shape) for k, v in batch.items()},
                      "matched": int((batch["gt0"] >= 0).sum())}))


def run(path, device, steps, lr):
    import torch

    from comet_tpu_torch.matching import configs, train
    from comet_tpu_torch.matching.registry import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = torch.load(path, weights_only=False)
    mat_conf = dict(configs.get_experiment(saved["experiment"])["matcher"])
    module = get_model(mat_conf.pop("name"), **mat_conf)
    module = type(module)(**module.conf, in_dim=saved["batch"]["desc0"].shape[-1])
    module.load_state_dict(saved["weights"])
    dev = torch.device(device)
    module = module.to(dev).train()
    batch = {k: v.to(dev) for k, v in saved["batch"].items()}
    opt = train.make_adam(module, lr)
    step = train.build_matcher_train_step()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(float(step(module, opt, batch)))
    print(json.dumps({"device": str(dev), "experiment": saved["experiment"], "lr": lr,
                      "steps": steps, "seconds": round(time.perf_counter() - t0, 1),
                      "losses": losses}))


def run_jax(path, steps, lr):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch

    from comet_tpu.matching import lightglue as jlg
    from comet_tpu.matching import train as jtrain
    from comet_tpu_torch.matching import configs
    from comet_tpu_torch.matching.registry import get_model
    from comet_tpu_torch.weights import module_params_to_jax

    saved = torch.load(path, weights_only=False)
    mat_conf = dict(configs.get_experiment(saved["experiment"])["matcher"])
    module = get_model(mat_conf.pop("name"), **mat_conf)
    module = type(module)(**module.conf, in_dim=saved["batch"]["desc0"].shape[-1])
    module.load_state_dict(saved["weights"])
    params = jax.tree_util.tree_map(jnp.asarray, module_params_to_jax(module))
    tx = optax.adam(lr)
    step = jtrain.build_matcher_train_step(jlg.LightGlueMatcher(**module.conf), tx)
    batch = {k: jnp.asarray(v.numpy()) for k, v in saved["batch"].items()}
    state, losses = tx.init(params), []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    print(json.dumps({"device": "jax cpu", "experiment": saved["experiment"], "lr": lr,
                      "steps": steps, "seconds": round(time.perf_counter() - t0, 1),
                      "losses": losses}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--make-batch", metavar="PATH")
    p.add_argument("--batch", metavar="PATH")
    p.add_argument("--experiment", default="superpoint+lightglue_homography")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--image-size", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--jax", action="store_true", help="the JAX package's step, on the CPU")
    args = p.parse_args(argv)
    if args.make_batch:
        make_batch(args.make_batch, args.experiment, args.batch_size, args.image_size, args.seed)
    elif args.jax:
        run_jax(args.batch, args.steps, args.lr)
    else:
        run(args.batch, args.device, args.steps, args.lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

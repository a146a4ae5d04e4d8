"""Convert a checkpoint of the JAX package to the file the PyTorch port reads.

``comet_tpu/training/checkpoints.py::save_checkpoint`` writes a
``ckpt_NNNNNN`` directory with orbax's ``StandardCheckpointer``: an OCDBT
store whose nodes and data are zstd-compressed, which the port does not
read (``comet_tpu_torch/training/checkpoints.py`` says why). Run where JAX,
flax and orbax are installed, this tool restores each directory's tree on
the host's CPU (shapes and dtypes from the checkpoint's own metadata, so a
checkpoint saved on another device layout converts as well) and writes it
beside orbax's files as ``ckpt_NNNNNN/state.msgpack``, in flax's msgpack
layout (``flax.serialization.msgpack_serialize``): optax's named tuples as
maps of their fields, a tuple as ``{"0": ..., "1": ...}``, an empty state
or a masked-out leaf as ``{}``, an array over 1 GiB in flax's chunked form.
The port's ``training.restore_checkpoint`` and ``auto_resume`` (and its
``cli.py train``, whose ``--output-dir``'s ``ckpt/`` holds such directories)
then resume the run.

    python tools/orbax_to_msgpack.py CKPT_DIR [CKPT_DIR ...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

STATE_FILE = "state.msgpack"


def flax_layout(tree):
    """An orbax tree restored without its Python types (dicts, lists, None)
    in the layout ``flax.serialization.to_state_dict`` gives the original."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {str(k): flax_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): flax_layout(v) for i, v in enumerate(tree)}
    return np.asarray(tree)


def convert(path: str) -> str:
    """Write ``path/state.msgpack`` from the orbax checkpoint in ``path``;
    returns the file's path."""
    import jax
    import orbax.checkpoint as ocp
    from flax import serialization

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path).item_metadata
    meta = getattr(meta, "tree", meta)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu)
        if hasattr(m, "shape") else m, meta)
    tree = flax_layout(ckptr.restore(path, target))
    out = os.path.join(path, STATE_FILE)
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    os.replace(tmp, out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ckpt_dirs", nargs="+", help="ckpt_NNNNNN directories orbax wrote")
    args = parser.parse_args(argv)
    for path in args.ckpt_dirs:
        out = convert(path)
        print(f"{out}: {os.path.getsize(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Convert the reference's torch checkpoints to flax params, without JAX.

Counterpart of ``tools/convert_torch_weights.py``, which builds its template
with ``jax.eval_shape`` of the JAX COMET; this module takes the template from
the port's own modules (``weights.flax_template`` of a ``device="meta"``
COMET) and writes the same flax ``.msgpack`` with the port's writer
(``utils.serialization.save_params_msgpack``), so a machine without JAX
turns a released checkpoint into a file that ``cli.py --checkpoint``,
``serving.params_from_msgpack`` and the JAX package all read:

  python -m comet_tpu_torch.utils.convert_torch_weights --bin ckpt/best.bin \\
      --preset ours --out weights/best.msgpack
  python -m comet_tpu_torch.cli eval --checkpoint weights/best.msgpack ...

The reference checkpoints hold a single state_dict over the module tree
  track_predictor.{coarse_fnet,coarse_predictor,fine_fnet,fine_predictor}.*
  camera_predictor.{backbone,input_transform,self_att,cross_att,
                    cross_attn_block,trunk,traj_encoder,confidence_attention,
                    pose_branch,fc_translation2d,fc_depth,pose_token}.*
(comet/models/E2Epose2.py module layout; a leading "module." DDP prefix is
stripped like load_model_weights does, train_util.py:181-200).

Layout transforms:
  torch Conv2d  [out, in, kh, kw] -> flax [kh, kw, in, out]
  torch Linear  [out, in]         -> flax [in, out]
  nn.MultiheadAttention packed in_proj [3E, E] -> [E, 3E]
  DINOv2 fused qkv stays fused (the ViT uses a fused qkv Dense)
  DINOv2 pos_embed [1, 1+37*37, C] -> cls pos + patch grid resampled to the
  target grid with torch's own bicubic interpolation on the CPU (exact
  parity with dinov2's interpolate_pos_encoding), then re-assembled.

``convert_lightglue`` maps an official LightGlue checkpoint onto the flax
variables of ``matching.lightglue.LightGlueMatcher`` and
``convert_superpoint`` MagicLeap's ``superpoint_v1.pth`` onto those of
``models.superpoint.SuperPointBackbone`` (templates:
``weights.module_params_to_jax`` of the port's module). The flax tree then
reaches a model through the one weight bridge, ``weights.params_from_jax``
(or ``module_params_from_jax``).

Run with --self-test to verify the mapping covers every flax leaf of the
five presets at full width using a synthetic state_dict (no real checkpoint
needed).
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

PRESETS = ("ours", "abl_all", "abl_track", "abl_time", "abl_uvz")


# ---------------------------------------------------------------------------
# primitive transforms
# ---------------------------------------------------------------------------

def t_conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t_linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def t_none(w):
    return np.asarray(w)


# ---------------------------------------------------------------------------
# mapping construction: flax path -> (torch key, transform)
# ---------------------------------------------------------------------------

def _mha(flax_prefix: str, torch_prefix: str) -> Dict:
    """torch nn.MultiheadAttention -> the port's MultiHeadAttention in flax
    layout. Both store qkv PACKED in torch's in_proj layout ([3E, E] rows
    q|k|v), so the kernel converts with a plain transpose."""
    return {
        f"{flax_prefix}/in_proj_kernel": (f"{torch_prefix}.in_proj_weight", t_linear),
        f"{flax_prefix}/in_proj_bias": (f"{torch_prefix}.in_proj_bias", t_none),
        f"{flax_prefix}/out_proj/kernel": (f"{torch_prefix}.out_proj.weight", t_linear),
        f"{flax_prefix}/out_proj/bias": (f"{torch_prefix}.out_proj.bias", t_none),
    }


def _mlp(flax_prefix: str, torch_prefix: str) -> Dict:
    return {
        f"{flax_prefix}/fc1/kernel": (f"{torch_prefix}.fc1.weight", t_linear),
        f"{flax_prefix}/fc1/bias": (f"{torch_prefix}.fc1.bias", t_none),
        f"{flax_prefix}/fc2/kernel": (f"{torch_prefix}.fc2.weight", t_linear),
        f"{flax_prefix}/fc2/bias": (f"{torch_prefix}.fc2.bias", t_none),
    }


def _attn_block(flax_prefix: str, torch_prefix: str) -> Dict:
    out = _mha(f"{flax_prefix}/attn", f"{torch_prefix}.attn")
    out.update(_mlp(f"{flax_prefix}/mlp", f"{torch_prefix}.mlp"))
    return out


def _cross_attn_block(flax_prefix: str, torch_prefix: str) -> Dict:
    out = _mha(f"{flax_prefix}/cross_attn", f"{torch_prefix}.cross_attn")
    out.update(_mlp(f"{flax_prefix}/mlp", f"{torch_prefix}.mlp"))
    out[f"{flax_prefix}/norm_context/scale"] = (f"{torch_prefix}.norm_context.weight", t_none)
    out[f"{flax_prefix}/norm_context/bias"] = (f"{torch_prefix}.norm_context.bias", t_none)
    return out


def _residual_block(flax_prefix: str, torch_prefix: str, has_downsample: bool) -> Dict:
    out = {
        f"{flax_prefix}/conv1/kernel": (f"{torch_prefix}.conv1.weight", t_conv),
        f"{flax_prefix}/conv1/bias": (f"{torch_prefix}.conv1.bias", t_none),
        f"{flax_prefix}/conv2/kernel": (f"{torch_prefix}.conv2.weight", t_conv),
        f"{flax_prefix}/conv2/bias": (f"{torch_prefix}.conv2.bias", t_none),
    }
    if has_downsample:
        out[f"{flax_prefix}/downsample/kernel"] = (f"{torch_prefix}.downsample.0.weight", t_conv)
        out[f"{flax_prefix}/downsample/bias"] = (f"{torch_prefix}.downsample.0.bias", t_none)
    return out


def _basic_encoder(flax_prefix: str, torch_prefix: str) -> Dict:
    out = {}
    for conv in ("conv1", "conv2", "conv3"):
        out[f"{flax_prefix}/{conv}/kernel"] = (f"{torch_prefix}.{conv}.weight", t_conv)
        out[f"{flax_prefix}/{conv}/bias"] = (f"{torch_prefix}.{conv}.bias", t_none)
    # layers 1-4, each = Sequential(ResidualBlock(stride s), ResidualBlock(1))
    for li, s in {1: 1, 2: 2, 3: 2, 4: 2}.items():
        out.update(_residual_block(f"{flax_prefix}/layer{li}_0", f"{torch_prefix}.layer{li}.0",
                                   has_downsample=(s != 1)))
        out.update(_residual_block(f"{flax_prefix}/layer{li}_1", f"{torch_prefix}.layer{li}.1",
                                   has_downsample=False))
    return out


def _shallow_encoder(flax_prefix: str, torch_prefix: str) -> Dict:
    out = {}
    for conv in ("conv1", "conv2"):
        out[f"{flax_prefix}/{conv}/kernel"] = (f"{torch_prefix}.{conv}.weight", t_conv)
        out[f"{flax_prefix}/{conv}/bias"] = (f"{torch_prefix}.{conv}.bias", t_none)
    # layer1/layer2 are single ResidualBlocks with stride 2 (downsample)
    out.update(_residual_block(f"{flax_prefix}/layer1", f"{torch_prefix}.layer1", True))
    out.update(_residual_block(f"{flax_prefix}/layer2", f"{torch_prefix}.layer2", True))
    return out


def _update_former(flax_prefix: str, torch_prefix: str, time_depth: int,
                   space_depth: int) -> Dict:
    out = {
        f"{flax_prefix}/input_transform/kernel": (
            f"{torch_prefix}.input_transform.weight", t_linear),
        f"{flax_prefix}/input_transform/bias": (f"{torch_prefix}.input_transform.bias", t_none),
        f"{flax_prefix}/flow_head/kernel": (f"{torch_prefix}.flow_head.weight", t_linear),
        f"{flax_prefix}/flow_head/bias": (f"{torch_prefix}.flow_head.bias", t_none),
    }
    if space_depth > 0:
        # note the reference's typo "virual_tracks" (blocks.py:235)
        out[f"{flax_prefix}/virtual_tracks"] = (f"{torch_prefix}.virual_tracks", t_none)
    for i in range(time_depth):
        out.update(_attn_block(f"{flax_prefix}/time_blocks_{i}",
                               f"{torch_prefix}.time_blocks.{i}"))
    for j in range(space_depth):
        out.update(_attn_block(f"{flax_prefix}/space_virtual_blocks_{j}",
                               f"{torch_prefix}.space_virtual_blocks.{j}"))
        out.update(_cross_attn_block(f"{flax_prefix}/space_point2virtual_blocks_{j}",
                                     f"{torch_prefix}.space_point2virtual_blocks.{j}"))
        out.update(_cross_attn_block(f"{flax_prefix}/space_virtual2point_blocks_{j}",
                                     f"{torch_prefix}.space_virtual2point_blocks.{j}"))
    return out


def _tracker(flax_prefix: str, torch_prefix: str, time_depth: int, space_depth: int,
             fine: bool) -> Dict:
    out = _update_former(f"{flax_prefix}/updateformer", f"{torch_prefix}.updateformer",
                         time_depth, space_depth)
    out[f"{flax_prefix}/ffeat_norm/scale"] = (f"{torch_prefix}.norm.weight", t_none)
    out[f"{flax_prefix}/ffeat_norm/bias"] = (f"{torch_prefix}.norm.bias", t_none)
    out[f"{flax_prefix}/ffeat_updater/kernel"] = (
        f"{torch_prefix}.ffeat_updater.0.weight", t_linear)
    out[f"{flax_prefix}/ffeat_updater/bias"] = (f"{torch_prefix}.ffeat_updater.0.bias", t_none)
    if not fine:
        out[f"{flax_prefix}/vis_predictor/kernel"] = (
            f"{torch_prefix}.vis_predictor.0.weight", t_linear)
        out[f"{flax_prefix}/vis_predictor/bias"] = (
            f"{torch_prefix}.vis_predictor.0.bias", t_none)
    return out


def _vit(flax_prefix: str, torch_prefix: str, depth: int = 12, target_grid: int = 24) -> Dict:
    def resample_pos_embed(w):
        """DINOv2 pos_embed [1, 1+G0^2, C] -> [1, 1+target^2, C] via torch
        bicubic (antialias=False) on the CPU, exactly like
        interpolate_pos_encoding."""
        w = np.asarray(w)
        cls_pos, patch_pos = w[:, :1], w[:, 1:]
        g0 = int(round(patch_pos.shape[1] ** 0.5))
        if g0 == target_grid:
            return w
        t = torch.from_numpy(patch_pos.reshape(1, g0, g0, -1)).permute(0, 3, 1, 2)
        t = F.interpolate(t, (target_grid, target_grid), mode="bicubic", antialias=False)
        patch = t.permute(0, 2, 3, 1).reshape(1, target_grid * target_grid, -1).numpy()
        return np.concatenate([cls_pos, patch], axis=1)

    out = {
        f"{flax_prefix}/patch_embed/kernel": (f"{torch_prefix}.patch_embed.proj.weight", t_conv),
        f"{flax_prefix}/patch_embed/bias": (f"{torch_prefix}.patch_embed.proj.bias", t_none),
        f"{flax_prefix}/cls_token": (f"{torch_prefix}.cls_token", t_none),
        f"{flax_prefix}/register_tokens": (f"{torch_prefix}.register_tokens", t_none),
        f"{flax_prefix}/pos_embed": (f"{torch_prefix}.pos_embed", resample_pos_embed),
        f"{flax_prefix}/norm/scale": (f"{torch_prefix}.norm.weight", t_none),
        f"{flax_prefix}/norm/bias": (f"{torch_prefix}.norm.bias", t_none),
    }
    for i in range(depth):
        bp, fp = f"{torch_prefix}.blocks.{i}", f"{flax_prefix}/blocks_{i}"
        for norm in ("norm1", "norm2"):
            out[f"{fp}/{norm}/scale"] = (f"{bp}.{norm}.weight", t_none)
            out[f"{fp}/{norm}/bias"] = (f"{bp}.{norm}.bias", t_none)
        for flax_lin, torch_lin in (("attn/qkv", "attn.qkv"), ("attn/proj", "attn.proj")):
            out[f"{fp}/{flax_lin}/kernel"] = (f"{bp}.{torch_lin}.weight", t_linear)
            out[f"{fp}/{flax_lin}/bias"] = (f"{bp}.{torch_lin}.bias", t_none)
        out[f"{fp}/ls1/gamma"] = (f"{bp}.ls1.gamma", t_none)
        out[f"{fp}/ls2/gamma"] = (f"{bp}.ls2.gamma", t_none)
        for flax_lin, torch_lin in (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            out[f"{fp}/{flax_lin}/kernel"] = (f"{bp}.{torch_lin}.weight", t_linear)
            out[f"{fp}/{flax_lin}/bias"] = (f"{bp}.{torch_lin}.bias", t_none)
    return out


def _camera_predictor(flax_prefix: str, torch_prefix: str, cfg) -> Dict:
    cam = cfg.camera
    out = _vit(f"{flax_prefix}/backbone", f"{torch_prefix}.backbone",
               target_grid=cam.down_size // 14)
    out.update(_mlp(f"{flax_prefix}/input_transform", f"{torch_prefix}.input_transform"))
    out[f"{flax_prefix}/pose_token"] = (f"{torch_prefix}.pose_token", t_none)
    for i in range(cam.att_depth):
        out.update(_attn_block(f"{flax_prefix}/self_att_{i}", f"{torch_prefix}.self_att.{i}"))
        out.update(_cross_attn_block(f"{flax_prefix}/cross_att_{i}",
                                     f"{torch_prefix}.cross_att.{i}"))
    if cam.use_trajectory:
        for i in range(cam.att_depth):
            out.update(_cross_attn_block(f"{flax_prefix}/cross_attn_block_{i}",
                                         f"{torch_prefix}.cross_attn_block.{i}"))
        te, tt = f"{flax_prefix}/traj_encoder", f"{torch_prefix}.traj_encoder.mlp"
        for flax_name, idx, tf in (("fc1", 0, t_linear), ("ln1", 1, t_none),
                                   ("fc2", 3, t_linear), ("ln2", 4, t_none)):
            weight = "kernel" if tf is t_linear else "scale"
            out[f"{te}/{flax_name}/{weight}"] = (f"{tt}.{idx}.weight", tf)
            out[f"{te}/{flax_name}/bias"] = (f"{tt}.{idx}.bias", t_none)
        ca, ct = f"{flax_prefix}/confidence_attention", f"{torch_prefix}.confidence_attention"
        for flax_name, idx in (("fc1", 0), ("fc2", 2)):
            out[f"{ca}/{flax_name}/kernel"] = (f"{ct}.{idx}.weight", t_linear)
            out[f"{ca}/{flax_name}/bias"] = (f"{ct}.{idx}.bias", t_none)
    if cam.use_time:
        for i in range(cam.trunk_depth):
            out.update(_attn_block(f"{flax_prefix}/trunk_{i}", f"{torch_prefix}.trunk.{i}"))
    out.update(_mlp(f"{flax_prefix}/pose_branch", f"{torch_prefix}.pose_branch"))
    if cam.use_gapr:
        for head in ("fc_translation2d", "fc_depth"):
            out[f"{flax_prefix}/{head}/kernel"] = (f"{torch_prefix}.{head}.weight", t_linear)
            out[f"{flax_prefix}/{head}/bias"] = (f"{torch_prefix}.{head}.bias", t_none)
    return out


def build_mapping(cfg) -> Dict:
    """Full flax-path -> (torch key, transform) mapping for a preset."""
    tc = cfg.tracker
    mapping = {}
    mapping.update(_basic_encoder("coarse_fnet", "track_predictor.coarse_fnet"))
    mapping.update(_tracker("coarse_tracker", "track_predictor.coarse_predictor",
                            tc.coarse_depth, tc.coarse_depth, fine=False))
    mapping.update(_shallow_encoder("fine_fnet", "track_predictor.fine_fnet"))
    mapping.update(_tracker("fine_tracker", "track_predictor.fine_predictor",
                            tc.fine_depth, 0, fine=True))
    mapping.update(_camera_predictor("camera_predictor", "camera_predictor", cfg))
    return mapping


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    out = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def comet_template(cfg):
    """The flax variables of ``cfg``'s COMET as the JAX package initialises
    them (paths, shapes and f32 dtypes; every leaf a zero view that holds no
    memory), from a ``device="meta"`` port model: ``{"params": tree}``."""
    from ..models.comet import build_comet
    from ..weights import flax_template

    return flax_template(build_comet(cfg, device="meta"))


def _numpy_state_dict(state_dict: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """The state dict's arrays (sharing the tensors' memory) under their
    keys with ``prefix`` (a regex) stripped."""
    return {re.sub(prefix, "", k): v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in state_dict.items()}


def _leaf(tf, value, tmpl, path):
    """``tf(value)`` in the template leaf's dtype, C-ordered (a copy only
    where the layout or the dtype changes), or a ValueError naming ``path``."""
    arr = np.asarray(tf(value), dtype=tmpl.dtype, order="C")
    if arr.shape != tmpl.shape:
        raise ValueError(f"shape mismatch for {path}: got {arr.shape}, want {tmpl.shape}")
    return arr


def _check_strict(missing, unmapped) -> None:
    msg = []
    if missing:
        msg.append(f"missing torch keys for {len(missing)} leaves: {missing[:5]}")
    if unmapped:
        msg.append(f"no mapping for {len(unmapped)} flax leaves: {unmapped[:5]}")
    raise KeyError("; ".join(msg))


def convert(state_dict: Dict, template_params, cfg, strict=True):
    """state_dict (torch tensors or numpy) -> flax params pytree, with the
    lists of missing (flax path, torch key) pairs and unmapped flax paths."""
    # strip DDP "module." prefix (train_util.py:181-200)
    sd = _numpy_state_dict(state_dict, r"^module\.")
    mapping = build_mapping(cfg)
    flat = flatten_params(template_params["params"])
    new_flat = {}
    missing, unmapped = [], []
    for path, tmpl in flat.items():
        tmpl = np.asarray(tmpl)
        if path in mapping:
            tk, tf = mapping[path]
            if tk in sd:
                new_flat[path] = _leaf(tf, sd[tk], tmpl, path)
                continue
            missing.append((path, tk))
        else:
            unmapped.append(path)
        new_flat[path] = np.array(tmpl)
    if strict and (missing or unmapped):
        _check_strict(missing, unmapped)
    return {"params": unflatten_params(new_flat)}, missing, unmapped


def build_lightglue_mapping(depth: int) -> Dict:
    """flax path -> (torch key, transform) for the official LightGlue
    checkpoint layout (gluefactory/models/matchers/lightglue.py:330-384
    after its own self_attn.{i}/cross_attn.{i} -> transformers.{i}.*
    renames). ``input_proj`` is absent from checkpoints whose input_dim ==
    descriptor_dim (torch uses nn.Identity there); :func:`convert_lightglue`
    seeds an identity kernel instead."""
    out = {
        "posenc/Wr/kernel": ("posenc.Wr.weight", t_linear),
        "input_proj/kernel": ("input_proj.weight", t_linear),
        "input_proj/bias": ("input_proj.bias", t_none),
    }
    for i in range(depth):
        for blk, names in (("self_attn", ("Wqkv", "out_proj")),
                           ("cross_attn", ("to_qk", "to_v", "to_out"))):
            fp, tp = f"transformers_{i}/{blk}", f"transformers.{i}.{blk}"
            for lin in names:
                out[f"{fp}/{lin}/kernel"] = (f"{tp}.{lin}.weight", t_linear)
                out[f"{fp}/{lin}/bias"] = (f"{tp}.{lin}.bias", t_none)
            # ffn Sequential: 0=Linear(2d,2d), 1=LayerNorm, 3=Linear(2d,d)
            out[f"{fp}/ffn_lin1/kernel"] = (f"{tp}.ffn.0.weight", t_linear)
            out[f"{fp}/ffn_lin1/bias"] = (f"{tp}.ffn.0.bias", t_none)
            out[f"{fp}/ffn_norm/scale"] = (f"{tp}.ffn.1.weight", t_none)
            out[f"{fp}/ffn_norm/bias"] = (f"{tp}.ffn.1.bias", t_none)
            out[f"{fp}/ffn_lin2/kernel"] = (f"{tp}.ffn.3.weight", t_linear)
            out[f"{fp}/ffn_lin2/bias"] = (f"{tp}.ffn.3.bias", t_none)
        for lin in ("matchability", "final_proj"):
            out[f"log_assignment_{i}/{lin}/kernel"] = (
                f"log_assignment.{i}.{lin}.weight", t_linear)
            out[f"log_assignment_{i}/{lin}/bias"] = (f"log_assignment.{i}.{lin}.bias", t_none)
        if i < depth - 1:
            out[f"token_confidence_{i}/token/kernel"] = (
                f"token_confidence.{i}.token.0.weight", t_linear)
            out[f"token_confidence_{i}/token/bias"] = (
                f"token_confidence.{i}.token.0.bias", t_none)
    return out


def convert_lightglue(state_dict: Dict, template_params, depth: int = 9,
                      strict: bool = True):
    """Official LightGlue checkpoint (or any torch state_dict of the
    reference architecture) -> ``matching.lightglue.LightGlueMatcher``'s
    flax variables (template: ``weights.module_params_to_jax`` of one), with
    the missing and unmapped lists.

    Handles the "module." / "model." / "matcher." prefixes, the release
    renames (self_attn.{i} -> transformers.{i}.self_attn,
    lightglue.py:378-384) and the Identity input_proj of checkpoints with
    input_dim == descriptor_dim (seeded with an identity kernel and a zero
    bias)."""
    sd = {}
    for k, v in _numpy_state_dict(state_dict, r"^(module|model|matcher)\.").items():
        k = re.sub(r"^self_attn\.(\d+)\.", r"transformers.\1.self_attn.", k)
        sd[re.sub(r"^cross_attn\.(\d+)\.", r"transformers.\1.cross_attn.", k)] = v
    mapping = build_lightglue_mapping(depth)
    flat = flatten_params(template_params["params"])
    new_flat = {}
    missing, unmapped = [], []
    for path, tmpl in flat.items():
        tmpl = np.asarray(tmpl)
        if path not in mapping:
            unmapped.append(path)
            new_flat[path] = tmpl
            continue
        tk, tf = mapping[path]
        if tk in sd:
            new_flat[path] = _leaf(tf, sd[tk], tmpl, path)
        elif path == "input_proj/kernel" and tmpl.shape[0] == tmpl.shape[1]:
            new_flat[path] = np.eye(tmpl.shape[0], dtype=tmpl.dtype)
        elif path == "input_proj/bias":
            new_flat[path] = np.zeros_like(tmpl)
        else:
            missing.append((path, tk))
            new_flat[path] = tmpl
    if strict and (missing or unmapped):
        _check_strict(missing, unmapped)
    return {"params": unflatten_params(new_flat)}, missing, unmapped


SUPERPOINT_LAYERS = (
    "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
    "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb",
)


def convert_superpoint(state_dict: Dict, template_params):
    """MagicLeap superpoint_v1.pth / gluefactory_nonfree SuperPoint
    state_dict -> ``models.superpoint.SuperPointBackbone``'s flax variables
    (template: ``weights.module_params_to_jax`` of one).

    Layer names match 1:1 (gluefactory_nonfree/superpoint.py:179-194);
    conv kernels transpose OIHW -> HWIO. Keys may carry a "model." or
    "module." prefix (torch hub / DDP checkpoints). A layer the template or
    the state dict lacks raises KeyError, a shape that differs ValueError."""
    sd = _numpy_state_dict(state_dict, r"^(module|model)\.")
    flat = flatten_params(template_params["params"])
    new_flat = {}
    for name in SUPERPOINT_LAYERS:
        for leaf, tk, tf in ((f"{name}/kernel", f"{name}.weight", t_conv),
                             (f"{name}/bias", f"{name}.bias", t_none)):
            if leaf not in flat:
                raise KeyError(f"template has no leaf {leaf}")
            if tk not in sd:
                raise KeyError(f"state_dict has no key {tk}")
            new_flat[leaf] = _leaf(tf, sd[tk], np.asarray(flat[leaf]), leaf)
    return {"params": unflatten_params(new_flat)}


def self_test(preset: str = "ours"):
    """Verify the mapping covers every flax leaf of the preset at full width,
    using a synthetic state_dict generated from the mapping itself."""
    from ..config import get_config

    cfg = get_config(preset)
    params = comet_template(cfg)
    mapping = build_mapping(cfg)
    flat = flatten_params(params["params"])

    fake_sd = {}
    rng = np.random.default_rng(0)
    for path, tmpl in flat.items():
        if path not in mapping:
            print(f"UNMAPPED flax leaf: {path}")
            continue
        tk, tf = mapping[path]
        if tk in fake_sd:
            continue
        # a torch-side tensor whose transform has the template's shape, by
        # inverting the known layout rules
        shape = tmpl.shape
        if tf is t_conv:
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif tf is t_linear:
            shape = (shape[1], shape[0])
        elif tk.endswith("pos_embed"):
            shape = (1, 1 + 37 * 37, shape[-1])
        fake_sd[tk] = rng.standard_normal(shape, dtype=np.float32)

    converted, missing, unmapped = convert(fake_sd, params, cfg, strict=False)
    n_total = len(flat)
    print(f"self-test[{preset}]: {n_total - len(missing) - len(unmapped)}/{n_total} "
          f"leaves mapped, {len(missing)} missing, {len(unmapped)} unmapped")
    for m in missing[:10]:
        print("  missing:", m)
    for u in unmapped[:10]:
        print("  unmapped:", u)
    return len(missing) == 0 and len(unmapped) == 0


def load_reference(path: str) -> Dict:
    """``torch.load`` of a reference checkpoint as the tool loads it (on the
    CPU, torch's default ``weights_only``), its ``{"model": sd}`` wrapper
    unwrapped. A file torch refuses raises naming it; nothing falls back to
    unsafe loading."""
    try:
        sd = torch.load(path, map_location="cpu")
    except OSError:
        raise
    except Exception as e:
        raise ValueError(f"{path}: torch.load refused the checkpoint ({type(e).__name__}: "
                         f"{e})") from e
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bin", help="torch checkpoint (.bin) path")
    ap.add_argument("--preset", default="ours")
    ap.add_argument("--out", help="output .msgpack path")
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--non-strict", action="store_true")
    args = ap.parse_args(argv)

    if args.self_test:
        ok = all(self_test(p) for p in PRESETS)
        sys.exit(0 if ok else 1)

    from ..config import get_config
    from .serialization import save_params_msgpack

    cfg = get_config(args.preset)
    # the loaded tensors are dropped with convert's return: the tree keeps
    # only the leaves it shares with them, and the writer streams
    converted, missing, unmapped = convert(load_reference(args.bin), comet_template(cfg), cfg,
                                           strict=not args.non_strict)
    save_params_msgpack(args.out, converted)
    print(f"wrote {args.out} ({len(missing)} missing, {len(unmapped)} unmapped)")


if __name__ == "__main__":
    main()

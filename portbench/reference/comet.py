"""COMET's forward in plain PyTorch, float32: the benchmark's reference.

A frozen copy of the architecture, written from the published description
(CoTracker2-style coarse and fine trackers, a DINOv2 ViT-B/14 with
registers, the pose-token aggregator, trajectory fusion, the trunk and the
GAPR heads). It reads its weights from a state dict under the port's
parameter names, so one state dict serves both, and it imports nothing of
the program: no kernel, no operator, no plain version of the program's.

Every function takes the parameters as a ``{name: tensor}`` dict. ``rnd``,
applied to both operands of every matrix product and convolution, is the
identity for the reference; the control passes a rounding to a lower
precision (``portbench.reference.precision``).

Quirks of the released model kept on purpose (they decide its outputs):
attention blocks re-base the residual stream on the normalized input; the
camera predictor normalizes the (already normalized) images a second time;
the fine patch's top-left is clamped for extraction but added back
unclamped; the matching score reads its windows from the patch at flat
index ``b`` (``score_from_fine``); frame 0's pose is the identity.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Rnd = Callable[[torch.Tensor], torch.Tensor]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Plain:
    """The layers of the model over one parameter dict, in float32."""

    def __init__(self, params: Params, rnd: Optional[Rnd] = None):
        self.p = params
        self.rnd = rnd or _same

    # -- primitives ---------------------------------------------------------------
    def mm(self, a, b):
        return torch.matmul(self.rnd(a), self.rnd(b))

    def linear(self, name: str, x):
        return F.linear(self.rnd(x), self.rnd(self.p[name + ".weight"]), self.p[name + ".bias"])

    def conv(self, name: str, x, stride: int = 1, padding: int = 0):
        return F.conv2d(self.rnd(x), self.rnd(self.p[name + ".weight"]), self.p[name + ".bias"],
                        stride=stride, padding=padding)

    def ln(self, x, name: Optional[str] = None, eps: float = 1e-6):
        w = b = None
        if name is not None:
            w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        return F.layer_norm(x, (x.shape[-1],), w, b, eps)

    def attend(self, q, k, v, heads: int):
        """softmax(q k^T / sqrt(d)) v over [B, L, C] inputs, heads split from C."""
        b, lq, c = q.shape
        lk, d = k.shape[1], c // heads
        qh = q.reshape(b, lq, heads, d).transpose(1, 2)
        kh = k.reshape(b, lk, heads, d).transpose(1, 2)
        vh = v.reshape(b, lk, heads, d).transpose(1, 2)
        w = torch.softmax(self.mm(qh, kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        return self.mm(w, vh).transpose(1, 2).reshape(b, lq, c)

    def mha(self, name: str, xq, xkv, heads: int):
        """nn.MultiheadAttention with a packed in-projection."""
        w, bias = self.p[name + ".in_proj_weight"], self.p[name + ".in_proj_bias"]
        c = w.shape[1]
        q = F.linear(self.rnd(xq), self.rnd(w[:c]), bias[:c])
        k = F.linear(self.rnd(xkv), self.rnd(w[c:2 * c]), bias[c:2 * c])
        v = F.linear(self.rnd(xkv), self.rnd(w[2 * c:]), bias[2 * c:])
        return self.linear(name + ".out_proj", self.attend(q, k, v, heads))

    def mlp(self, name: str, x):
        return self.linear(name + ".fc2", F.gelu(self.linear(name + ".fc1", x)))

    def attn_block(self, name: str, x, heads: int):
        x = self.ln(x)
        x = x + self.mha(name + ".attn", x, x, heads)
        return x + self.mlp(name + ".mlp", self.ln(x))

    def cross_block(self, name: str, x, ctx, heads: int):
        x = self.ln(x)
        ctx = self.ln(ctx, name + ".norm_context")
        x = x + self.mha(name + ".cross_attn", x, ctx, heads)
        return x + self.mlp(name + ".mlp", self.ln(x))

    # -- tracker encoders (NCHW inside, NHWC at the edges) -------------------------
    def residual(self, name: str, x, stride: int):
        y = F.relu(F.instance_norm(self.conv(name + ".conv1", x, stride, 1)))
        y = F.relu(F.instance_norm(self.conv(name + ".conv2", y, 1, 1)))
        if stride != 1:
            x = F.instance_norm(self.conv(name + ".downsample", x, stride))
        return F.relu(x + y)

    def basic_encoder(self, name: str, x, stride: int):
        """[M, H, W, 3] -> [M, H/stride, W/stride, C]: four residual stages,
        each resized to H/stride and concatenated."""
        oh, ow = x.shape[1] // stride, x.shape[2] // stride
        x = F.relu(F.instance_norm(self.conv(name + ".conv1", x.permute(0, 3, 1, 2), 2, 3)))
        feats = []
        for i, s in ((1, 1), (2, 2), (3, 2), (4, 2)):
            x = self.residual(f"{name}.layer{i}.0", x, s)
            x = self.residual(f"{name}.layer{i}.1", x, 1)
            feats.append(resize(x, oh, ow))
        x = F.relu(F.instance_norm(self.conv(name + ".conv2", torch.cat(feats, 1), 1, 1)))
        return self.conv(name + ".conv3", x).permute(0, 2, 3, 1)

    def shallow_encoder(self, name: str, x):
        """[M, P, P, 3] -> [M, P', P', C] at the first conv's resolution."""
        x = F.relu(F.instance_norm(self.conv(name + ".conv1", x.permute(0, 3, 1, 2), 2, 1)))
        hh, ww = x.shape[-2:]
        tmp = self.residual(name + ".layer1", x, 2)
        x = x + resize(tmp, hh, ww)
        tmp = self.residual(name + ".layer2", tmp, 2)
        x = x + resize(tmp, hh, ww)
        x = self.conv(name + ".conv2", x) + x
        return x.permute(0, 2, 3, 1)

    # -- tracker --------------------------------------------------------------------
    def update_former(self, name: str, x, hidden: int, depth: int, space: bool, heads: int = 8):
        """x [B, N, T, D] -> [B, N, T, out]: time blocks over each track, and
        (coarse) space blocks through the virtual tracks after every one."""
        b, _, t, _ = x.shape
        tokens = self.linear(name + ".input_transform", x)
        init = tokens
        nv = 0
        if space:
            virtual = self.p[name + ".virtual_tracks"]
            nv = virtual.shape[1]
            tokens = torch.cat([tokens, virtual.expand(b, nv, t, hidden)], dim=1)
        n = tokens.shape[1]
        for i in range(depth):
            tokens = self.attn_block(f"{name}.time_blocks.{i}", tokens.reshape(b * n, t, hidden),
                                     heads).reshape(b, n, t, hidden)
            if space:
                sp = tokens.permute(0, 2, 1, 3).reshape(b * t, n, hidden)
                point, virt = sp[:, :n - nv], sp[:, n - nv:]
                virt = self.cross_block(f"{name}.space_virtual2point_blocks.{i}", virt, point, heads)
                virt = self.attn_block(f"{name}.space_virtual_blocks.{i}", virt, heads)
                point = self.cross_block(f"{name}.space_point2virtual_blocks.{i}", point, virt,
                                         heads)
                tokens = torch.cat([point, virt], 1).reshape(b, t, n, hidden).permute(0, 2, 1, 3)
        return self.linear(name + ".flow_head", tokens[:, :n - nv] + init)

    def tracker(self, name: str, t: dict, queries, fmaps, fine: bool, forced=None, steps=None):
        """The iterative tracker. queries [B, N, 2] pixels; fmaps [B, S, h, w, C].
        Returns (coords [iters][B, S, N, 2] in pixels, vis [B, S, N] or None,
        query features [B, N, C]).

        ``forced``, the judged side's [(x_k, delta_k)] per iteration: each
        iteration's update then runs on that side's input x_k, and the state
        (coordinates, track features) moves on by that side's delta_k, so
        that every iteration is computed from the judged side's own state.
        ``steps``, a list, receives this computation's (x_k, delta_k)."""
        b, s, h0, w0, c = fmaps.shape
        levels, radius = t["corr_levels"], t["corr_radius"]
        hh, ww = (t["corr_size"], t["corr_size"]) if fine else (h0, w0)
        n = queries.shape[1]
        scale = float(t["stride"] * t["down_ratio"])
        coords0 = queries / scale
        coords = coords0[:, None].expand(b, s, n, 2)
        frame0 = fmaps[:, 0]
        if fine:
            frame0 = resize(frame0.permute(0, 3, 1, 2), hh, ww).permute(0, 2, 3, 1)
        query_feats = sample_border(frame0, coords0)
        track_feats = query_feats[:, None].expand(b, s, n, c)
        tdim = t["tdim"]
        pos = sincos_2d(tdim, hh, ww).to(fmaps.device).reshape(hh, ww, tdim)
        sampled_pos = sample_border(pos[None].expand(b, hh, ww, tdim), coords0)
        preds = []
        for k in range(t["iters"]):
            corr = self.corr_sample(fmaps, coords, track_feats, radius, levels,
                                    (hh, ww) if fine else None)
            flows = (coords - coords[:, :1]).permute(0, 2, 1, 3)
            tf_bn = track_feats.permute(0, 2, 1, 3)
            x = torch.cat([embed_coords(flows, c // 2), flows, corr.permute(0, 2, 1, 3), tf_bn], -1)
            x = F.pad(x, (0, tdim - x.shape[-1])) + sampled_pos[:, :, None, :]
            if forced is None:  # the update's input is stored at the compute precision
                x = self.rnd(x)
            delta = self.update_former(name + ".updateformer",
                                       x if forced is None else forced[k][0].float(),
                                       t["hidden"], t["depth"], space=not fine)
            if steps is not None:
                steps.append((x, delta))
            if forced is not None:
                delta = forced[k][1].float()
            normed = F.group_norm(delta[..., 2:].reshape(-1, c), 1,
                                  self.p[name + ".ffeat_norm.weight"],
                                  self.p[name + ".ffeat_norm.bias"], 1e-6)
            update = F.gelu(self.linear(name + ".ffeat_updater", normed)).reshape(tf_bn.shape)
            track_feats = (tf_bn + update).permute(0, 2, 1, 3)
            coords = coords + delta[..., :2].permute(0, 2, 1, 3)
            coords = torch.cat([coords0[:, None], coords[:, 1:]], dim=1)
            preds.append(coords * scale)
        vis = None
        if not fine:
            vis = torch.sigmoid(self.linear(name + ".vis_predictor", track_feats))[..., 0]
        return preds, vis, query_feats

    def corr_sample(self, fmaps, coords, track_feats, radius, levels, out_size):
        """<track feature, map> / sqrt(C) around each track, per pyramid level:
        [B, S, N, levels * (2r+1)^2], windows sampled bilinearly with zero
        padding, the x offset outer."""
        b, s, n, _ = coords.shape
        h0, w0, c = fmaps.shape[2:]
        vol = self.mm(track_feats.reshape(b * s, n, c) / math.sqrt(c),
                      fmaps.reshape(b * s, h0 * w0, c).transpose(1, 2))
        vol = vol.reshape(b * s * n, 1, h0, w0)
        if out_size is not None:
            vol = resize(vol, *out_size)
        pts = coords.reshape(b * s * n, 2)
        k = 2 * radius + 1
        off = torch.arange(-radius, radius + 1, device=vol.device, dtype=vol.dtype)
        outs = []
        for lvl in range(levels):
            if lvl > 0 and min(vol.shape[-2:]) >= 2:
                vol = F.avg_pool2d(vol, 2)
            hl, wl = vol.shape[-2:]
            p = pts / 2.0 ** lvl
            gx = (p[:, 0, None, None] + off[:, None]).expand(-1, k, k)  # [M, x, y]
            gy = (p[:, 1, None, None] + off[None, :]).expand(-1, k, k)
            grid = torch.stack([2 * gx / max(wl - 1, 1) - 1, 2 * gy / max(hl - 1, 1) - 1], -1)
            outs.append(F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                                      align_corners=True).reshape(-1, k * k))
        return torch.cat(outs, -1).reshape(b, s, n, -1)

    # -- camera predictor -------------------------------------------------------------
    def vit(self, name: str, x, cam: dict):
        """DINOv2 with registers: [M, H, W, 3] -> normalized patch tokens."""
        m = x.shape[0]
        c = cam["backbone_dim"]
        x = self.conv(name + ".patch_embed", x.permute(0, 3, 1, 2), cam["patch"])
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.p[name + ".cls_token"].expand(m, 1, c), x], 1)
        x = x + self.p[name + ".pos_embed"]
        regs = self.p[name + ".register_tokens"]
        x = torch.cat([x[:, :1], regs.expand(m, regs.shape[1], c), x[:, 1:]], 1)
        heads = cam["backbone_heads"]
        for i in range(cam["backbone_depth"]):
            blk = f"{name}.blocks.{i}"
            h = self.ln(x, blk + ".norm1")
            q, k, v = self.linear(blk + ".attn.qkv", h).split(c, -1)
            x = x + self.p[blk + ".ls1.gamma"] * self.linear(blk + ".attn.proj",
                                                            self.attend(q, k, v, heads))
            h = F.gelu(self.linear(blk + ".mlp_fc1", self.ln(x, blk + ".norm2")))
            x = x + self.p[blk + ".ls2.gamma"] * self.linear(blk + ".mlp_fc2", h)
        x = self.ln(x, name + ".norm")
        return x[:, 1 + regs.shape[1]:]

    def camera(self, images, tracks, confidence, cam: dict):
        """images [B, S, H, W, 3]; tracks [B, S, N, 2]; confidence [B, S, N]
        -> pred_pose_enc [B, S, 7] (frame 0 the identity)."""
        name = "camera_predictor"
        b, s, h, w, _ = images.shape
        c, heads = cam["hidden_size"], cam["num_heads"]
        x = images.reshape(b * s, h, w, 3).permute(0, 3, 1, 2)
        x = resize(x, cam["down_size"], cam["down_size"]).permute(0, 2, 3, 1)
        x = (x - x.new_tensor(_IMAGENET_MEAN)) / x.new_tensor(_IMAGENET_STD)
        tokens = self.ln(self.mlp(name + ".input_transform", self.vit(name + ".backbone", x, cam)))
        p = tokens.shape[1]
        g = int(round(p ** 0.5))
        tokens = tokens.reshape(b, s, p, c) + sincos_2d(c, g, g).to(x.device)
        pose_token = self.p[name + ".pose_token"].expand(b, s, 1, c)
        tokens = torch.cat([pose_token, tokens], 2)
        p1 = p + 1
        for i in range(cam["att_depth"]):
            tokens = self.attn_block(f"{name}.self_att.{i}", tokens.reshape(b * s, p1, c),
                                     heads).reshape(b, s, p1, c)
            others = self.cross_block(f"{name}.cross_att.{i}",
                                      tokens[:, 1:].reshape(b, (s - 1) * p1, c), tokens[:, 0],
                                      heads)
            tokens = torch.cat([tokens[:, :1], others.reshape(b, s - 1, p1, c)], 1)
        feat = tokens[:, :, 0]
        if cam["use_trajectory"]:
            n = tracks.shape[2]
            te = name + ".traj_encoder"
            traj = F.relu(self.ln(self.linear(te + ".fc1", tracks), te + ".ln1"))
            traj = self.ln(self.linear(te + ".fc2", traj), te + ".ln2")
            ca = name + ".confidence_attention"
            conf = torch.sigmoid(self.linear(ca + ".fc2",
                                             F.relu(self.linear(ca + ".fc1", confidence[..., None]))))
            ctx = (traj * conf).reshape(b * s, n, c)
            flat = feat.reshape(b * s, 1, c)
            for i in range(cam["att_depth"]):
                flat = self.cross_block(f"{name}.cross_attn_block.{i}", flat, ctx, heads)
            feat = feat + flat.reshape(b, s, c)
        if cam["use_time"]:
            feat = feat + sincos_1d(c, torch.arange(s, device=x.device))[None]
            for i in range(cam["trunk_depth"]):
                feat = self.attn_block(f"{name}.trunk.{i}", feat, heads)
        if cam["use_gapr"]:
            rot = self.mlp(name + ".pose_branch", feat)
            trans = torch.cat([self.linear(name + ".fc_translation2d", feat),
                               self.linear(name + ".fc_depth", feat)], -1)
        else:
            enc = self.mlp(name + ".pose_branch", feat)
            trans, rot = enc[..., :3], enc[..., 3:7]
        rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp_min(1e-8)
        pred = torch.cat([trans, rot], -1)
        identity = pred.new_tensor([0, 0, 0, 1, 0, 0, 0]).expand(b, 1, 7)
        return torch.cat([identity, pred[:, 1:]], 1)

    # -- stages -------------------------------------------------------------------------
    def coarse(self, images, queries, spec: dict, forced=None, steps=None):
        """Coarse stage: (coarse tracks [B, S, N, 2] px, visibility [B, S, N])."""
        t = spec["coarse"]
        b, s, h, w, _ = images.shape
        x = images.reshape(b * s, h, w, 3).permute(0, 3, 1, 2)
        x = resize(x, h // t["down_ratio"], w // t["down_ratio"]).permute(0, 2, 3, 1)
        fmaps = self.basic_encoder("coarse_fnet", x, t["stride"])
        fmaps = fmaps.reshape(b, s, *fmaps.shape[1:])
        preds, vis, _ = self.tracker("coarse_tracker", t, queries, fmaps, False, forced, steps)
        return preds[-1], vis

    def fine(self, images, coarse_tracks, spec: dict, forced=None, steps=None):
        """Fine stage from the given coarse tracks: (refined tracks [B, S, N, 2],
        fine predictions in patch coordinates [B, N, S, 2], query features
        [B, N, C], patch features [B, N, S, P', P', C])."""
        t = spec["fine"]
        b, s, n, _ = coarse_tracks.shape
        h = images.shape[2]
        pr = t["pradius"]
        psize = 2 * pr + 1
        track_int = torch.floor(coarse_tracks)
        frac = coarse_tracks - track_int
        tl_unclamped = track_int.long() - pr
        patches = crop(images.reshape(b * s, h, images.shape[3], 3),
                       tl_unclamped.clamp(0, h - psize).reshape(b * s, n, 2), psize)
        feat = self.shallow_encoder("fine_fnet", patches.reshape(b * s * n, psize, psize, 3))
        hp, wp, c = feat.shape[1:]
        feat = feat.reshape(b, s, n, hp, wp, c).transpose(1, 2)  # [B, N, S, ...]
        query = (frac[:, 0] + pr).reshape(b * n, 1, 2)
        preds, _, qfeat = self.tracker("fine_tracker", {**t, "corr_size": psize}, query,
                                       feat.reshape(b * n, s, hp, wp, c), True, forced, steps)
        fine_rel = preds[-1][..., 0, :].reshape(b, n, s, 2)
        refined = fine_rel.transpose(1, 2) + tl_unclamped.to(fine_rel.dtype)
        refined = torch.cat([coarse_tracks[:, :1], refined[:, 1:]], 1)
        return refined, fine_rel, qfeat.reshape(b, n, c), feat


def score_from_fine(query_feat, patch_feat, fine_rel, sradius: int, psize: int, rnd=None):
    """The matching score [B, S, N]: the spread of the similarity heatmap
    around each fine prediction, frame 0 at 1, as the released model computes
    it: every output (b, s, n) reads the windows of the patch at flat index b
    of the (b, s, n) order. query_feat [B, N, C]; patch_feat
    [B, N, S, P', P', C]; fine_rel [B, N, S, 2] in patch coordinates."""
    b, n, s = patch_feat.shape[:3]
    flat = torch.arange(b, device=patch_feat.device)  # flat (b, s, n) index of patch b
    bi, rem = flat // (s * n), flat % (s * n)
    return score_from_sources(query_feat, patch_feat[bi, rem % n, rem // n], fine_rel, sradius,
                              psize, rnd)


def score_from_sources(query_feat, src, fine_rel, sradius: int, psize: int, rnd=None):
    """:func:`score_from_fine` from the patches it reads, src [B, P', P', C]
    (batch element b's); the window corners, listed in (b, n, s) order, are
    read at (b, s, n) positions, as the released model reads them. ``rnd``
    rounds both operands of the similarity product, as :class:`Plain`'s."""
    rnd = rnd or _same
    b, n, s, _ = fine_rel.shape
    c = src.shape[-1]
    k = 2 * sradius + 1
    tl = (torch.floor(fine_rel).long() - sradius).clamp(0, psize - k).reshape(b, s * n, 2)
    src = resize(src.permute(0, 3, 1, 2), psize, psize).permute(0, 2, 3, 1)
    windows = crop(src, tl, k).reshape(b, s, n, k * k, c)
    sim = torch.einsum("bsnkc,bnc->bsnk", rnd(windows), rnd(query_feat))
    heat = torch.softmax(sim / math.sqrt(c), dim=-1)
    lin = torch.linspace(-1.0, 1.0, k, device=sim.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    mean = heat @ grid
    std = torch.sqrt((heat @ grid ** 2 - mean ** 2).clamp_min(1e-10)).sum(-1)
    return torch.cat([torch.ones_like(std[:, :1]), std[:, 1:]], 1)


def confidence_from_score(score):
    """Track confidence: the inverse score over its largest value per track."""
    inv = 1.0 / (score + 1e-6)
    return inv / inv.amax(dim=1, keepdim=True)


# -- geometry helpers ------------------------------------------------------------------
def resize(x, out_h: int, out_w: int):
    """Bilinear resize of NCHW maps with aligned corners."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def sample_border(fmaps, pts):
    """fmaps [B, H, W, C] sampled bilinearly at pts [B, N, 2] (x, y pixels),
    coordinates clamped to the map -> [B, N, C]."""
    b, h, w, c = fmaps.shape
    grid = torch.stack([2 * pts[..., 0] / max(w - 1, 1) - 1,
                        2 * pts[..., 1] / max(h - 1, 1) - 1], -1)[:, :, None]
    out = F.grid_sample(fmaps.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[..., 0].transpose(1, 2)


def crop(images, topleft, size: int):
    """Integer crops: images [M, H, W, C], top-left corners [M, N, 2] (x, y),
    clamped into the image -> [M, N, size, size, C]."""
    m, h, w, c = images.shape
    x0 = topleft[..., 0].clamp(0, w - size)
    y0 = topleft[..., 1].clamp(0, h - size)
    r = torch.arange(size, device=images.device)
    rows = (y0[..., None] + r)[..., :, None]
    cols = (x0[..., None] + r)[..., None, :]
    mi = torch.arange(m, device=images.device)[:, None, None, None]
    return images[mi, rows, cols]


def sincos_1d(dim: int, pos):
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
                              / (dim / 2.0))
    out = pos.reshape(-1).float()[:, None] * omega
    return torch.cat([torch.sin(out), torch.cos(out)], -1)


def sincos_2d(dim: int, gh: int, gw: int):
    """[gh * gw, dim]: the first half encodes the column, the second the row."""
    rows, cols = torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij")
    return torch.cat([sincos_1d(dim // 2, cols.reshape(-1)), sincos_1d(dim // 2, rows.reshape(-1))],
                     -1)


def embed_coords(xy, dim: int):
    """[..., 2] -> [..., 2 * dim]: sin and cos interleaved per frequency,
    frequencies 2k * 1000 / dim, the x channels before the y channels."""
    div = torch.arange(0, dim, 2, dtype=torch.float32, device=xy.device) * (1000.0 / dim)

    def one(v):
        t = v[..., None] * div
        return torch.stack([torch.sin(t), torch.cos(t)], -1).reshape(*v.shape, dim)

    return torch.cat([one(xy[..., 0]), one(xy[..., 1])], -1)


def tracker_spec(cfg: dict) -> dict:
    """The two trackers' sizes from a configuration file's ``tracker`` group,
    with the update transformer's input width padded as the released model
    pads it."""
    t = cfg["tracker"]
    out = {}
    for part, stride, down in (("coarse", t["coarse_stride"], t["coarse_down_ratio"]),
                               ("fine", 1, 1)):
        levels, radius, latent = (t[f"{part}_corr_levels"], t[f"{part}_corr_radius"],
                                  t[f"{part}_latent_dim"])
        tdim = levels * (2 * radius + 1) ** 2 + 2 * latent
        if part == "fine":
            tdim += 4 if tdim % 2 == 0 else 5
        else:
            tdim += (4 - tdim % 4) % 4
        out[part] = dict(stride=stride, down_ratio=down, corr_levels=levels, corr_radius=radius,
                         latent=latent, hidden=t[f"{part}_hidden_size"], depth=t[f"{part}_depth"],
                         iters=t[f"{part}_iters"], tdim=tdim)
    out["fine"].update(pradius=t["fine_pradius"], sradius=t["fine_sradius"])
    return out


def camera_spec(cfg: dict) -> dict:
    return {**cfg["camera"], "patch": 14}


def forward(plain: Plain, cfg: dict, images, queries) -> Dict[str, torch.Tensor]:
    """The whole forward, stage after stage from its own outputs (the
    control runs so). images [B, S, H, W, 3]; queries [B, N, 2]."""
    spec = tracker_spec(cfg)
    coarse, vis = plain.coarse(images, queries, spec)
    refined, fine_rel, qfeat, pfeat = plain.fine(images, coarse, spec)
    psize = 2 * spec["fine"]["pradius"] + 1
    conf = confidence_from_score(score_from_fine(qfeat, pfeat, fine_rel, spec["fine"]["sradius"],
                                                 psize))
    pose = plain.camera(images, refined, conf, camera_spec(cfg))
    return dict(coarse_track=coarse, track_vis=vis, pred_track=refined, fine_rel=fine_rel,
                track_score=conf, pred_pose_enc=pose)


def shapes_of_tracker(cfg: dict) -> Tuple[int, int]:
    t = tracker_spec(cfg)
    return t["coarse"]["tdim"], t["fine"]["tdim"]

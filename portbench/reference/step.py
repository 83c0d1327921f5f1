"""The train step and the LPIPS loss in plain PyTorch.

The loss terms and Adam with its per-group learning rates and decay follow
GoMAvatar as the program states them (gomavatar_tpu_torch/losses.py,
optim.py and models/lpips.py at commit a92d513); the VGG16 trunk runs in bfloat16, as
the configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import model as M

LR_GROUP = {"vertices": "canonical_geometry_xyz", "so3": "canonical_geometry", "scale": "canonical_geometry",
            "appearance": "appearance", "pose_refinement": "pose_refinement", "non_rigid": "non_rigid",
            "shadow": "shadow"}
_VGG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)
_SHIFT, _SCALE = (-0.030, -0.088, -0.188), (0.458, 0.448, 0.450)
B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree) -> list:
    """The tensors of a nested dict/list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, values: list):
    it = iter(values)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)

    return go(tree)


def leaf_names(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def lpips(trunk, pred, gt):
    """VGG-LPIPS between two (H, W, 3) images in [-1, 1], the convolutions
    in bfloat16."""
    def features(x):
        shift = torch.tensor(_SHIFT, dtype=torch.float32, device=x.device)
        scale = torch.tensor(_SCALE, dtype=torch.float32, device=x.device)
        h = ((x - shift) / scale).permute(2, 0, 1)[None].to(torch.bfloat16)
        out, i = [], 0
        for c in _VGG:
            if c == "M":
                h = F.max_pool2d(h, 2)
                continue
            conv = trunk["convs"][i]
            h = torch.relu(F.conv2d(h, conv["w"].to(torch.bfloat16), padding=1)
                           + conv["b"].to(torch.bfloat16)[None, :, None, None])
            if i in _TAPS:
                out.append(h.float())
            i += 1
        return out

    total = torch.zeros((), device=pred.device)
    for fp, fg, head in zip(features(pred), features(gt), trunk["heads"]):
        a = fp * torch.rsqrt(torch.sum(fp * fp, dim=1, keepdim=True) + 1e-20)
        b = fg * torch.rsqrt(torch.sum(fg * fg, dim=1, keepdim=True) + 1e-20)
        total = total + torch.mean(torch.sum((a - b) ** 2 * torch.clamp_min(head[:, 0], 0.0)[None, :, None, None],
                                             dim=1))
    return total


def l1(x):
    """|x| with the gradient +1 at 0, as the configuration's L1 terms take it."""
    return torch.where(x >= 0, x, -x)


def train_loss(params, model, losses_cfg, mesh, trunk, batch, img_size, i_iter):
    """(total, {term: value}, the most entries of a tile) of one frame."""
    rgb, alpha, soft, verts_obs, most = M.frame(params, model, mesh, batch, img_size, i_iter)
    pred = M.over(rgb, alpha, batch["bgcolor"])
    gt, gt_mask = batch["target_rgbs"], batch["target_masks"]
    terms = {"rgb": (torch.mean(l1(pred - gt)), losses_cfg["rgb"]["coeff"]),
             "mask": (torch.mean(l1(alpha - gt_mask)), losses_cfg["mask"]["coeff"])}
    if losses_cfg["lpips"]["coeff"] > 0:
        terms["lpips"] = (lpips(trunk, 2.0 * pred - 1.0, 2.0 * gt - 1.0), losses_cfg["lpips"]["coeff"])
    lap = losses_cfg["laplacian"]
    for name, verts in (("canonical", params["vertices"]), ("observation", verts_obs)):
        if lap[f"coeff_{name}"] > 0:
            e = mesh.edges
            nbr = torch.zeros_like(verts).index_add(0, e[:, 0], verts[e[:, 1]]).index_add(0, e[:, 1], verts[e[:, 0]])
            d = (nbr - mesh.degree[:, None] * verts) / torch.clamp_min(mesh.degree, 1.0)[:, None]
            terms[f"laplacian_{name}"] = (torch.mean(torch.sum(d * d, dim=-1)), lap[f"coeff_{name}"])
    nrm = losses_cfg["normal"]
    if nrm["coeff_mask"] > 0:
        target = M.dilate(gt_mask, nrm.get("kernel_size", 7)) if nrm.get("mask_dilate", False) else gt_mask
        terms["normal_mask"] = (torch.mean(l1(soft - target)), nrm["coeff_mask"])
    if nrm["coeff_consist"] > 0:
        q = verts_obs[mesh.quads]
        e = q[:, 1] - q[:, 0]
        n0 = torch.cross(e, q[:, 2] - q[:, 0], dim=-1)
        n1 = -torch.cross(e, q[:, 3] - q[:, 0], dim=-1)
        cos = torch.sum(n0 * n1, -1) / (torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1) + 1e-12)
        terms["normal_consist"] = (torch.mean(1.0 - cos), nrm["coeff_consist"])
    if losses_cfg["color_consist"]["coeff"] > 0:
        c = params["appearance"]["colors"]
        terms["color_consist"] = (torch.mean(l1(c[mesh.pairs[:, 0]] - c[mesh.pairs[:, 1]])),
                                  losses_cfg["color_consist"]["coeff"])
    total = torch.zeros((), device=pred.device)
    for value, coeff in terms.values():
        total = total + value * coeff
    return total, {k: v for k, (v, _) in terms.items()}, most


def adam_directions(grads, state):
    mu = [g * (1.0 - B1) + m * B1 for g, m in zip(grads, state["mu"])]
    nu = [g * g * (1.0 - B2) + v * B2 for g, v in zip(grads, state["nu"])]
    count = state["count"] + 1
    bc1 = 1.0 - torch.pow(torch.tensor(B1), torch.tensor(float(count)))
    bc2 = 1.0 - torch.pow(torch.tensor(B2), torch.tensor(float(count)))
    dirs = [(m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device)) + EPS) for m, v in zip(mu, nu)]
    return dirs, {"count": count, "mu": mu, "nu": nu}


class TrainStep:
    """One step of the recipe on one frame: the loss, its gradient in every
    leaf, and Adam with the per-group learning rates and the decay
    0.1^(t / lr_decay_steps), its schedule at the global iteration."""

    def __init__(self, cfg: dict, params: dict, i_iter: int):
        tcfg = cfg["train"]
        self.cfg, self.i_iter = cfg, i_iter
        self.lrs = [float(tcfg["lr"][LR_GROUP[k]]) for k in sorted(params) for _ in leaves(params[k])]
        self.decay_steps = float(tcfg["lr_decay_steps"])
        self.state = {"count": 0, "mu": [torch.zeros_like(p) for p in leaves(params)],
                      "nu": [torch.zeros_like(p) for p in leaves(params)]}

    def __call__(self, params, mesh, trunk, batch, img_size):
        """(new params, total, terms, gradients, the most entries of a tile)."""
        ls = [p.detach().requires_grad_(True) for p in leaves(params)]
        total, terms, most = train_loss(rebuild(params, ls), self.cfg["model"], self.cfg["train"]["losses"], mesh,
                                        trunk, batch, img_size, self.i_iter)
        grads = torch.autograd.grad(total, ls, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ls, grads)]
        dirs, self.state = adam_directions(grads, self.state)
        scale = torch.pow(torch.tensor(0.1), torch.tensor(float(self.i_iter)) / self.decay_steps)
        with torch.no_grad():
            new = [p + (d * -lr) * scale.to(p.device) for p, d, lr in zip(ls, dirs, self.lrs)]
        self.i_iter += 1
        return rebuild(params, [p.detach() for p in new]), total.detach(), {k: v.detach() for k, v in terms.items()}, \
            grads, most


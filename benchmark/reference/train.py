"""The plain reference of the release VAE's training steps, a frozen copy
kept with the benchmark: the batch assembled again from the data set's
files, the VAE's forward, each LoD rendered through the plain compositor
under autograd, the reconstruction, perceptual, depth, KL and
regulariser terms, the PatchGAN generator term under its adaptive
weight, AdamW with its warm-up, clipping and weight decay, and the
discriminator's step (the GaussianAnything recipe `vae3d-adv-512.sh`:
`nsr/train_nv_util.py:1771-3048`, `nsr/losses`).

Terms whose weight is zero at a step (the distortion and normal terms
before their start steps, the KL term before its annealing starts) are
left out: they add zero to the loss and to every gradient.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import nets, raster
from benchmark.reference.precision import aux, geom

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# ------------------------------------------------------------------ data


def seeds(seed: int) -> Dict[str, int]:
    """The data set's and the steps' generators' seeds, from the run's."""
    return {"data": int(seed) % (2 ** 32) + 17, "steps": int(seed) + 29}


def load_instance(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {"rgb": z["rgb"].astype(np.float32) / 255.0,
                "normal": z["normal"].astype(np.float32),
                "depth": z["depth"].astype(np.float32),
                "alpha": z["alpha"].astype(np.float32) / 255.0,
                "pose": z["pose"].astype(np.float32),
                "pcd": z["pcd"].astype(np.float32)}


def batches(files: List[str], d: dict, seed: int, batch: int, n: int,
            device) -> List[dict]:
    """The first `n` batches a data set over `files` gives from `seed`:
    per sample an instance, 4 + 4 distinct views and `n_points` points,
    drawn from one numpy generator in that order; every pose and the
    points rebased so the first input view is the canonical camera."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        samples = []
        for _ in range(batch):
            inst = load_instance(files[rng.integers(len(files))])
            V = inst["rgb"].shape[0]
            k = d["n_views_in"] + d["n_views_sup"]
            views = rng.choice(V, k, replace=V < k)
            vin, vsup = views[:d["n_views_in"]], views[d["n_views_in"]:]
            pcd = inst["pcd"]
            pcd = pcd[rng.choice(len(pcd), d["n_points"],
                                 replace=len(pcd) < d["n_points"])]
            rgb = np.moveaxis(inst["rgb"], -1, -3)
            normal = np.moveaxis(inst["normal"], -1, -3)
            samples.append({
                "rgb_in": rgb[vin], "normal_in": normal[vin],
                "depth_in": inst["depth"][vin][:, None],
                "alpha_in": inst["alpha"][vin][:, None],
                "pose_in": inst["pose"][vin], "images_sup": rgb[vsup],
                "alpha_sup": inst["alpha"][vsup][:, None],
                "depth_sup": inst["depth"][vsup][:, None],
                "pose_sup": inst["pose"][vsup], "pcd": pcd})
        t = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             .to(device) for k in samples[0]}
        out.append(assemble(t))
    return out


def _canonical(c2w):
    fixed = torch.eye(4, device=c2w.device)
    fixed[2, 3] = -torch.linalg.vector_norm(c2w[:3, 3])
    return fixed @ torch.linalg.inv(geom(c2w))


def assemble(t: dict) -> dict:
    pin, psup, pcd = t["pose_in"], t["pose_sup"], t["pcd"]
    v_in = pin.shape[1]
    new_pcd, poses = [], []
    for b in range(pin.shape[0]):
        T = _canonical(pin[b, 0, :16].reshape(4, 4))
        new_pcd.append(torch.matmul(geom(pcd[b]), geom(T[:3, :3].T))
                       + T[:3, 3])
        joint = torch.cat([pin[b], psup[b]])
        c2w = joint[:, :16].reshape(-1, 4, 4)
        new = torch.matmul(geom(T), geom(c2w))
        poses.append(torch.cat([new.reshape(-1, 16), joint[:, 16:]], -1))
    poses = torch.stack(poses)
    pin, psup = poses[:, :v_in], poses[:, v_in:]
    B, V, _, H, W = t["rgb_in"].shape
    c2w = pin[..., :16].reshape(B, V, 4, 4)
    K = pin[..., 16:].reshape(B, V, 3, 3)
    mean = torch.tensor(IMAGENET_MEAN, device=c2w.device)
    std = torch.tensor(IMAGENET_STD, device=c2w.device)
    tan_in = _tanfov(pin[..., 16])
    xyz = _backproject(t["depth_in"], c2w, tan_in) * (t["alpha_in"] > 0.5)
    images_in = torch.cat([
        (t["rgb_in"] - mean[:, None, None]) / std[:, None, None],
        t["normal_in"], _plucker(c2w, K, H, W), xyz], dim=2)
    c2w_sup = psup[..., :16].reshape(B, -1, 4, 4)
    tan_sup = _tanfov(psup[..., 16])
    view = torch.linalg.inv(geom(c2w_sup)).transpose(-1, -2)
    z, one = torch.zeros_like(tan_sup), torch.ones_like(tan_sup)
    zz = one * (raster.ZFAR_CAM / (raster.ZFAR_CAM - raster.ZNEAR_CAM))
    zw = one * (-(raster.ZFAR_CAM * raster.ZNEAR_CAM)
                / (raster.ZFAR_CAM - raster.ZNEAR_CAM))
    inv = 1.0 / tan_sup
    proj = torch.stack([torch.stack([inv, z, z, z], -1),
                        torch.stack([z, inv, z, z], -1),
                        torch.stack([z, z, zz, one], -1),
                        torch.stack([z, z, zw, z], -1)], -2)
    return {"images_in": images_in, "pcd": torch.stack(new_pcd),
            "cam_view": view,
            "cam_view_proj": torch.matmul(geom(view), geom(proj)),
            "tanfov": tan_sup, "images_sup": t["images_sup"],
            "alpha_sup": t["alpha_sup"], "depth_sup": t["depth_sup"]}


def _tanfov(focal):
    return torch.tan(2 * torch.atan2(torch.ones_like(focal), 2 * focal) / 2)


def _backproject(depth, c2w, tanfov):
    H, W = depth.shape[-2:]
    dev = depth.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2 - 1
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    tf = tanfov[..., None, None]
    z = depth[..., 0, :, :]
    pv = torch.stack([gx * tf * z, gy * tf * z, z], -1)
    pw = torch.einsum("...hwj,...ij->...hwi", geom(pv),
                      geom(c2w[..., :3, :3])) + c2w[..., None, None, :3, 3]
    return pw.movedim(-1, -3)


def _plucker(c2w, K, h, w):
    dev = c2w.device
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    dirs = torch.stack([(xx - cx) / fx, (yy - cy) / fy,
                        torch.ones_like(xx) * torch.ones_like(cx)], -1)
    d = torch.einsum("...hwj,...ij->...hwi", geom(dirs),
                     geom(c2w[..., :3, :3]))
    d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-16)
    o = c2w[..., None, None, :3, 3].expand_as(d)
    return torch.cat([torch.linalg.cross(o, d), d], -1).movedim(-1, -3)


# --------------------------------------------------------------- render


def resize_linear(x, res):
    """Antialiased bilinear resize of the last two dims to (res, res)
    (`jax.image.resize` "linear")."""
    H = x.shape[-1]
    if H == res:
        return x
    inv = H / res
    ks = max(inv, 1.0)
    sf = (torch.arange(res, dtype=torch.float32, device=x.device) + 0.5) \
        * inv - 0.5
    d = (sf[None] - torch.arange(H, dtype=torch.float32,
                                 device=x.device)[:, None]).abs() / ks
    w = torch.clamp(1.0 - d, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sf >= -0.5) & (sf <= H - 0.5)
    w = torch.where(inside[None], w, torch.zeros_like(w))
    x = torch.einsum("...hw,hH->...Hw", geom(x.float()), geom(w))
    return torch.einsum("...hw,wW->...hW", geom(x), geom(w))


def _composite_grad(tab, pairs, starts, counts, bg, size, tile, chunk):
    """`raster.composite` under autograd, each chunk checkpointed."""
    walk = raster._TileWalk(tab, pairs, starts, counts, size, size, tile,
                            chunk)
    rows = []
    for tiles, px, py, n_chunks in walk.groups():
        state = walk.init_state(len(tiles))
        for c in range(n_chunks):
            if not bool((state.trans > raster.T_EPS).any()):
                break
            data = walk.chunk_data(walk.chunk_ids(tiles, c))

            def step(*args, px=px, py=py):
                return tuple(raster.composite_chunk(
                    raster.PixelState(*args[:-1]), px, py, args[-1]))
            state = raster.PixelState(*checkpoint(
                step, *state, data, use_reentrant=False))
        rgb = state.rgb + state.trans[..., None] * bg
        rows.append(torch.cat([rgb, state.alpha_acc[..., None],
                               state.depth_exp[..., None],
                               state.depth_med[..., None],
                               state.dist[..., None], state.normal], -1))
    return raster.detile(torch.cat(rows), size, size, tile)


def render(gaussians, cam_view, cam_view_proj, res, max_per_tile, chunk,
           tile=16):
    """(B, N, 13) gaussians, (B, V, 4, 4) cameras → maps (B, V, C, H, W)
    with gradients to the gaussians."""
    B, V = cam_view.shape[:2]
    bg = torch.ones(3, device=gaussians.device)
    views = []
    for b in range(B):
        for v in range(V):
            cv = cam_view[b, v].float()
            sp = raster.preprocess_splats(gaussians[b], cv,
                                          cam_view_proj[b, v], res, res)
            with torch.no_grad():
                pairs, starts, counts = raster.build_tile_pairs(
                    raster.SplatProj(*(t.detach() for t in sp)), res, res,
                    tile, max_per_tile)
            tab = raster.pack_splat_render(sp).t()
            buf = _composite_grad(tab, pairs, starts, counts, bg, res, tile,
                                  chunk)
            m = {k: buf[a:b_] for k, a, b_ in raster.OUT_CHANNELS}
            nv, alpha = m["normal_view"], m["alpha"]
            de = m["depth_expected"] / torch.clamp(alpha, min=1e-10)
            views.append({
                "image": torch.clamp(m["image"], 0.0, 1.0), "alpha": alpha,
                "depth": m["depth_median"],
                "depth_expected": torch.where(alpha > 1e-6, de,
                                              torch.zeros_like(de)),
                "rend_normal": torch.stack([nv[0] * cv[j, 0] + nv[1]
                                            * cv[j, 1] + nv[2] * cv[j, 2]
                                            for j in range(3)]),
                "dist": m["dist"]})
    return {k: torch.stack([o[k] for o in views]).reshape(
        (B, V) + views[0][k].shape) for k in views[0]}


# --------------------------------------------------------------- losses


class AuxConv(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(aux(x), aux(self.weight), aux(self.bias))


class AuxSameConv(AuxConv):
    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


_VGG = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
        (14, 256), (17, 512), (19, 512), (21, 512), (24, 512), (26, 512),
        (28, 512))
_TAPS = (2, 7, 14, 21, 28)
_POOL = (5, 10, 17, 24)


class LPIPS(nn.Module):
    """VGG16-LPIPS: the scaling layer, the five relu taps, unit-normalised
    channels, squared difference, bias-free 1×1 convs, spatial means
    summed over the taps, the batch mean. Inputs in [0, 1]."""

    def __init__(self):
        super().__init__()
        layers, c = [], 3
        for idx, ch in _VGG:
            if idx in _POOL:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [AuxConv(c, ch, 3, padding=1), nn.ReLU()]
            c = ch
        self.net = nn.Module()
        self.net.features = nn.Sequential(*layers)
        self.lins = nn.ModuleList(AuxConv(c, 1, 1, bias=False)
                                  for c in (64, 128, 256, 512, 512))

    def _taps(self, x):
        out, start = [], 0
        layers = list(self.net.features)
        for tap in _TAPS:
            def seg(h, a=start, b=tap + 2):
                for layer in layers[a:b]:
                    h = layer(h)
                return h
            x = nets._ckpt(seg, x)
            out.append(x.float())
            start = tap + 2
        return out

    def forward(self, a, b):
        shift = torch.tensor([-0.030, -0.088, -0.188],
                             device=a.device).view(1, 3, 1, 1)
        scale = torch.tensor([0.458, 0.448, 0.450],
                             device=a.device).view(1, 3, 1, 1)
        fa = self._taps((a * 2 - 1 - shift) / scale)
        fb = self._taps((b * 2 - 1 - shift) / scale)
        total = 0.0
        for lin, xa, xb in zip(self.lins, fa, fb):
            na = xa * torch.rsqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
            total = total + lin((na - nb) ** 2).float().mean(dim=(1, 2, 3))
        return total.mean()


class PatchDisc(nn.Module):
    """PatchGAN: a 4×4 stride-2 conv, three bias-free 4×4 convs with
    GroupNorm(32) (stride 2, 2, 1), LeakyReLU 0.2, a 4×4 conv to a logit
    per patch; flax "SAME" padding."""

    def __init__(self, ch=64, layers=3):
        super().__init__()
        convs, norms, c_in = [AuxSameConv(3, ch, 4, stride=2)], [], ch
        for i in range(1, layers + 1):
            c = min(ch * 2 ** i, 512)
            convs.append(AuxSameConv(c_in, c, 4, stride=2 if i < layers
                                     else 1, bias=False))
            norms.append(nn.GroupNorm(32, c, eps=1e-6))
            c_in = c
        convs.append(AuxSameConv(c_in, 1, 4))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)

    def forward(self, x):
        h = F.leaky_relu(self.convs[0](x).float(), 0.2)
        for conv, norm in zip(self.convs[1:-1], self.norms):
            h = F.leaky_relu(norm(conv(h).float()), 0.2)
        return self.convs[-1](h).float()


def depth_loss(pred, gt, mask):
    B = pred.shape[0]
    p, g = pred.reshape(B, -1), gt.reshape(B, -1)
    m = mask.reshape(B, -1).float()
    n = torch.clamp(m.sum(-1), min=1.0)
    mp, mg = (p * m).sum(-1) / n, (g * m).sum(-1) / n
    var = ((p - mp[:, None]) ** 2 * m).sum(-1) / n
    cov = ((p - mp[:, None]) * (g - mg[:, None]) * m).sum(-1) / n
    s = cov / (var + 1e-8)
    aligned = s[:, None] * p + (mg - s * mp)[:, None]
    return ((aligned - g).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)


def opacity_reg(g):
    o = torch.clamp(g[..., 3], 1e-4, 1 - 1e-4)
    return -(o * torch.log(o) + (1 - o) * torch.log(1 - o)).mean()


# ----------------------------------------------------------------- steps


def loss(vae, lpips, disc, batch, step, cfg, gen):
    """The generator's loss at optimiser step `step`, drawing its noise
    and the perceptual LoD from `gen` as the trainer does."""
    L, r = cfg["loss"], cfg["render"]
    res = r["lod_resolutions"]
    noise = torch.randn((batch["images_in"].shape[0],) + vae.latent_shape,
                        generator=gen).to(batch["images_in"].device)
    out = vae(batch["images_in"], batch["pcd"], noise)
    lods = out["lods"]
    lp = int(torch.randint(0, len(lods), (), generator=gen))
    total = 0.0
    renders = []
    for i, (g, rs) in enumerate(zip(lods, res)):
        rend = render(g, batch["cam_view"], batch["cam_view_proj"], rs,
                      r["max_per_tile"], r["chunk"])
        renders.append(rend)
        gt_img = resize_linear(batch["images_sup"], rs)
        gt_a = resize_linear(batch["alpha_sup"], rs)
        sub = L["l1_weight"] * (rend["image"] - gt_img).abs().mean() \
            + L["alpha_weight"] * ((rend["alpha"] - gt_a) ** 2).mean()
        if lp == i:
            sub = sub + L["perceptual_weight"] * lpips(
                rend["image"].flatten(0, 1), gt_img.flatten(0, 1))
        sub = sub + L["depth_weight"] * depth_loss(
            rend["depth"], resize_linear(batch["depth_sup"], rs), gt_a)
        total = total + sub
    kl_w = L["kl_target"] * min(max(step / L["kl_anneal_steps"], 0.0), 1.0)
    if kl_w:
        total = total + kl_w * out["kl"].mean()
    for key, start in (("dist_weight", "dist_start_step"),
                       ("normal_weight", "normal_start_step")):
        if step >= L[start]:
            raise NotImplementedError(f"{key} after step {L[start]}")
    total = total + L["scale_reg_weight"] * F.relu(
        lods[-1][..., 4:6] - 0.05).mean() \
        + L["opacity_reg_weight"] * opacity_reg(lods[-1])
    img = renders[-1]["image"]
    g_loss = -disc(img.flatten(0, 1)).mean()
    rec = L["l1_weight"] * (img - resize_linear(batch["images_sup"],
                                                res[-1])).abs().mean()
    g_rec, = torch.autograd.grad(rec, lods[-1], retain_graph=True)
    g_adv, = torch.autograd.grad(g_loss, lods[-1], retain_graph=True)
    w = torch.clamp(torch.linalg.vector_norm(g_rec)
                    / (torch.linalg.vector_norm(g_adv) + 1e-4),
                    0.0, 1e4).detach()
    if step >= L["adv_start_step"]:
        total = total + L["adv_weight"] * w * g_loss
    return total


def disc_loss(vae, disc, batch, cfg, gen):
    r = cfg["render"]
    res = r["lod_resolutions"][-1]
    noise = torch.randn((batch["images_in"].shape[0],) + vae.latent_shape,
                        generator=gen).to(batch["images_in"].device)
    with torch.no_grad():
        lods = vae(batch["images_in"], batch["pcd"], noise)["lods"]
        fake = render(lods[-1], batch["cam_view"], batch["cam_view_proj"],
                      res, r["max_per_tile"], r["chunk"])["image"]
        real = resize_linear(batch["images_sup"], res)
    return 0.5 * (F.relu(1.0 - disc(real.flatten(0, 1))).mean()
                  + F.relu(1.0 + disc(fake.flatten(0, 1))).mean())


class Adam:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay scaled by
    the learning rate) after clipping the global norm, the learning rate
    warmed up linearly from 0 over `warmup_steps` updates; the update
    count starts at `start_step` (a job resumed there, its moments
    zero)."""

    def __init__(self, params: Dict[str, torch.Tensor], o: dict):
        self.p, self.o, self.step = params, o, o.get("start_step", 0)
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]):
        o = self.o
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        scale = torch.where(norm < o["grad_clip"], torch.ones_like(norm),
                            o["grad_clip"] / norm)
        b1, b2 = o["betas"]
        n = self.step + 1
        lr = o["lr"] * min(self.step / o["warmup_steps"], 1.0)
        for k, p in self.p.items():
            g = grads[k] * scale
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.mu[k] / (1 - b1 ** n)) / (
                torch.sqrt(self.nu[k] / (1 - b2 ** n)) + 1e-8) \
                + o["weight_decay"] * p
            p.add_(upd, alpha=-lr)
        self.step += 1


def grads_of(total, params: Dict[str, torch.Tensor]):
    names = list(params)
    gs = torch.autograd.grad(total, [params[k] for k in names],
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, gs)}



# ----------------------------------------------------------------- check


def build(cfg: dict, seed: int, device):
    """The reference's VAE, VGG-LPIPS and discriminator with the seeded
    weights."""
    from benchmark import weights
    out = []
    for tag, make in (("vae", lambda: nets.build("vae", cfg["vae"])),
                      ("lpips", LPIPS), ("disc", PatchDisc)):
        with torch.device("meta"):
            m = make()
        weights.load(m, weights.make(seed, tag, weights.leaves(m), device))
        out.append(m)
    vae, lpips, disc = out
    return vae.train(), lpips.requires_grad_(False), disc


def follow(cfg: dict, seed: int, files: List[str], device) -> dict:
    """The set-up's two steps, as the program takes them from the
    optimiser's `start_step`: a generator step; a generator step and a
    discriminator step. Returns each loss,
    the first step's gradient as AdamW received it (clipped; from its
    first moment) and the parameters' change."""
    sd = seeds(seed)
    vae, lpips, disc = build(cfg, seed, device)
    params = dict(vae.named_parameters())
    dparams = dict(disc.named_parameters())
    opt, dopt = Adam(params, cfg["optim"]), Adam(dparams, cfg["optim"])
    bs = batches(files, cfg["data"], sd["data"], cfg["batch"], 2, device)
    gen = torch.Generator().manual_seed(sd["steps"])
    p0 = {k: v.detach().clone() for k, v in params.items()}
    out = {"losses": [], "first": {}}

    def first_forward(m, a, o):
        if not out["first"]:
            out["first"].update(z=o["z"].detach().clone(),
                                lods=[g.detach().clone() for g in o["lods"]])
    hook = vae.register_forward_hook(first_forward)
    for i, b in enumerate(bs):
        total = loss(vae, lpips, disc, b, opt.step, cfg, gen)
        opt.apply(grads_of(total, params))
        out["losses"].append(float(total.detach()))
        del total
        if i == 0:
            out["mu1"] = {k: m.clone() for k, m in opt.mu.items()}
    hook.remove()
    d = disc_loss(vae, disc, bs[1], cfg, gen)
    dopt.apply(grads_of(d, dparams))
    out["d_loss"] = float(d.detach())
    out["delta"] = {k: params[k].detach() - p0[k] for k in params}
    return out


def _leaf_gaps(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor], keep, name: str):
    """Over the leaves `keep`, each gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf: (the worst, the median); the worst three go
    to standard error."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keep}
    med = float(np.median(list(rn.values())))
    gap = {k: abs(float(torch.linalg.vector_norm(prog[k].float())) - rn[k])
           / max(rn[k], med, 1e-30) for k in keep}
    worst = sorted(gap, key=gap.get, reverse=True)[:3]
    print(f"{name}: median leaf {med:.4g}; worst "
          + ", ".join(f"{k} {gap[k]:.4g} (norm {rn[k]:.4g})" for k in worst),
          file=sys.stderr)
    return gap[worst[0]], float(np.median(list(gap.values())))


def compare(cfg: dict, prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers: `loss`, the largest relative gap of the two generator
    losses and the discriminator's (`loss_g1`, `loss_g2`, `loss_d`);
    `grad1`, the first gradient's worst leaf, and `grad1_median`, its
    median leaf; `update2` and `update2_median`, the same of the
    parameters' change after the two steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's
    (below it a leaf moves by round-off alone); of the first step's
    forward, `latent`, the encoder's sampled latent, and `decode`, the
    worst LoD and channel group of the gaussians, each the mean error
    relative to the reference's mean magnitude."""
    b1 = cfg["optim"]["betas"][0]
    g_p = {k: v / (1 - b1) for k, v in prog["mu1"].items()}
    g_r = {k: v / (1 - b1) for k, v in ref["mu1"].items()}
    if g_p.keys() != g_r.keys():
        return dict.fromkeys(("loss", "grad1", "grad1_median", "update2",
                              "update2_median", "latent", "decode"),
                             float("inf"))
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in g_r.items()}
    med = float(np.median(list(norms.values())))
    moved = [k for k, n in norms.items() if n >= 1e-3 * med]
    pairs = list(zip(prog["losses"] + [prog["d_loss"]],
                     ref["losses"] + [ref["d_loss"]]))
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in pairs]
    out = {"loss": max(gaps)}
    out.update(zip(("loss_g1", "loss_g2", "loss_d"), gaps))
    out["grad1"], out["grad1_median"] = _leaf_gaps(g_p, g_r, list(g_r),
                                                   "grad1")
    out["update2"], out["update2_median"] = _leaf_gaps(
        prog["delta"], ref["delta"], moved, "update2")
    pf, rf = prog["first"], ref["first"]
    out["latent"] = _rel_mean(pf["z"], rf["z"])
    out["decode"] = max(_rel_mean(got[..., a:b], want[..., a:b])
                        for got, want in zip(pf["lods"], rf["lods"])
                        for a, b in CHANNELS)
    if len(pf["lods"]) != len(rf["lods"]):
        out["decode"] = float("inf")
    return out


CHANNELS = ((0, 3), (3, 4), (4, 6), (6, 10), (10, 13))


def _rel_mean(got, ref) -> float:
    """The mean error relative to the reference's mean magnitude."""
    if got.shape != ref.shape:
        return float("inf")
    return float((got.float() - ref.float()).abs().mean()
                 / ref.float().abs().mean().clamp_min(1e-30))


def check(cfg: dict, seed: int, files: List[str], prog, device,
          control: bool = False) -> Dict[str, float]:
    """The numbers of the program's set-up steps `prog` against the
    reference; with `control`, of the reference itself one step lower."""
    from benchmark.reference.precision import control as control_policy
    from benchmark.reference.precision import ieee
    nets.CHECKPOINT["on"] = True
    with ieee():
        if control:
            with control_policy(cfg["precision"]["compute_dtype"]):
                prog = follow(cfg, seed, files, device)
        ref = follow(cfg, seed, files, device)
    prog = dict(prog, **{k: {n: t.to(device) for n, t in prog[k].items()}
                         for k in ("mu1", "delta")})
    prog["first"] = {"z": prog["first"]["z"].to(device),
                     "lods": [g.to(device) for g in prog["first"]["lods"]]}
    out = compare(cfg, prog, ref)
    print(f"checked steps: losses {prog['losses']} d {prog['d_loss']} "
          f"against {ref['losses']} d {ref['d_loss']}", file=sys.stderr)
    return out

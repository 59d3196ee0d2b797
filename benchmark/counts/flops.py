"""Model FLOPs counted from a configuration's shapes: 2 per multiply-add
of every matrix product and convolution (the projections, the attention
scores and their weighted sums, the MLPs), as
`torch.utils.flop_counter.FlopCounterMode` counts them; norms, softmax
and elementwise work are not counted. Never read from what the program
dispatches.
"""
from __future__ import annotations


def linear(tokens: int, d_in: int, d_out: int) -> int:
    return 2 * tokens * d_in * d_out


def self_attention(tokens: int, dim: int, groups: int = 1) -> int:
    """qkv and output projections over all tokens; scores and weighted sum
    within each of `groups` equal groups of tokens."""
    t = tokens // groups
    return linear(tokens, dim, 3 * dim) + linear(tokens, dim, dim) \
        + groups * 4 * t * t * dim


def cross_attention(tokens: int, dim: int, ctx: int, ctx_dim: int,
                    inner: int) -> int:
    return linear(tokens, dim, inner) + 2 * linear(ctx, ctx_dim, inner) \
        + 4 * tokens * ctx * inner + linear(tokens, inner, dim)


def mlp(tokens: int, d_in: int, hidden: int, d_out: int) -> int:
    return linear(tokens, d_in, hidden) + linear(tokens, hidden, d_out)


def dinov2(c: dict, batch: int = 1) -> int:
    g = c["img_size"] // c["patch"]
    w = c["width"]
    t = 1 + c["num_registers"] + g * g
    patch = 2 * g * g * 3 * c["patch"] ** 2 * w
    block = self_attention(t, w) + mlp(t, w, 4 * w, w)
    return batch * (patch + c["depth"] * block)


def dit(c: dict, tokens: int, ctx_tokens: int, batch: int) -> int:
    """One evaluation of the point DiT on `batch` rows."""
    w, cin = c["width"], c["in_channels"]
    per_row = mlp(tokens, cin, w, w) + linear(1, 256, w) + linear(1, w, w) \
        + linear(1, c["vector_dim"], w) + linear(1, w, 6 * w) \
        + linear(tokens, w, cin)
    if cin != 3:
        per_row += linear(tokens, 63, w)        # the xyz Fourier embedding
    block = cross_attention(tokens, w, ctx_tokens, c["cond_dim"], w) \
        + self_attention(tokens, w) + mlp(tokens, w, 4 * w, w)
    return batch * (per_row + c["depth"] * block)


def vae_decode(c: dict, batch: int = 1) -> int:
    K, w, z = c["latent_num"], c["decoder_width"], c["z_channels"]
    n = mlp(K, z, z, w) + linear(K, w, 13)
    for i in range(c["decoder_depth"]):
        n += linear(K, w, 6 * w) + mlp(K, w, 4 * w, w) \
            + self_attention(K, w, groups=3 if i % 2 == 0 else 1)
    parents = K
    for f, d in zip(c["up_factors"], c["up_depths"]):
        t = f + 1
        layer = self_attention(parents * t, w, groups=parents) \
            + mlp(parents * t, w, 4 * w, w)
        n += d * layer + linear(parents * f, w, 13)
        parents *= f
    return batch * n


def request(cfg: dict) -> int:
    """One image-to-3D request: the conditioner once per stage, each
    stage's CFG-doubled Heun evaluations, the decode."""
    g = cfg["conditioner"]["img_size"] // cfg["conditioner"]["patch"]
    evals = 2 * cfg["sampler"]["num_steps"]
    n = 0
    for d in (cfg["dit1"], cfg["dit2"]):
        n += dinov2(cfg["conditioner"]) \
            + evals * dit(d, cfg["vae"]["latent_num"], g * g, batch=2)
    return n + vae_decode(cfg["vae"])


def conv(n: int, h_out: int, w_out: int, c_in: int, c_out: int,
         k: int) -> int:
    return 2 * n * h_out * w_out * c_in * c_out * k * k


def _resblock(n, hw, c_in, c_out):
    f = conv(n, hw, hw, c_in, c_out, 3) + conv(n, hw, hw, c_out, c_out, 3)
    return f + (conv(n, hw, hw, c_in, c_out, 1) if c_in != c_out else 0)


def vae_encode(c: dict, batch: int, views: int, res: int) -> int:
    """The release encoder on `batch` × `views` 15-channel views: the SD
    trunk (ch 64, mults 1 2 4 4, the joint multi-view attention at its
    middle), the anchors' cross-attention to the tokens, three
    transformer blocks, the output MLP, the quant MLP."""
    n = batch * views
    ch, mult = 64, (1, 2, 4, 4)
    f = conv(n, res, res, 15, ch, 3)
    hw, cin = res, ch
    for i, m in enumerate(mult):
        f += _resblock(n, hw, cin, ch * m)
        cin = ch * m
        if i < len(mult) - 1:
            hw //= 2
            f += conv(n, hw, hw, cin, cin, 3)
    f += 2 * _resblock(n, hw, cin, cin)
    inner, t = 512, hw * hw
    f += linear(n * t, cin, inner) + linear(n * t, inner, cin)
    f += batch * self_attention(views * t, inner)           # joint
    f += self_attention(n * t, inner, groups=n)             # per view
    f += linear(n * t, inner, 2 * 4 * inner) \
        + linear(n * t, 4 * inner, inner)                   # GEGLU
    w, K = c["encoder_width"], c["latent_num"]
    tokens = views * t
    f += batch * (linear(tokens, 63, w) + linear(K, 63, w)
                  + cross_attention(K, w, tokens, w, 512)
                  + 3 * (self_attention(K, w) + mlp(K, w, 4 * w, w))
                  + mlp(K, w, w, 2 * c["z_channels"])
                  + mlp(K, 2 * c["z_channels"], 2 * c["z_channels"],
                        2 * c["z_channels"]))
    return f


_VGG = ((64, 1), (64, 1), (128, 2), (128, 2), (256, 4), (256, 4), (256, 4),
        (512, 8), (512, 8), (512, 8), (512, 16), (512, 16), (512, 16))


def lpips_vgg(n: int, res: int) -> int:
    """VGG16's thirteen 3×3 convolutions up to relu5_3 and LPIPS's five
    1×1 channel weightings, on `n` images."""
    f, c_in = 0, 3
    for c, down in _VGG:
        f += conv(n, res // down, res // down, c_in, c, 3)
        c_in = c
    for c, down in ((64, 1), (128, 2), (256, 4), (512, 8), (512, 16)):
        f += conv(n, res // down, res // down, c, 1, 1)
    return f


def patch_disc(n: int, res: int) -> int:
    """The PatchGAN: 4×4 convolutions 3→64 (stride 2), 64→128, 128→256
    (stride 2), 256→512, 512→1 (stride 1)."""
    hw = [res // 2, res // 4, res // 8, res // 8, res // 8]
    chans = [(3, 64), (64, 128), (128, 256), (256, 512), (512, 1)]
    return sum(conv(n, h, h, a, b, 4) for h, (a, b) in zip(hw, chans))


def train_step(cfg: dict) -> int:
    """One window step, a generator step and half a discriminator step:
    each network's forward, and twice it for its backward. The generator
    step runs the VAE, VGG-LPIPS on both images of one drawn LoD (the
    mean over the LoDs) and the discriminator on the finest renders; the
    discriminator step runs the VAE forward and the discriminator on
    real and rendered images."""
    B, d = cfg["batch"], cfg["data"]
    v = cfg["vae"]
    res = cfg["render"]["lod_resolutions"]
    n_sup = B * d["n_views_sup"]
    vae = vae_encode(v, B, d["n_views_in"], d["resolution"]) \
        + vae_decode(v, B)
    lp = sum(lpips_vgg(2 * n_sup, r) for r in res) // len(res)
    g_step = 3 * (vae + lp + patch_disc(n_sup, res[-1]))
    d_step = vae + 3 * patch_disc(2 * n_sup, res[-1])
    return g_step + d_step // 2

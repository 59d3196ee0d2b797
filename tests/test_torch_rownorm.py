"""The row-norm kernel's plain version and route (`ops/rownorm.py`,
`models/layers.norm_rows`, `layers.qk_norms`), on the CPU.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`). Here:
the plain version is the residual, `RMSNorm` and `modulate` the port had
before the kernel, bit for bit, in every mode; each reason of the rule
shows; a call with grad on, in bf16 or on the CPU keeps the plain version;
a call the rule takes reaches the wrapper with the caller's own tensors;
and the DiT blocks give the bits they gave before.
"""
from __future__ import annotations

import ctypes
import inspect
import re

import numpy as np
import pytest
import torch

from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.models.dit import ClayDiTBlock
from gaussiananything_tpu_torch.ops import kernel_lib
from gaussiananything_tpu_torch.ops import rownorm as rn


# ---- the port's expressions as they stood before the kernel, verbatim

def _old_rmsnorm(x, weight, eps=1e-5):
    x = x.float()
    ms = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * weight.float()


def _old_modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _old_block_forward(blk, x, cond_tokens, ada):
    """`ClayDiTBlock.forward` and `_cross` before the kernel."""
    def cross(x, ctx):
        if blk.variant == "clay":
            return blk.cross_attn_dino(blk.prenorm_ca_dino(x), ctx)
        if blk.attention_y_norm is not None:
            ctx = blk.attention_y_norm(ctx)
        return blk.cross_attn(blk.prenorm_ca_text(x), ctx)

    mod = ada + blk.scale_shift_table[None]
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = (mod[:, i, None] for i in range(6))
    if blk.variant == "clay":
        x = x + cross(x, cond_tokens)
    x = x + g_a * blk.attn(_old_modulate(blk.norm1(x), sh_a, sc_a))
    if blk.variant == "text":
        x = x + cross(x, cond_tokens)
    return x + g_m * blk.mlp(_old_modulate(blk.norm2(x), sh_m, sc_m))


def _t(r, *shape, dtype=torch.float32):
    return torch.tensor(r.normal(size=shape), dtype=dtype)


def _inputs(seed, B=2, N=12, D=64, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return dict(x=_t(r, B, N, D, dtype=dtype), y=_t(r, B, N, D, dtype=dtype),
                gate=_t(r, B, D), weight=1 + 0.1 * _t(r, D),
                shift=_t(r, B, D), scale=0.1 * _t(r, B, D))


# mode: which of y, gate, weight and shift/scale a call gives
MODES = {
    "norm": ("weight",),
    "norm+modulate": ("weight", "shift", "scale"),
    "residual+norm": ("y", "weight"),
    "residual+norm+modulate": ("y", "weight", "shift", "scale"),
    "gated+norm": ("y", "gate", "weight"),
    "gated+norm+modulate": ("y", "gate", "weight", "shift", "scale"),
    "residual": ("y",),
    "gated": ("y", "gate"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_is_the_old_expressions_bit_for_bit(mode):
    """`rownorm_plain` gives the bits of the old residual, `RMSNorm` and
    `modulate`, applied in that order, in every mode."""
    a = _inputs(0)
    kw = {k: a[k] for k in MODES[mode]}
    got_x, got_h = rn.rownorm_plain(a["x"], eps=1e-5, **kw)
    x = a["x"]
    if "y" in kw:
        g = a["gate"][:, None] if "gate" in kw else None
        x = x + (a["y"] if g is None else g * a["y"])
    assert torch.equal(got_x, x)
    if "weight" not in kw:
        assert got_h is None
        return
    h = _old_rmsnorm(x, a["weight"])
    if "scale" in kw:
        h = _old_modulate(h, a["shift"][:, None], a["scale"][:, None])
    assert torch.equal(got_h, h)


def test_plain_norms_heads_and_bf16_as_rmsnorm():
    """On (B, T, H, 64) heads and on bf16 input and weights the plain
    version is `RMSNorm`'s: fp32 out, the same bits."""
    r = np.random.default_rng(1)
    q = _t(r, 2, 10, 4, 64)
    w = 1 + 0.1 * _t(r, 64)
    assert torch.equal(rn.rownorm_plain(q, weight=w)[1], _old_rmsnorm(q, w))
    qb, wb = q.to(torch.bfloat16), w.to(torch.bfloat16)
    got = rn.rownorm_plain(qb, weight=wb)[1]
    assert got.dtype == torch.float32
    assert torch.equal(got, _old_rmsnorm(qb, wb))


# each case: what it changes from a call the kernel would take on the card,
# and the reasons the rule names for it (besides "device": on the CPU every
# call keeps the plain version)
REASON_CASES = {
    "taken": set(),
    "grad_x": {"grad"},
    "grad_weight": {"grad"},
    "bf16_x": {"dtype"},
    "bf16_weight": {"dtype"},
    "bf16_y": {"dtype"},
    "width_not_4": {"width"},
    "width_too_wide": {"width"},
    "y_shape": {"shape"},
    "gate_without_y": {"shape"},
    "vector_shape": {"shape"},
    "shift_without_scale": {"shape"},
    "five_dims": {"shape"},
    "strided_row": {"layout"},
    "unaligned_base": {"layout"},
}


def _reason_call(case):
    D = {"width_not_4": 66, "width_too_wide": 2048}.get(case, 64)
    a = _inputs(2, D=D, dtype=torch.bfloat16 if case == "bf16_x"
                else torch.float32)
    x, y, gate, w, shift, scale = (a[k] for k in ("x", "y", "gate", "weight",
                                                  "shift", "scale"))
    if case == "width_not_4":
        # rows 66 wide held 68 apart: the width alone is what is refused
        x, y, gate, shift, scale = (torch.cat([t, t[..., :2]], -1)[..., :66]
                                    for t in (x, y, gate, shift, scale))
    if case == "grad_x":
        x.requires_grad_(True)
    elif case == "grad_weight":
        w.requires_grad_(True)
    elif case == "bf16_weight":
        w = w.to(torch.bfloat16)
    elif case == "bf16_y":
        y = y.to(torch.bfloat16)
    elif case == "y_shape":
        y = y[:, :5]
    elif case == "gate_without_y":
        y = None
    elif case == "vector_shape":
        shift, scale = shift[:1], scale[:1]
    elif case == "shift_without_scale":
        scale = None
    elif case == "five_dims":
        x, y = x[None], y[None]
    elif case == "strided_row":
        x = torch.cat([x, x], -1)[..., ::2]
    elif case == "unaligned_base":
        x = torch.cat([x.flatten(), x.flatten()[:1]])[1:].reshape(x.shape)
    return x, y, gate, w, shift, scale


@pytest.mark.parametrize("case", sorted(REASON_CASES))
def test_plain_reasons_name_each_reason(case):
    x, y, gate, w, shift, scale = _reason_call(case)
    assert set(rn.plain_reasons(x, y, gate, w, shift, scale)) == \
        {"device"} | REASON_CASES[case]
    if case.startswith("grad"):
        with torch.no_grad():
            # grad off: the same tensors no longer keep the plain version
            assert "grad" not in rn.plain_reasons(x, y, gate, w, shift,
                                                  scale)


def test_packed_projection_views_meet_the_layout_rule():
    """The self-attention's q and k are views into the packed qkv
    projection, the adaLN vectors rows of the (B, 6, D) table: the rule
    does not refuse their strides."""
    for B, T, H in ((2, 768, 16), (1, 768, 12), (3, 9, 8)):
        qkv = torch.empty(B, T, 3 * H * 64).reshape(B, T, 3, H, 64)
        q, k, _ = qkv.unbind(2)
        assert rn.plain_reasons(q, weight=torch.ones(64)) == ["device"]
        assert rn.plain_reasons(k, weight=torch.ones(64)) == ["device"]
    mod = torch.empty(2, 6, 1024)
    x = torch.empty(2, 768, 1024)
    sh, sc, g = mod.unbind(1)[:3]
    assert rn.plain_reasons(x, x, g, torch.ones(1024), sh, sc) == ["device"]
    # a weight at any offset into one buffer of parameters (the benchmark's
    # seeded weights), vectors at any row stride: read a float at a time
    flat = torch.empty(1 + 64 + 2 * 67)
    w, vec = flat[1:65], flat[65:].reshape(2, 67)[:, :64]
    assert rn.plain_reasons(x[..., :64].contiguous(), weight=w, shift=vec,
                            scale=vec) == ["device"]
    assert not kernel_lib.aligned16(w) and not kernel_lib.aligned16(vec)


@pytest.fixture
def no_kernel(monkeypatch):
    """The wrappers replaced by ones that record their calls."""
    calls = []

    def fake(name):
        def call(*a, **kw):
            calls.append((name, a, kw))
            raise AssertionError(f"{name} reached on a call kept plain")
        return call

    monkeypatch.setattr(rn, "rownorm", fake("rownorm"))
    monkeypatch.setattr(rn, "rownorm_pair", fake("rownorm_pair"))
    return calls


@pytest.mark.parametrize("case", ["cpu", "grad", "bf16"])
def test_route_keeps_the_plain_version(case, no_kernel):
    """A call on the CPU, one with grad on and one in bf16 keep the plain
    version: `RMSNorm`, the fused block modes and the q/k pair give the old
    bits (and, under grad, the old gradients), and no wrapper is reached."""
    counted = dict(rn.plain)
    a = _inputs(3, dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    norm = layers.RMSNorm(64)
    with torch.no_grad():
        norm.weight.copy_(a["weight"])
    x, y = a["x"], a["y"]
    if case == "grad":
        x.requires_grad_(True)
        assert "grad" in rn.plain_reasons(x, weight=norm.weight)
    got = norm(x)
    assert torch.equal(got, _old_rmsnorm(x, norm.weight))
    xo, h = layers.norm_rows(x, norm, y, a["gate"], a["shift"], a["scale"])
    ref_x = x + a["gate"][:, None] * y
    ref_h = _old_modulate(_old_rmsnorm(ref_x, norm.weight),
                          a["shift"][:, None], a["scale"][:, None])
    assert torch.equal(xo, ref_x) and torch.equal(h, ref_h)
    q = x.reshape(2, 12, 4, 16)
    hq, hk = layers.qk_norms(q, q, layers.RMSNorm(16), layers.RMSNorm(16))
    assert torch.equal(hq, _old_rmsnorm(q, torch.ones(16)))
    if case == "grad":
        g = torch.randn_like(h)
        got_g = torch.autograd.grad(h, (x, norm.weight), g)
        ref_g = torch.autograd.grad(ref_h, (x, norm.weight), g)
        assert all(torch.equal(p, r) for p, r in zip(got_g, ref_g))
    assert not no_kernel
    # the CPU's calls are not counted: the counter is of CUDA calls
    assert rn.plain == counted


def test_a_taken_call_reaches_the_wrapper_uncopied(monkeypatch):
    """Where the rule takes a call, `norm_rows`, `RMSNorm` and `qk_norms`
    hand the wrappers the caller's tensors as they are (the packed qkv
    projection's views and the adaLN table's rows too) with the norm's
    weight and eps, and return the wrappers' outputs."""
    seen = []

    def fake(x, y=None, gate=None, weight=None, eps=None, shift=None,
             scale=None):
        seen.append((x, y, gate, weight, eps, shift, scale))
        return x, torch.full_like(x, 7.0)

    def fake_pair(q, wq, eq, k, wk, ek):
        seen.append((q, wq, eq, k, wk, ek))
        return torch.full_like(q, 5.0), torch.full_like(k, 6.0)

    monkeypatch.setattr(rn, "plain_reasons", lambda *a, **kw: [])
    monkeypatch.setattr(rn, "rownorm", fake)
    monkeypatch.setattr(rn, "rownorm_pair", fake_pair)
    norm = layers.RMSNorm(64, eps=1e-6)
    a = _inputs(4)
    mod = torch.randn(2, 6, 64)
    sh, sc, g = mod.unbind(1)[:3]
    x_out, h = layers.norm_rows(a["x"], norm, a["y"], g, sh, sc)
    assert x_out is a["x"] and torch.equal(h, torch.full_like(a["x"], 7.0))
    assert torch.equal(norm(a["x"]), torch.full_like(a["x"], 7.0))
    (x, y, gg, w, eps, s, c), (x2, *_) = seen[:2]
    assert x is a["x"] and y is a["y"] and w is norm.weight and eps == 1e-6
    for got, ref in ((gg, g), (s, sh), (c, sc)):
        assert got.data_ptr() == ref.data_ptr()
        assert got.stride() == ref.stride() == (6 * 64, 1)
    qkv = torch.randn(2, 12, 3 * 4 * 64).reshape(2, 12, 3, 4, 64)
    q, k, _ = qkv.unbind(2)
    qn, kn = layers.RMSNorm(64), layers.RMSNorm(64, eps=1e-6)
    hq, hk = layers.qk_norms(q, k, qn, kn)
    assert torch.equal(hq, torch.full_like(q, 5.0))
    assert torch.equal(hk, torch.full_like(k, 6.0))
    gq, wq, eq, gk, wk, ek = seen[-1]
    assert gq.data_ptr() == q.data_ptr() and gq.stride() == q.stride()
    assert gk.data_ptr() == k.data_ptr() and gk.stride() == k.stride()
    assert (wq, eq, wk, ek) == (qn.weight, 1e-5, kn.weight, 1e-6)


def _block(variant, release_parity, seed=0, dim=64, heads=4, ctx=48):
    torch.manual_seed(seed)
    blk = ClayDiTBlock(dim, heads, ctx, release_parity=release_parity,
                       variant=variant)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return blk


@pytest.mark.parametrize("release_parity", [True, False])
@pytest.mark.parametrize("variant", ["clay", "text"])
def test_dit_block_gives_the_old_bits_on_the_cpu(variant, release_parity):
    """`ClayDiTBlock.forward` on the CPU, through the plain route, gives
    the old block's output bit for bit, and under grad the old gradients."""
    blk = _block(variant, release_parity)
    r = np.random.default_rng(5)
    x, cond = _t(r, 2, 10, 64), _t(r, 2, 7, 48)
    ada = 0.1 * _t(r, 2, 6, 64)
    with torch.no_grad():
        assert torch.equal(blk(x, cond, ada),
                           _old_block_forward(blk, x, cond, ada))
    x.requires_grad_(True)
    got, ref = blk(x, cond, ada), _old_block_forward(blk, x, cond, ada)
    assert torch.equal(got, ref)
    params = [blk.norm1.weight, blk.norm2.weight, blk.scale_shift_table]
    got_g = torch.autograd.grad(got.sum(), [x] + params)
    ref_g = torch.autograd.grad(ref.sum(), [x] + params)
    assert all(torch.equal(a, b) for a, b in zip(got_g, ref_g))


@pytest.mark.parametrize("qk_norm_in", ["self", "cross"])
def test_attention_qk_norms_give_the_old_bits_on_the_cpu(qk_norm_in):
    """`Attention` and `CrossAttention` with q/k norms give the old bits
    on the CPU (each norm through `RMSNorm`'s plain route)."""
    torch.manual_seed(6)
    r = np.random.default_rng(6)
    x = _t(r, 2, 9, 64)
    if qk_norm_in == "self":
        m = layers.Attention(64, 4, qk_norm=True)
    else:
        m = layers.CrossAttention(64, 48, 4, qk_norm=True)
        ctx = _t(r, 2, 11, 48)
    with torch.no_grad():
        m.q_norm.weight.add_(0.1 * torch.randn(16))
        m.k_norm.weight.add_(0.1 * torch.randn(16))
        if qk_norm_in == "self":
            got = m(x)
            qkv = m.qkv(x).reshape(2, 9, 3, 4, 16)
            q, k, v = qkv.unbind(2)
            ctx_v = v
        else:
            got = m(x, ctx)
            q = m.to_q(x).reshape(2, 9, 4, 16)
            k = m.to_k(ctx).reshape(2, 11, 4, 16)
            ctx_v = m.to_v(ctx).reshape(2, 11, 4, 16)
        q = _old_rmsnorm(q, m.q_norm.weight)
        k = _old_rmsnorm(k, m.k_norm.weight)
        o = layers.dot_attention(q, k, ctx_v).reshape(2, 9, 64)
        ref = m.proj(o) if qk_norm_in == "self" else m.to_out(o)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad,match", [
    ("cpu", "CUDA tensor"), ("meta", "CUDA tensor"), ("dtype", "float32"),
    ("grad", "forward only"), ("width", "multiple of 4"),
    ("shape", "takes y of its shape"), ("nothing", "nothing to compute"),
    ("layout", "unit stride")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The wrapper raises before any build or launch: a CPU tensor (the
    wrapper has no plain fallback; `norm_rows` routes those) and a `meta`
    one, standing in for a device that is not a card, among them."""
    dev = "cpu" if bad == "cpu" else "meta"
    D = 66 if bad == "width" else 64
    x = torch.empty(2, 8, D, device=dev, requires_grad=bad == "grad",
                    dtype=torch.bfloat16 if bad == "dtype" else torch.float32)
    w = torch.ones(D, device=dev)
    y = torch.empty(2, 7 if bad == "shape" else 8, D, device=dev)
    kw = dict(weight=w, y=y)
    if bad == "nothing":
        kw = {}
    elif bad == "layout":
        kw["y"] = torch.empty(2, 8, 2 * D, device=dev)[..., ::2]
    before = (rn.rownorm.launches, rn.rownorm.norms)
    with pytest.raises(ValueError, match=match):
        rn.rownorm(x, **kw)
    assert (rn.rownorm.launches, rn.rownorm.norms) == before


def test_pair_wrapper_refuses_two_widths():
    q = torch.empty(2, 8, 4, 64, device="meta")
    k = torch.empty(2, 8, 4, 32, device="meta")
    with pytest.raises(ValueError, match="differ in width"):
        rn.rownorm_pair(q, torch.ones(64), 1e-5, k, torch.ones(32), 1e-5)


# every reason of the kernel's rule (`rownorm._refusals`), and the case of
# `_reason_call` that has it
REFUSALS = {"device": "taken", "grad": "grad_x", "dtype": "bf16_y",
            "width": "width_not_4", "widths": None, "shape": "y_shape",
            "layout": "strided_row", "empty": "taken", "nothing": "taken"}


@pytest.mark.parametrize("reason", list(REFUSALS))
def test_route_and_wrappers_refuse_by_one_rule(reason, monkeypatch):
    """A call with one reason of the rule (and "device", as every call on
    the CPU has) is kept plain by the route under that reason, and the
    wrapper (`rownorm_pair` for two widths) raises ValueError with that
    reason's message, before any build or launch: the route and the
    refusal cannot drift apart."""
    pattern = r'why\.append\(\("(\w+)"'
    assert re.findall(pattern, inspect.getsource(rn._refusals)) \
        == list(REFUSALS)
    if reason == "widths":
        q, k = torch.randn(2, 8, 4, 64), torch.randn(2, 8, 4, 32)
        kw = dict(x=q, weight=torch.ones(64), k=k, k_weight=torch.ones(32))

        def call():
            rn.rownorm_pair(q, kw["weight"], 1e-5, k, kw["k_weight"], 1e-5)
    else:
        x, y, gate, w, shift, scale = _reason_call(REFUSALS[reason])
        if reason == "empty":
            x, y = x[:, :0], y[:, :0]
        elif reason == "nothing":
            y = gate = w = shift = scale = None
        kw = dict(x=x, y=y, gate=gate, weight=w, shift=shift, scale=scale)

        def call():
            rn.rownorm(**kw)
    why = rn._refusals(**kw)
    assert [r for r, _ in why] == sorted({"device", reason},
                                         key=list(REFUSALS).index)
    assert rn.plain_reasons(**kw) == [r for r, _ in why]
    monkeypatch.setattr(kernel_lib, "build", lambda: pytest.fail("built"))
    before = (rn.rownorm.launches, rn.rownorm.norms)
    with pytest.raises(ValueError) as err:
        call()
    assert dict(why)[reason] in str(err.value)
    assert (rn.rownorm.launches, rn.rownorm.norms) == before


def test_job_layout_and_frames():
    """`_Job` lays its fields out as `struct Job` of `csrc/rownorm.cu`
    (twenty 8-byte fields, then the fp32 eps and the int flag), and a
    2-, 3- or 4-dim x maps onto the kernel's (B, N, H) frame of rows."""
    assert ctypes.sizeof(rn._Job) == 20 * 8 + 8
    assert (rn._Job.eps.offset, rn._Job.vec4.offset) == (20 * 8, 20 * 8 + 4)
    assert [getattr(rn._Job, f).offset for f in ("x", "y", "gate", "w",
                                                 "xo", "B")] == \
        [0, 32, 64, 80, 120, 136]
    assert rn._frame(torch.empty(5, 8)) == ([1, 5, 1], [0, 8, 0])
    assert rn._frame(torch.empty(2, 5, 8)) == ([2, 5, 1], [40, 8, 0])
    qkv = torch.empty(2, 5, 3, 4, 8)
    assert rn._frame(qkv[:, :, 1]) == ([2, 5, 4], [480, 96, 8])

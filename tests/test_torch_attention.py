"""`models/layers.dot_attention`'s route between the fused attention kernel
(`ops/attention.attention`) and the plain version, on the CPU.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`). Here:
the plain version is the attention the port had before the kernel, bit for
bit; each call the kernel must not take keeps it, bit for bit, forward and
backward; and a call it does take reaches the wrapper with the caller's
own tensors, untransposed and uncopied.
"""
from __future__ import annotations

import inspect
import math
import re
from typing import Optional

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from gaussiananything_tpu_torch.models import layers
from gaussiananything_tpu_torch.ops import attention as attention_ops
from gaussiananything_tpu_torch.ops import kernel_lib
from gaussiananything_tpu_torch.utils import precision


# ---- the port's attention as it stood before the kernel, copied verbatim

def _old_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _old_dot_attention(q, k, v, bias=None):
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    T, S = q.shape[2], k.shape[2]
    if bias is not None:
        if T * S > layers._SCORES_BLOCK_THRESHOLD:
            raise ValueError("a score bias is taken only below the block "
                             "threshold")
        return _old_attend(q, k, v, bias).transpose(1, 2)
    if T * S > layers._SCORES_BLOCK_THRESHOLD:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            def block(qb):
                return checkpoint(_old_attend, qb, k, v, use_reentrant=False)
        else:
            def block(qb):
                return _old_attend(qb, k, v)
        out = torch.cat([block(q[:, :, i:i + layers._QUERY_BLOCK])
                         for i in range(0, T, layers._QUERY_BLOCK)], dim=2)
    else:
        out = _old_attend(q, k, v)
    return out.transpose(1, 2)


@pytest.fixture
def tf32_policy():
    """The entry points' policy (TF32 products, the flag the route reads),
    restored after the test."""
    old = torch.backends.cuda.matmul.fp32_precision
    precision.set_policy("default")
    yield
    torch.backends.cuda.matmul.fp32_precision = old


def _qkv(seed, B=2, T=80, S=72, H=2, D=64, dtype=torch.float32):
    r = np.random.default_rng(seed)
    q = torch.tensor(r.normal(size=(B, T, H, D)), dtype=dtype)
    k = torch.tensor(r.normal(size=(B, S, H, D)), dtype=dtype)
    v = torch.tensor(r.normal(size=(B, S, H, D)), dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("case", ["plain", "bias", "bf16", "small"])
def test_attention_plain_is_the_old_attend_bit_for_bit(case):
    q, k, v = _qkv(0, T=24, S=40, D=8 if case == "small" else 64,
                   dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    bias = None
    if case == "bias":
        bias = torch.triu(torch.full((24, 40), float("-inf")), 1)[None, None]
    got = attention_ops.attention_plain(q, k, v, bias)
    assert got.dtype == q.dtype
    assert torch.equal(got, _old_attend(q, k, v, bias))
    assert layers._attend is attention_ops.attention_plain


# each case: what it changes from a call the kernel would take on the card,
# and the reason the route names for it (besides "device": on the CPU
# every call keeps the plain version)
ROUTE_CASES = {
    "taken": set(),
    "grad": {"grad"},
    "bias": {"bias"},
    "bf16": {"dtype"},
    "ieee": {"policy"},
    "no_policy": {"policy"},
    "head_dim_32": {"head_dim"},
    "few_queries": {"tokens"},
    "few_keys": {"tokens"},
    "upsampler_group": {"tokens"},
    "broadcast_batch": {"shape"},
    "strided_head_dim": {"layout"},
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_keeps_the_plain_version_case_by_case(case, tf32_policy):
    """Each excluded case names its own reason, and `dot_attention` gives
    the bits (and, under grad, the gradients) of the attention the port
    had before the kernel."""
    kw = {}
    if case == "few_queries":
        kw = dict(T=48)
    elif case == "few_keys":
        kw = dict(S=63)
    elif case == "upsampler_group":
        kw = dict(B=6, T=9, S=9, H=8)
    elif case == "head_dim_32":
        kw = dict(D=32)
    elif case == "bf16":
        kw = dict(dtype=torch.bfloat16)
    q, k, v = _qkv(1, **kw)
    bias = None
    if case == "bias":
        bias = torch.zeros((1, 1, q.shape[1], k.shape[1]))
    elif case == "ieee":
        precision.set_policy("highest")
    elif case == "no_policy":
        torch.backends.cuda.matmul.fp32_precision = "none"
    elif case == "broadcast_batch":
        k, v = k[:1], v[:1]
    elif case == "strided_head_dim":
        q = torch.cat([q, q], -1)[..., ::2]
    if case == "grad":
        q.requires_grad_(True)
        k.requires_grad_(True)
    assert set(attention_ops.plain_reasons(q, k, v, bias)) == \
        {"device"} | ROUTE_CASES[case]
    if case == "broadcast_batch":
        return      # the plain version broadcasts what the kernel refuses
    got = layers.dot_attention(q, k, v, bias)
    ref = _old_dot_attention(q, k, v, bias)
    assert torch.equal(got, ref)
    if case == "grad":
        g = torch.randn_like(got)
        got_g = torch.autograd.grad(got, (q, k), g)
        ref_g = torch.autograd.grad(ref, (q, k), g)
        assert all(torch.equal(a, b) for a, b in zip(got_g, ref_g))
        with torch.no_grad():
            # grad off: the same tensors no longer keep the plain version
            assert "grad" not in attention_ops.plain_reasons(q, k, v)


def test_route_keeps_the_blocked_path(monkeypatch, tf32_policy):
    """Above the block threshold a call that keeps the plain version runs
    in query blocks as before, with and without grad."""
    monkeypatch.setattr(layers, "_SCORES_BLOCK_THRESHOLD", 1000)
    monkeypatch.setattr(layers, "_QUERY_BLOCK", 32)
    q, k, v = _qkv(2)
    assert torch.equal(layers.dot_attention(q, k, v),
                       _old_dot_attention(q, k, v))
    q.requires_grad_(True)
    got, ref = layers.dot_attention(q, k, v), _old_dot_attention(q, k, v)
    assert torch.equal(got, ref)
    assert torch.equal(torch.autograd.grad(got.sum(), q)[0],
                       torch.autograd.grad(ref.sum(), q)[0])


@pytest.mark.parametrize("packed", [False, True])
def test_a_taken_call_reaches_the_kernel_uncopied(monkeypatch, packed):
    """Where the rule takes a call, `dot_attention` hands the wrapper the
    caller's (B,T,H,64) tensors as they are (the packed qkv projection's
    views too) and returns the wrapper's output: no transpose, no copy."""
    seen = []

    def fake(q, k, v):
        seen.append((q, k, v))
        return torch.full_like(q, 7.0)

    monkeypatch.setattr(attention_ops, "plain_reasons", lambda *a: [])
    monkeypatch.setattr(attention_ops, "attention", fake)
    if packed:
        qkv = torch.randn(2, 80, 3 * 2 * 64).reshape(2, 80, 3, 2, 64)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = _qkv(3)
    out = layers.dot_attention(q, k, v)
    assert torch.equal(out, torch.full_like(q, 7.0))
    (gq, gk, gv), = seen
    for a, b in ((gq, q), (gk, k), (gv, v)):
        assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


def test_packed_projection_views_meet_the_layout_rule():
    """The self-attention's q, k, v are views into the packed qkv
    projection (`layers.Attention`): their strides and bases are what the
    kernel's 16-byte copies read, so the rule does not refuse them."""
    for B, T, H in ((2, 768, 16), (1, 1374, 16), (3, 65, 12)):
        qkv = torch.empty(B, T, 3 * H * 64).reshape(B, T, 3, H, 64)
        assert all(kernel_lib.aligned16(t) for t in qkv.unbind(2))
    assert not kernel_lib.aligned16(torch.empty(2, 80, 2, 65)[..., 1:])


@pytest.mark.parametrize("bad,match", [
    ("cpu", "CUDA tensor"), ("meta", "CUDA tensor"), ("dtype", "float32"),
    ("head_dim", "tokens, H, 64"), ("frame", "disagree"),
    ("grad", "forward only")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The wrapper raises before any build or launch: a CPU tensor (the
    wrapper has no plain fallback; `dot_attention` routes those) and a
    `meta` one, standing in for a device that is not a card, among them."""
    dev = "cpu" if bad == "cpu" else "meta"
    D = 32 if bad == "head_dim" else 64
    dtype = torch.bfloat16 if bad == "dtype" else torch.float32
    q = torch.empty(2, 64, 2, D, device=dev, dtype=dtype)
    k = torch.empty(1 if bad == "frame" else 2, 64, 2, D, device=dev,
                    dtype=dtype, requires_grad=bad == "grad")
    before = attention_ops.attention.launches
    with pytest.raises(ValueError, match=match):
        attention_ops.attention(q, k, k)
    assert attention_ops.attention.launches == before


# every reason of the kernel's rule (`attention._refusals`)
REFUSALS = ["device", "grad", "dtype", "head_dim", "shape", "empty",
            "layout"]


@pytest.mark.parametrize("reason", REFUSALS)
def test_route_and_wrapper_refuse_by_one_rule(reason, tf32_policy,
                                              monkeypatch):
    """A call with one reason of the rule (and "device", as every call on
    the CPU has) is kept plain by the route under that reason, and the
    wrapper raises ValueError with that reason's message, before any build
    or launch: the route and the refusal cannot drift apart."""
    pattern = r'why\.append\(\("(\w+)"'
    assert re.findall(pattern, inspect.getsource(
        attention_ops._refusals)) == REFUSALS
    q, k, v = _qkv(7, D=32 if reason == "head_dim" else 64)
    if reason == "empty":
        q, k, v = q[:0], k[:0], v[:0]
    elif reason == "grad":
        q.requires_grad_(True)
    elif reason == "dtype":
        v = v.double()
    elif reason == "shape":
        k, v = k[:1], v[:1]
    elif reason == "layout":
        q = torch.cat([q, q], -1)[..., ::2]
    why = attention_ops._refusals(q, k, v)
    assert [r for r, _ in why] == sorted({"device", reason},
                                         key=REFUSALS.index)
    assert attention_ops.plain_reasons(q, k, v) == [r for r, _ in why]
    monkeypatch.setattr(kernel_lib, "build", lambda: pytest.fail("built"))
    before = attention_ops.attention.launches
    with pytest.raises(ValueError) as err:
        attention_ops.attention(q, k, v)
    assert dict(why)[reason] in str(err.value)
    assert attention_ops.attention.launches == before

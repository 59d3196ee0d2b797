"""`PointDiT.forward`'s CUDA-graph path, what of it runs on the CPU: the
forward there is the eager body, and the key a graph is held to changes
exactly when a replay would compute something else. The capture and the
replay themselves are held on the card (`tests/test_torch_cuda.py`,
`test_dit_graph_*`)."""
from __future__ import annotations

import copy

import pytest
import torch

from gaussiananything_tpu_torch.models.dit import PointDiT, _ForwardGraphs
from gaussiananything_tpu_torch.utils import precision


def _dit(stage: int) -> PointDiT:
    torch.manual_seed(0)
    return PointDiT(in_channels=3 if stage == 1 else 10, width=64, depth=2,
                    heads=4, cond_dim=32, vector_dim=32,
                    use_xyz_pe=stage == 2).eval()


def _args(stage: int, batch: int = 2, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    ch = 3 if stage == 1 else 10
    return (torch.randn((batch, 16, ch), generator=g),
            torch.rand((batch,), generator=g),
            torch.randn((batch, 9, 32), generator=g),
            torch.randn((batch, 32), generator=g),
            torch.randn((batch, 16, 3), generator=g) if stage == 2 else None)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("grad", [False, True])
def test_forward_on_the_cpu_is_the_body(stage, grad):
    m = _dit(stage)
    args = _args(stage)
    with torch.set_grad_enabled(grad):
        for _ in range(3):
            got = m(*args[:4], xyz=args[4])
            assert torch.equal(got, m._forward_body(*args))
    assert not m._graphs.entries


@pytest.mark.parametrize("stage", [1, 2])
def test_key_holds_across_repeated_calls_and_new_input_data(stage):
    m = _dit(stage)
    args = _args(stage)
    key = m._graphs.key(m, args)
    assert m._graphs.key(m, args) == key
    # other values at the same shapes: the graph copies them in
    assert m._graphs.key(m, _args(stage, seed=7)) == key
    # an in-place update keeps every address; a replay reads the values
    with torch.no_grad():
        m.blocks[0].mlp.fc1.weight.add_(1.0)
        m.load_state_dict({k: v + 1 for k, v in m.state_dict().items()})
    assert m._graphs.key(m, args) == key


def _swap_one(m, args):
    p = m.blocks[1].attn.qkv.weight
    m.blocks[1].attn.qkv._parameters["weight"] = p.detach().clone()
    return m._graphs.key(m, args)


def _functional_call(m, args):
    # the key as the forward sees it inside the call (EMA sampling)
    keys = []
    hook = m.register_forward_pre_hook(
        lambda mod, _: keys.append(mod._graphs.key(mod, args)))
    params = {k: v.detach().clone() for k, v in m.named_parameters()}
    with torch.no_grad():
        torch.func.functional_call(m, params, args[:4], {"xyz": args[4]})
    hook.remove()
    return keys[0]


def _to_bf16(m, args):
    m.to(torch.bfloat16)
    return m._graphs.key(m, args)


def _policy(m, args):
    precision.set_policy("default" if torch.backends.cuda.matmul
                         .fp32_precision == "ieee" else "highest")
    return m._graphs.key(m, args)


@pytest.mark.parametrize("change", [_swap_one, _functional_call, _to_bf16,
                                    _policy],
                         ids=["one_parameter", "functional_call", "bf16",
                              "matmul_policy"])
def test_key_changes_with_the_state_a_capture_reads(change):
    m = _dit(2)
    args = _args(2)
    before = (torch.backends.cuda.matmul.fp32_precision,
              torch.backends.cudnn.conv.fp32_precision)
    try:
        key = m._graphs.key(m, args)
        assert change(m, args) != key
        if change is _functional_call:     # the module's own weights again
            assert m._graphs.key(m, args) == key
    finally:
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = before


@pytest.mark.parametrize("stage", [1, 2])
def test_key_changes_with_the_inputs_shapes_and_dtypes(stage):
    m = _dit(stage)
    args = _args(stage)
    key = m._graphs.key(m, args)
    assert m._graphs.key(m, _args(stage, batch=4)) != key
    wider = list(args)
    wider[2] = torch.randn(2, 10, 32)
    assert m._graphs.key(m, tuple(wider)) != key
    cast = list(args)
    cast[0] = args[0].double()
    assert m._graphs.key(m, tuple(cast)) != key
    other = list(args)
    other[4] = torch.randn(2, 16, 3) if stage == 1 else None
    assert m._graphs.key(m, tuple(other)) != key
    with torch.inference_mode():
        assert m._graphs.key(m, args) != key


def test_copies_and_pickles_start_with_no_graph():
    m = _dit(1)
    m._graphs.key(m, _args(1))
    m._graphs.entries["k"] = None
    for other in (copy.deepcopy(m), copy.copy(m._graphs)):
        graphs = other._graphs if isinstance(other, PointDiT) else other
        assert isinstance(graphs, _ForwardGraphs)
        assert not graphs.entries and graphs.tensors is None
    c = copy.deepcopy(m)
    args = _args(1)
    with torch.no_grad():
        assert torch.equal(c(*args[:4]), m(*args[:4]))

"""Text conditioning of the port against the JAX package: the byte and
CLIP BPE tokenizers (integer-equal, on a merges file the test writes), the
byte-token `TextTransformer`, the OpenCLIP text tower (tokens and pooled),
both `TextConditioner` backbones, the scratch `VisionTransformer` and the
text-variant DiT block, on seeded weights carried by `from_jax_params`.

Tolerances: the conditioners rtol/atol 2e-4 (`tests/test_conditioners.py:
138-141,220-223`); the DiTs atol 2e-4 / rtol 1e-3
(`tests/test_dit_release_import.py:87`), at a width where d/heads ≠ 64 so
the text block's fixed 64-wide cross-attention heads are exercised.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiananything_tpu.models import conditioner as jcond
from gaussiananything_tpu.models import openclip_text as jclip
from gaussiananything_tpu.models.dit import PointDiT as JPointDiT
from gaussiananything_tpu.models.dit import stage1_dit as jstage1_dit
from gaussiananything_tpu_torch.models import conditioner as cond
from gaussiananything_tpu_torch.models import openclip_text as clip
from gaussiananything_tpu_torch.models.dit import PointDiT, stage1_dit
from test_torch_models import carry, close, japply, randomize, t

torch.set_num_threads(2)

COND_TOL = dict(rtol=2e-4, atol=2e-4)
DIT_TOL = dict(atol=2e-4, rtol=1e-3)
W, DEPTH, HEADS, L = 64, 2, 4, 77
TEXTS = ["a red chair", "Sci_fi  helmet &amp; visor, 2 horns",
         "an extremely long prompt " * 8]


def _merges(tmp_path):
    merges = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>",
              "l o</w>", "c h", "ch a", "cha i", "chai r</w>", "r e", "re d</w>"]
    path = tmp_path / "bpe_vocab.txt"
    path.write_text("\n".join(merges) + "\n")
    return str(path)


def test_tokenize_bytes_equal():
    got = cond.tokenize_bytes(TEXTS + ["ünïcödé"])
    ref = jcond.tokenize_bytes(TEXTS + ["ünïcödé"])
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("max_len", [8, 77])
def test_clip_bpe_equal(tmp_path, max_len):
    """Merges, specials, truncation keeping the eot, '_' as punctuation."""
    path = _merges(tmp_path)
    texts = TEXTS + ["hello hello", "red chair", "lo", "sci_fi", "sci fi"]
    got = clip.ClipBPETokenizer(path)(texts, max_len=max_len)
    ref = jclip.ClipBPETokenizer(path)(texts, max_len=max_len)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    tok = clip.ClipBPETokenizer(path)
    assert got[0, 0] == tok.sot and (got == tok.eot).sum(1).min() == 1
    assert clip.load_clip_tokenizer(None) is None
    with pytest.raises(FileNotFoundError):
        clip.load_clip_tokenizer(str(tmp_path / "absent.txt.gz"))


def _ids(seed, vocab):
    r = np.random.default_rng(seed)
    ids = r.integers(1, vocab - 2, size=(2, L)).astype(np.int32)
    ids[0, 9:] = 0                            # a padded prompt
    ids[0, 8] = vocab - 1                     # its eot (the argmax)
    ids[1, 40] = vocab - 1
    return ids


def test_text_transformer():
    ids = _ids(0, 257)
    jm = jcond.TextTransformer(width=W, depth=DEPTH, heads=HEADS)
    p = randomize(jm, 1, jnp.asarray(ids))
    ref_tok, ref_pool = japply(jm, p, jnp.asarray(ids))
    pm = carry(p, cond.TextTransformer(width=W, depth=DEPTH, heads=HEADS))
    with torch.no_grad():
        tok, pool = pm(torch.from_numpy(ids).long())
    close(tok, ref_tok, **COND_TOL)
    close(pool, ref_pool, **COND_TOL)


def test_openclip_tower():
    """Tokens before ln_final; pooled = ln_final → the eot row →
    text_projection (a non-square one here, so a transpose would show)."""
    ids = _ids(1, 49408)
    jm = jclip.OpenClipTextTower(width=W, depth=DEPTH, heads=HEADS,
                                 embed_dim=48)
    p = randomize(jm, 2, jnp.asarray(ids))
    ref_tok, ref_pool = japply(jm, p, jnp.asarray(ids))
    pm = carry(p, clip.OpenClipTextTower(width=W, depth=DEPTH, heads=HEADS,
                                         embed_dim=48))
    with torch.no_grad():
        tok, pool = pm(torch.from_numpy(ids))
    close(tok, ref_tok, **COND_TOL)
    close(pool, ref_pool, **COND_TOL)


@pytest.mark.parametrize("backbone", ["bytes", "openclip"])
def test_text_conditioner(backbone):
    ids = _ids(2, 257 if backbone == "bytes" else 49408)
    jm = jcond.TextConditioner(width=W, depth=DEPTH, heads=HEADS,
                               backbone=backbone)
    p = randomize(jm, 3, jnp.asarray(ids))
    ref = japply(jm, p, jnp.asarray(ids))
    pm = carry(p, cond.TextConditioner(width=W, depth=DEPTH, heads=HEADS,
                                       backbone=backbone))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long())
    close(got.crossattn, ref.crossattn, **COND_TOL)
    close(got.vector, ref.vector, **COND_TOL)
    u, ju = pm.unconditional(2), jm.unconditional(2)
    assert u.crossattn.shape == ju.crossattn.shape
    assert u.vector.shape == ju.vector.shape


@pytest.mark.parametrize("img", [56, 60])
def test_scratch_vision_transformer(img):
    """The scratch backbone through `ImageConditioner`: cls + 4 registers
    + patches; 60 is no multiple of 14, so the patch conv's "SAME" padding
    runs."""
    r = np.random.default_rng(4)
    x = r.uniform(size=(2, 3, img, img)).astype(np.float32)
    jm = jcond.ImageConditioner(width=W, depth=DEPTH, heads=HEADS,
                                img_size=img, backbone="scratch")
    p = randomize(jm, 5, jnp.asarray(x))
    ref = japply(jm, p, jnp.asarray(x))
    pm = carry(p, cond.ImageConditioner(width=W, depth=DEPTH, heads=HEADS,
                                        img_size=img, backbone="scratch"))
    with torch.no_grad():
        got = pm(t(x))
    close(got.crossattn, ref.crossattn, **COND_TOL)
    close(got.vector, ref.vector, **COND_TOL)
    assert pm.unconditional(1).crossattn.shape == \
        jm.unconditional(1).crossattn.shape


def _dit_inputs(seed, ch, cond_dim):
    r = np.random.default_rng(seed)
    return (r.normal(size=(2, 24, ch)).astype(np.float32),
            np.array([0.3, 0.8], np.float32),
            r.normal(size=(2, 9, cond_dim)).astype(np.float32),
            r.normal(size=(2, cond_dim)).astype(np.float32),
            r.uniform(-0.4, 0.4, size=(2, 24, 3)).astype(np.float32))


@pytest.mark.parametrize("stage", [1, 2])
def test_text_dit_release(stage):
    """The t23d layout: SA → CA over RMS-normalised context, 64-wide CA
    heads (width 128, 4 heads: d/heads = 32), `cap_embedder`."""
    ch = 3 if stage == 1 else 10
    x, tt, ctx, vec, xyz = _dit_inputs(stage, ch, 96)
    kw = dict(in_channels=ch, width=128, depth=DEPTH, heads=4, cond_dim=96,
              vector_dim=96, use_xyz_pe=stage == 2)
    jm = JPointDiT(release_parity=True, variant="text", **kw)
    extra = dict(xyz=jnp.asarray(xyz)) if stage == 2 else {}
    args = [jnp.asarray(a) for a in (x, tt, ctx, vec)]
    p = randomize(jm, 6 + stage, *args, **extra)
    ref = japply(jm, p, *args, **extra)
    pm = carry(p, PointDiT(variant="text", **kw))
    assert "cap_embedder.0.weight" in pm.state_dict()
    assert pm.blocks[0].cross_attn.to_q.weight.shape == (4 * 64, 128)
    with torch.no_grad():
        got = pm(t(x), t(tt), t(ctx), t(vec),
                 xyz=t(xyz) if stage == 2 else None)
    close(got, ref, **DIT_TOL)


def test_non_release_dit():
    """The JAX package's own presets' layout (`stage1_dit`): t·1000,
    `vector_proj`, `cond_proj`, biased cross-attention, the RMSNorm final
    layer with its own adaLN."""
    x, tt, ctx, vec, _ = _dit_inputs(9, 3, 48)
    kw = dict(depth=DEPTH, width=W, heads=HEADS, cond_dim=48, vector_dim=48)
    jm = jstage1_dit("S", **kw)
    args = [jnp.asarray(a) for a in (x, tt, ctx, vec)]
    p = randomize(jm, 10, *args)
    ref = japply(jm, p, *args)
    pm = carry(p, stage1_dit("S", **kw))
    with torch.no_grad():
        got = pm(t(x), t(tt), t(ctx), t(vec))
    close(got, ref, **DIT_TOL)

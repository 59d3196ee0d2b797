"""The OpenAI-CLIP ViT-L/14 text tower and the CLIP BPE tokenizer (port of
`gaussiananything_tpu/models/openclip_text.py`).

The reference's t23d conditioner is `FrozenOpenCLIPEmbedder2(arch=
'ViT-L-14', version='openai', layer='last', always_return_pooled=True,
legacy=False)` (`sgm/configs/stage1-t23d.yaml`; `sgm/modules/encoders/
modules.py:416-508`). The cross-attention tokens are the last residual
block's output BEFORE `ln_final`; the pooled vector is `ln_final` → the
end-of-text token's row (the argmax of the ids) → `text_projection`.

Parameter names are open_clip's (`token_embedding`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection`
applied as x @ W), so an open_clip text state dict loads as it is.

The tokenizer is CLIP's byte-level BPE (`open_clip/tokenizer.py`). Its
merges file (`bpe_simple_vocab_16e6.txt.gz`) is not in the repository:
`load_clip_tokenizer` takes a local path, and callers fall back to
`conditioner.tokenize_bytes` without one.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gaussiananything_tpu_torch.models.layers import (LayerNorm, Linear,
                                                      dot_attention)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """openai-CLIP QuickGELU: x·σ(1.702x)."""
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """torch `nn.MultiheadAttention`'s parameters: one packed in-projection
    ([q; k; v] on the output dim) and `out_proj`."""

    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(
            torch.randn(3 * width, width) / width ** 0.5)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, L, self.heads, D // self.heads)
                   for t in qkv.chunk(3, dim=-1))
        return self.out_proj(dot_attention(q, k, v, mask).reshape(B, L, D))


class ClipMlp(nn.Module):
    def __init__(self, width: int, quick: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = quick_gelu if quick else F.gelu
        self.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class ClipResBlock(nn.Module):
    """open_clip `ResidualAttentionBlock`: x + attn(ln_1(x)), then
    x + mlp(ln_2(x)); LayerNorm eps 1e-5."""

    def __init__(self, width: int, heads: int, quick_gelu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = ClipAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = ClipMlp(width, quick_gelu, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class ClipTransformer(nn.Module):
    def __init__(self, width: int, depth: int, heads: int,
                 quick_gelu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList([
            ClipResBlock(width, heads, quick_gelu, dtype=dtype)
            for _ in range(depth)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class OpenClipTextTower(nn.Module):
    """token ids (B, L) → (tokens (B, L, width) before `ln_final`,
    pooled (B, embed_dim))."""

    def __init__(self, vocab: int = 49408, width: int = 768, depth: int = 12,
                 heads: int = 12, max_len: int = 77, embed_dim: int = 768,
                 quick_gelu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(
            torch.randn(max_len, width) * 0.01)
        self.transformer = ClipTransformer(width, depth, heads, quick_gelu,
                                           dtype=dtype)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.randn(width, embed_dim) * 0.01)

    def forward(self, token_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L = token_ids.shape
        x = self.token_embedding(token_ids).to(self.dtype) \
            + self.positional_embedding[:L].to(self.dtype)
        # open_clip's additive causal mask
        causal = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        tokens = self.transformer(x, causal[None, None])
        h = self.ln_final(tokens)
        eot = token_ids.argmax(dim=-1)
        pooled = h[torch.arange(B, device=h.device), eot]
        return tokens, pooled @ self.text_projection.to(pooled.dtype)


# --------------------------------------------------------------------------
# CLIP byte-level BPE tokenizer (open_clip SimpleTokenizer semantics).
# --------------------------------------------------------------------------

@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode map (GPT-2/CLIP)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


# CLIP's pattern with \p{L}/\p{N} written for the standard library's `re`;
# its punctuation class [^\s\p{L}\p{N}]+ includes '_'
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE)


class ClipBPETokenizer:
    """CLIP BPE tokenizer from a local `bpe_simple_vocab_16e6.txt.gz`:
    256 byte symbols, 256 byte+'</w>' symbols, 48,894 merges,
    '<|startoftext|>', '<|endoftext|>' (49,408 ids)."""

    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.cache = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], max_len: int = 77) -> np.ndarray:
        """open_clip.tokenize: sot + ids + eot, cut to max_len keeping the
        eot last → (B, max_len) int32."""
        out = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > max_len:
                ids = ids[:max_len]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out


def load_clip_tokenizer(bpe_path: Optional[str]
                        ) -> Optional[ClipBPETokenizer]:
    """None without a path (use the byte tokenizer); raises when the path
    does not exist."""
    if bpe_path is None:
        return None
    if not os.path.exists(bpe_path):
        raise FileNotFoundError(
            f"CLIP BPE vocab not found at {bpe_path}; pass a local "
            "bpe_simple_vocab_16e6.txt.gz, or use the byte tokenizer")
    return ClipBPETokenizer(bpe_path)

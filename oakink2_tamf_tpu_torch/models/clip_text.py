"""Frozen CLIP ViT-B/32 text tower, tokenizer and per-prompt cache (port of
oakink2_tamf_tpu/models/clip_text.py).

- `ClipTokenizer`: the byte-BPE tokenizer when the merges file is available,
  else the same deterministic hash fallback (identical ids to the JAX
  package's). Framing: 20 tokens + SOT/EOT, zero-padded to 77.
- `ClipTextEncoder`: vocab 49408, ctx 77, width 512, 12 layers, 8 heads,
  causal mask, ln_final, text_projection, features at the EOT position.
  Parameter names are OpenAI CLIP's, so its checkpoint loads directly.
  LayerNorm eps is 1e-6, as in the JAX tower.
- `FrozenClipText`: tower + tokenizer + cache, with the JAX package's refuse
  rules: a missing explicit checkpoint raises, and pretrained weights refuse
  the hash tokenizer unless `allow_hash_tokenizer=True`.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import re
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .trunk import LN_EPS, SelfAttention

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
WIDTH = 512
HEADS = 8
LAYERS = 12
EMBED_DIM = 512
SOT = 49406
EOT = 49407
BPE_FILENAME = "bpe_simple_vocab_16e6.txt.gz"


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """CLIP byte-BPE tokenizer; without `bpe_path`, the deterministic
    word-hash fallback with the same id framing."""

    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )

    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = _bytes_to_unicode()
        self.bpe_ranks: dict[tuple[str, str], int] = {}
        self.encoder: dict[str, int] = {}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.has_bpe = False
        if bpe_path and os.path.isfile(bpe_path):
            from ..utils.integrity import verify_pinned

            verify_pinned(bpe_path, what="CLIP BPE merges")
            merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
            merge_pairs = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
            vocab = list(_bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merge_pairs]
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.bpe_ranks = dict(zip(merge_pairs, range(len(merge_pairs))))
            self.has_bpe = True

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if first not in word[i:]:
                    new_word.extend(word[i:])
                    break
                j = word.index(first, i)
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
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

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in self._PAT.findall(_clean(text).lower()):
            if self.has_bpe:
                tok = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
            else:
                h = 0
                for ch in token:
                    h = (h * 131 + ord(ch)) % (VOCAB_SIZE - 2 - 1)
                ids.append(1 + h)
        return ids

    def tokenize(self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int64)
        for i, text in enumerate(texts):
            tokens = [SOT] + self.encode(text) + [EOT]
            if len(tokens) > context_length:
                if not truncate:
                    raise RuntimeError(f"input too long for context {context_length}")
                tokens = tokens[: context_length - 1] + [EOT]
            result[i, : len(tokens)] = tokens
        return result


def tokenize_for_tamf(tokenizer: ClipTokenizer, texts: Sequence[str]) -> np.ndarray:
    """Context 22 (20 + SOT/EOT) with truncation, zero-padded to 77."""
    toks = tokenizer.tokenize(texts, context_length=22, truncate=True)
    return np.pad(toks, ((0, 0), (0, CONTEXT_LENGTH - 22)))


class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", _QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class ClipTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = VOCAB_SIZE, context_length: int = CONTEXT_LENGTH,
                 width: int = WIDTH, heads: int = HEADS, layers: int = LAYERS,
                 embed_dim: int = EMBED_DIM):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers)
        )
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) * width**-0.5)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.register_buffer(
            "causal", torch.ones(context_length, context_length).tril().bool(), persistent=False
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [bs, 77] int -> text features [bs, 512]."""
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        for blk in self.transformer.resblocks:
            x = blk(x, self.causal)
        x = self.ln_final(x)
        feats = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return feats @ self.text_projection


def find_bpe_path(explicit: str | None = None, near: str | None = None) -> str | None:
    """The BPE merges file: explicit path, $TAMF_CLIP_BPE, next to `near` (the
    checkpoint), or the repo's asset/clip/. An explicit path or env value that
    does not exist raises."""
    if explicit and not os.path.isfile(explicit):
        raise FileNotFoundError(f"clip bpe_path set but not found: {explicit}")
    env = os.environ.get("TAMF_CLIP_BPE")
    if env and not os.path.isfile(env):
        raise FileNotFoundError(f"$TAMF_CLIP_BPE set but not found: {env}")
    candidates = [explicit, env]
    if near:
        candidates.append(os.path.join(os.path.dirname(os.path.abspath(near)), BPE_FILENAME))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(repo, "asset", "clip", BPE_FILENAME))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


def load_openai_clip_text_state_dict(pt_path: str) -> dict[str, torch.Tensor]:
    """The text-tower entries of an OpenAI CLIP checkpoint (state_dict or jit
    archive), as float32; the key names already match ClipTextEncoder."""
    sd = torch.load(pt_path, map_location="cpu", weights_only=False)
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    keep = ("token_embedding.", "positional_embedding", "transformer.", "ln_final.", "text_projection")
    return {k: v.float() for k, v in sd.items() if k.startswith(keep)}


class FrozenClipText:
    """Frozen text encoder + tokenizer + per-prompt embedding cache."""

    def __init__(self, checkpoint_path: str | None = None, bpe_path: str | None = None,
                 seed: int = 0, allow_hash_tokenizer: bool = False, device="cuda"):
        self.device = torch.device(device)
        self.tokenizer = ClipTokenizer(find_bpe_path(bpe_path, near=checkpoint_path))
        if checkpoint_path and not os.path.isfile(checkpoint_path):
            raise FileNotFoundError(
                f"clip checkpoint_path was set but does not exist: {checkpoint_path!r}"
            )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = ClipTextEncoder()
        if checkpoint_path:
            if not self.tokenizer.has_bpe and not allow_hash_tokenizer:
                raise RuntimeError(
                    "FrozenClipText: pretrained CLIP weights require the real BPE merges "
                    f"file ({BPE_FILENAME}); the hash-fallback tokenizer would give wrong "
                    "token ids. Provide bpe_path / $TAMF_CLIP_BPE, place the file next to "
                    "the checkpoint, or pass allow_hash_tokenizer=True (tests only)."
                )
            from ..utils.integrity import verify_pinned

            verify_pinned(checkpoint_path, what="CLIP checkpoint")
            self.model.load_state_dict(load_openai_clip_text_state_dict(checkpoint_path))
            self.pretrained = True
        else:
            self.pretrained = False
            if not self.tokenizer.has_bpe:
                logging.getLogger(__name__).warning(
                    "CLIP BPE merges not found: using the deterministic hash tokenizer "
                    "(fine for random-init smoke runs, NOT for parity)"
                )
        self.model.to(self.device).eval().requires_grad_(False)
        self._cache: dict[str, torch.Tensor] = {}

    @torch.inference_mode()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        """[n] strings -> [n, 512] float32 on the device, cached per prompt."""
        missing = [t for t in dict.fromkeys(texts) if t not in self._cache]
        if missing:
            toks = torch.from_numpy(tokenize_for_tamf(self.tokenizer, missing)).to(self.device)
            for t, f in zip(missing, self.model(toks)):
                self._cache[t] = f
        return torch.stack([self._cache[t] for t in texts], dim=0)
